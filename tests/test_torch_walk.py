"""The port's continuation walk (``airfoil_tpu_torch.polar.sweep``) against
the JAX reference's, on the CPU.

Every scenario of ``tests/test_walk.py`` runs through both packages'
``_walk`` with the same stubbed continuation solver (a module global on
each side): the accepted values (``m_walk``) and ``used`` must be equal.
The audits (``_trend_ok``, ``_deficit_ok``, ``_deficit``, ``_shift_hist``)
are held to JAX's on histories made from a seed with numpy (values to
1e-6, verdicts equal), and ``_walk_kernel`` on a padded bucket, whose
repeated last alpha makes the sort's stability part of the answer, must
reorder and merge as JAX's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airfoil_tpu.polar.sweep as JS
import airfoil_tpu_torch.polar.sweep as TS

SEED = 20261017


def _to_jax(x):
    return jnp.asarray(np.asarray(x))


def _to_torch(x):
    return torch.as_tensor(np.asarray(x))


def _fake_cont(pkg, cont_behaviour, trip_behaviour, calls):
    """A stub of ``solve_polar_point_cont`` for one package: the free
    continuation answers ``cont_behaviour(a, zz)``, the tripped one (its
    ``x_forced_transition`` keyword) ``trip_behaviour`` when given; the new
    state is the donor's plus one."""
    zero = (lambda: jnp.zeros(())) if pkg == "jax" else (
        lambda: torch.zeros(()))

    def fake(op, a, re_, zz, xu, xl, n_stations=None,
             x_forced_transition=None, x_forced_transition_lower=None,
             cont_slack_add=None, cont_slack_mul=None,
             cont_slack_add_l=None, cont_slack_mul_l=None):
        fn = cont_behaviour
        if x_forced_transition is not None and trip_behaviour is not None:
            fn = trip_behaviour
        calls.append(x_forced_transition is not None)
        clc, cdc, nokc = fn(pkg, a, zz)
        merged = (clc, cdc, zero(), zero(), nokc, zero(), zero(), zero())
        return merged, (nokc, (zz + 1.0, xu, xl))
    return fake


def _inputs(p, nok_mask, cl=None, cli=None):
    """``tests/test_walk.py``'s walk inputs as numpy."""
    alphas = np.arange(p, dtype=np.float32)
    cl = (0.1 * alphas if cl is None else np.asarray(cl, np.float32))
    cli = (0.12 * alphas + 0.05 if cli is None
           else np.asarray(cli, np.float32))
    cd = np.full((p,), 0.007, np.float32)
    zeros = np.zeros((p,), np.float32)
    nok = np.asarray(nok_mask)
    m1 = (cl.astype(np.float32), cd, zeros, zeros, nok, zeros, zeros, zeros)
    st1 = (np.tile(np.arange(p, dtype=np.float32)[:, None], (1, 4)), zeros,
           zeros)
    slack = (np.full((p,), 0.005, np.float32), zeros,
             np.full((p,), 0.15, np.float32), np.full((p,), 0.5, np.float32))
    return dict(a=alphas, re=np.full((p,), 1e6, np.float32),
                active=np.ones((p,), bool), seg=np.zeros((p,), bool),
                cli=cli.astype(np.float32), slack=slack, m1=m1, nok=nok,
                st1=st1)


def _run(monkeypatch, pkg, x, cont, trip=None):
    mod, conv = (JS, _to_jax) if pkg == "jax" else (TS, _to_torch)
    calls = []
    monkeypatch.setattr(mod, "solve_polar_point_cont",
                        _fake_cont(pkg, cont, trip, calls))
    st1 = tuple(conv(s) for s in x["st1"])
    m_walk, used = mod._walk(
        None, conv(x["a"]), conv(x["re"]), conv(x["active"]),
        conv(x["seg"]), conv(x["cli"]), tuple(conv(s) for s in x["slack"]),
        tuple(conv(m) for m in x["m1"]), conv(x["nok"]), st1,
        tuple(s[0] for s in st1))
    return [np.asarray(m) for m in m_walk], np.asarray(used), calls


def _const(pkg, v, dtype=None):
    if pkg == "jax":
        return jnp.asarray(v, dtype)
    return torch.tensor(v, dtype=dtype or (torch.bool if isinstance(v, bool)
                                           else torch.float32))


def cont_ok(pkg, a, zz):
    return _const(pkg, -99.0), _const(pkg, 0.5), _const(pkg, True)


def cont_line(pkg, a, zz):
    return 0.1 * a, _const(pkg, 0.007), _const(pkg, True)


def cont_garbage(pkg, a, zz):
    return _const(pkg, 5.0), _const(pkg, 0.0001), _const(pkg, True)


def cont_dead(pkg, a, zz):
    return _const(pkg, 0.0), _const(pkg, 0.0), _const(pkg, False)


# (name, p, nok mask, per-point CL, free continuation, tripped one)
SCENARIOS = [
    ("clean_polar_adopts_everything", 6, [True] * 6, None, cont_ok, None),
    ("failed_point_repaired_by_continuation", 6,
     [True, True, True, False, True, True], None, cont_line, None),
    ("off_trend_cont_result_not_adopted", 6,
     [True, True, True, False, True, True], None, cont_garbage, None),
    ("deficit_audit_rejects_relieved_per_point", 6, [True] * 6,
     [0.00, 0.14, 0.28, 0.42, 0.56, 0.70], cont_dead, None),
    ("reanchor_after_two_failures", 6, [True] * 6,
     [0.0, 0.1, -0.4, -0.35, -0.3, -0.25], cont_dead, None),
    ("reanchor_refused_for_relieved_jump", 6, [True] * 6,
     [0.0, 0.1, 0.35, 0.47, 0.59, 0.71], cont_dead, None),
    ("trip_rescue_repairs_when_free_cont_fails", 6,
     [True, True, True, False, True, True], None, cont_dead, cont_line),
    ("trip_rescue_result_still_audited", 6,
     [True, True, True, False, True, True], None, cont_dead, cont_garbage),
    ("engaged_regime_prefers_the_chain", 8, [True] * 8,
     [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7], cont_line, None),
]


@pytest.mark.parametrize("name,p,nok,cl,cont,trip", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_walk_equals_jax(monkeypatch, name, p, nok, cl, cont, trip):
    cli = (0.2 * np.arange(p) + 0.05 if name.startswith("engaged")
           else None)
    x = _inputs(p, nok, cl, cli)
    want_m, want_used, _ = _run(monkeypatch, "jax", x, cont, trip)
    got_m, got_used, calls = _run(monkeypatch, "torch", x, cont, trip)
    np.testing.assert_array_equal(got_used, want_used)
    for got, want in zip(got_m, want_m):
        np.testing.assert_array_equal(got, want)
    if name == "clean_polar_adopts_everything":
        assert want_used.all()
    if name == "engaged_regime_prefers_the_chain":
        assert calls and not any(calls)          # free solves only


def _hists(rng, n):
    """Seeded histories (n_acc, a1, cl1, cd1, a2, cl2, cd2, cli1, d1) and
    queries (a, cl, cd, cli, d) over the ranges the walk meets."""
    f = np.float32
    return [dict(
        hist=(np.int32(rng.integers(0, 3)), f(rng.uniform(-10, 20)),
              f(rng.uniform(-1, 2)), f(rng.uniform(0.004, 0.05)),
              f(rng.uniform(-10, 20)), f(rng.uniform(-1, 2)),
              f(rng.uniform(0.004, 0.05)), f(rng.uniform(-1.5, 2.5)),
              f(rng.uniform(-0.1, 0.6))),
        a=f(rng.uniform(-10, 20)), cl=f(rng.uniform(-1, 2)),
        cd=f(rng.uniform(0.0, 0.06)), cli=f(rng.uniform(-1.5, 2.5)),
        d=f(rng.uniform(-0.1, 0.6))) for _ in range(n)]


def test_audits_equal_jax_on_seeded_histories():
    rng = np.random.default_rng(SEED)
    cases = _hists(rng, 400)
    # Near-equal alphas exercise the slope guard, a1 == a2 exactly.
    for c in cases[:40]:
        h = list(c["hist"])
        h[4] = h[1]
        c["hist"] = tuple(h)
    for c in cases:
        jh = tuple(jnp.asarray(v) for v in c["hist"])
        th = tuple(torch.as_tensor(v) for v in c["hist"])
        for fn, args in (("_trend_ok", ("a", "cl", "cd")),
                         ("_deficit_ok", ("d", "cli"))):
            want = bool(getattr(JS, fn)(*(jnp.asarray(c[k]) for k in args),
                                        jh))
            got = bool(getattr(TS, fn)(*(torch.as_tensor(c[k])
                                         for k in args), th))
            assert got == want, (fn, c)
        want = float(JS._deficit(jnp.asarray(c["cli"]), jnp.asarray(c["cl"])))
        got = float(TS._deficit(torch.as_tensor(c["cli"]),
                                torch.as_tensor(c["cl"])))
        assert got == pytest.approx(want, abs=1e-6)
        q = ("a", "cl", "cd", "cli", "d")
        want = JS._shift_hist(jh, *(jnp.asarray(c[k]) for k in q))
        got = TS._shift_hist(th, *(torch.as_tensor(c[k]) for k in q))
        assert got[0].dtype == torch.int32
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], atol=1e-6)


class _Inviscid:
    """A scripted inviscid fill: CL 0.1/deg + 0.03 (a deficit below the
    chain-preference threshold, so per-point results are adopted), Cm
    -0.05."""

    def __init__(self, alphas):
        self.cl = 0.1 * alphas + 0.03
        self.cm = 0.0 * alphas - 0.05


def test_padded_bucket_walk_kernel(monkeypatch):
    """A bucket padded with copies of its last alpha (8 lanes for 5
    points), per-point results that differ between the copies: the sorts
    must be stable for the port to reorder, walk and merge as JAX does."""
    a = np.array([3.0, -1.0, 0.0, 1.0, 2.0, 2.0, 2.0, 2.0], np.float32)
    p = len(a)
    cl = 0.1 * a + np.array([0, 0, 0, 0, 0, 0.003, 0.006, 0.009], np.float32)
    nok = np.array([True, True, True, True, True, False, True, False])
    zeros = np.zeros(p, np.float32)
    m1 = (cl, np.full(p, 0.007, np.float32), zeros, zeros, nok,
          np.linspace(0.2, 0.3, p, dtype=np.float32), zeros, zeros)
    st1 = (np.tile(np.arange(p, dtype=np.float32)[:, None], (1, 4)),
           np.linspace(0.1, 0.5, p, dtype=np.float32), zeros + 0.9)
    out = {}
    # The port's walk fills through its program ``inviscid_program``.
    fills = {"jax": "solve_inviscid", "torch": "inviscid_program"}
    for pkg, mod, conv in (("jax", JS, _to_jax), ("torch", TS, _to_torch)):
        calls = []
        monkeypatch.setattr(mod, "solve_polar_point_cont",
                            _fake_cont(pkg, cont_line, None, calls))
        monkeypatch.setattr(mod, fills[pkg], lambda op, al: _Inviscid(al))
        kernel = mod._walk_kernel.__wrapped__ if pkg == "jax" \
            else mod._walk_kernel
        v1, cl3, cm3 = kernel(None, conv(a), conv(np.full(p, 1e6,
                                                          np.float32)),
                              tuple(conv(m) for m in m1), conv(nok),
                              tuple(conv(s) for s in st1))
        out[pkg] = ([np.asarray(v) for v in v1], np.asarray(cl3))
    for got, want in zip(out["torch"][0], out["jax"][0]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-6)
    # The duplicates keep their own per-point answers (x_tr upper tells
    # the lanes apart).
    assert len(set(out["torch"][0][5][4:].tolist())) > 1
