"""The port's polar pipeline (``airfoil_tpu_torch.polar.sweep``) and its
service handlers against the JAX reference's, on the CPU, with the solver
stages scripted (the real ones take minutes a polar on a CPU; the goldens
and ``chip_smoke.py`` hold them on the GPU).

- ``_bucket_size`` and ``_pad_coords`` equal the reference's, the padded
  loop repanels to the unpadded one's nodes exactly, and to the
  reference's to 1e-6;
- ``solve_polar`` with the per-point pass, the walk and the rescue
  scripted the same way in both packages (the per-point states carried
  across by ``state_from_numpy``): the sort, the ascent/descent merge,
  the failed-point bucket and the three-strategy selection give the same
  answer, point for point (the inviscid fill to 1e-5, everything else
  equal);
- ``handle_polar``, ``handle_batch`` and ``handle_stats``: the same JSON
  (keys, rounding, error rows) and the same 400 answers as the
  reference's handlers, and the port's counter grows by the analyses;
- ``chip_smoke.py``'s served .dat parses back to the library's loop, its
  polar hold takes the members of the point's mode and holds a record
  jointly to one of them, and its hold of the lanes at the reference's
  own states keeps to its bars and verdicts.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airfoil_tpu.polar as jax_polar
import airfoil_tpu.polar.batch as jax_batch
import airfoil_tpu.polar.sweep as JS
import airfoil_tpu_torch.polar as port_polar
import airfoil_tpu_torch.polar.sweep as TS
from airfoil_tpu.api import handlers as jax_handlers
from airfoil_tpu.models import naca4
from airfoil_tpu.paneling import repanel as jax_repanel
from airfoil_tpu_torch.api import handlers as port_handlers
from airfoil_tpu_torch.paneling import repanel
from airfoil_tpu_torch.utils import stats as port_stats
from airfoil_tpu_torch.viscous.newton import state_from_numpy

N3 = 8      # scripted state width


def test_bucket_size_equals_jax():
    for p in range(1, 300):
        assert TS._bucket_size(p) == JS._bucket_size(p), p


@pytest.mark.parametrize("n", [40, 61, 100, 130, 240])
def test_pad_coords_through_repanel(n):
    c = np.asarray(naca4(2, 4, 12, n), np.float32)
    got = TS._pad_coords(torch.as_tensor(c))
    want = JS._pad_coords(jnp.asarray(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[0] in (128, 192, 256) or got.shape[0] % 64 == 0
    xp, yp = repanel(got, 160)
    xq, yq = repanel(torch.as_tensor(c), 160)
    assert torch.equal(xp, xq) and torch.equal(yp, yq)
    jx, jy = jax_repanel(want, 160)
    np.testing.assert_allclose(xp.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(yp.numpy(), np.asarray(jy), atol=1e-6)


def _points_numpy(alphas):
    """Scripted per-point pass: a clean line, unconverged at alpha % 3 == 0
    (x_tr upper tells the lanes apart)."""
    a = np.asarray(alphas, np.float32)
    p = len(a)
    ok = (np.round(a) % 3 != 0)
    m1 = (0.1 * a + 0.2, 0.006 + 1e-4 * a * a, 0.002 + 0 * a, -0.05 + 0 * a,
          ok, np.linspace(0.1, 0.9, p, dtype=np.float32), 0.8 + 0 * a,
          0.01 + 0 * a)
    st1 = (np.tile(a[:, None], (1, N3)), m1[5], m1[6])
    return tuple(np.asarray(x, np.float32) if x.dtype != bool else x
                 for x in m1), ok, tuple(np.asarray(x, np.float32)
                                         for x in st1)


def _scripted(pkg):
    """The points, walk and rescue stages of one package, scripted."""
    conv = jnp.asarray if pkg == "jax" else torch.as_tensor

    def points(op, alphas, reynolds):
        m1, ok, st1 = _points_numpy(np.asarray(alphas))
        if pkg == "torch":
            st1 = state_from_numpy(*st1, device="cpu")
        else:
            st1 = tuple(conv(s) for s in st1)
        return tuple(conv(m) for m in m1), (conv(ok), st1)

    def walk(op, a_seq, re_seq, active, seg_start, cli_seq, slack_seq,
             m1_seq, nok1_seq, st1_seq, state_like):
        # Accept the per-point result below alpha 4 where active, shifted
        # by the step's slack and inviscid CL (so the sequences matter).
        used = nok1_seq & active & (a_seq < 4.0)
        m = (m1_seq[0] + 0.001 * slack_seq[1] + 1e-3 * cli_seq,) \
            + tuple(m1_seq[1:4]) + (m1_seq[4] & used,) + tuple(m1_seq[5:])
        return m, used

    def rescue(op_s, a_b, re_b):
        ok = a_b < 12.0
        return (0.09 * a_b, 0.01 + 0 * a_b, 0.004 + 0 * a_b, -0.04 + 0 * a_b,
                ok, 0.3 + 0 * a_b, 0.7 + 0 * a_b, 0.02 + 0 * a_b)
    return points, walk, rescue


def test_solve_polar_selection_equals_jax(monkeypatch):
    """20 alphas (a bucket of 32): failures beyond the rescue bucket's 8
    fall to the inviscid fill, the rescue converges some and not others."""
    coords = np.asarray(naca4(2, 4, 12, 80), np.float32)
    alphas = np.arange(-4.0, 16.0, 1.0, dtype=np.float32)
    out = {}
    for pkg, mod in (("jax", JS), ("torch", TS)):
        points, walk, rescue = _scripted(pkg)
        monkeypatch.setattr(mod, "_points_kernel", points)
        monkeypatch.setattr(mod, "_walk", walk)
        monkeypatch.setattr(mod, "_rescue_kernel", rescue)
        if pkg == "jax":
            monkeypatch.setattr(mod, "_walk_kernel",
                                mod._walk_kernel.__wrapped__)
            res = mod.solve_polar(coords, alphas, 1e6)
        else:
            res = mod.solve_polar(coords, alphas, 1e6, device="cpu")
        out[pkg] = {f: np.asarray(getattr(res, f)) for f in res._fields}
    got, want = out["torch"], out["jax"]
    assert got["mode"].tolist() == want["mode"].tolist()
    assert set(want["mode"].tolist()) == {0, 1, 2}
    for f in want:
        assert got[f].shape == want[f].shape == alphas.shape, f
        if f in ("cl", "cm"):
            np.testing.assert_allclose(got[f], want[f], atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _polar_result(cls, alphas, re):
    a = np.asarray(alphas, np.float32)
    p = len(a)
    return cls(a, np.full(p, re, np.float32), 0.1234567 * a + 0.2,
               0.0061234567 + 1e-4 * a, 0.0021234567 + 0 * a,
               -0.051234567 + 0 * a, np.arange(p) % 3,
               np.ones(p, bool), np.linspace(0.12345, 0.9, p),
               0.812345 + 0 * a, 0.0112345 + 0 * a)


def _batch_result(cls, n):
    i = np.arange(n, dtype=np.float32)
    return cls(0.51234567 + i, 0.0071234567 + i * 1e-3, 0.0021234 + 0 * i,
               -0.0512345 + 0 * i, i % 2 == 0, 0.312345 + 0 * i,
               0.712345 + 0 * i, 0.01 + 0 * i)


@pytest.fixture
def scripted_solvers(monkeypatch, tmp_path):
    """Both packages' ``solve_polar`` and ``solve_batch`` answering
    scripted results; the port's counter in a fresh file. Yields the
    port's solver calls."""
    calls = []

    def port_polar_stub(coords, alphas, reynolds, device=None):
        calls.append(("polar", len(alphas), device))
        return _polar_result(port_polar.PolarResult, alphas, reynolds)

    def port_batch_stub(coords_list, reynolds, alpha, device=None):
        calls.append(("batch", len(coords_list), device))
        return _batch_result(port_polar.BatchResult, len(coords_list))

    monkeypatch.setattr(port_polar, "solve_polar", port_polar_stub)
    monkeypatch.setattr(port_polar, "solve_batch", port_batch_stub)
    monkeypatch.setattr(jax_polar, "solve_polar",
                        lambda c, a, r: _polar_result(JS.PolarResult, a, r))
    monkeypatch.setattr(jax_batch, "solve_batch",
                        lambda cs, r, a: _batch_result(jax_batch.BatchResult,
                                                       len(cs)))
    monkeypatch.setattr(port_stats, "_SQLITE_PATH", str(tmp_path / "s.db"))
    monkeypatch.delenv("DATABASE_URL", raising=False)
    monkeypatch.setattr(jax_handlers, "increment_analysis_count", lambda: 1)
    yield calls


def _dat(n=60, m=2, p=4, t=12):
    return ("NACA\n" + "\n".join(f" {x:.6f} {y:.6f}"
                                 for x, y in naca4(m, p, t, n))).encode()


def _same_reply(got, want):
    got, want = dict(got), json.loads(json.dumps(want))
    assert got.pop("elapsed_seconds") >= 0.0
    want.pop("elapsed_seconds")
    assert json.loads(json.dumps(got)) == want


def test_handle_polar_equals_jax(scripted_solvers):
    status, got = port_handlers.handle_polar("a.dat", _dat(), 1e6, -2.0,
                                             6.0, 0.5, device="cpu")
    want_status, want = jax_handlers.handle_polar("a.dat", _dat(), 1e6, -2.0,
                                                  6.0, 0.5)
    assert status == want_status == 200
    _same_reply(got, want)
    assert len(got["polar"]) == 17
    assert {p["mode"] for p in got["polar"]} == {
        "viscous", "viscous_smoothed", "inviscid"}
    assert scripted_solvers == [("polar", 17, "cpu")]
    assert port_stats.get_analysis_count() == 1


def test_handle_batch_equals_jax(scripted_solvers):
    files = [("a.dat", _dat()), ("b.dat", _dat(50, 0, 0, 12)),
             ("c.txt", _dat()), ("d.dat", b"not an airfoil")]
    status, got = port_handlers.handle_batch(files, 1e6, 2.0, device="cpu")
    want_status, want = jax_handlers.handle_batch(files, 1e6, 2.0)
    assert status == want_status == 200
    _same_reply(got, want)
    assert [r.get("error") is None for r in got["results"]] == \
        [True, True, False, False]
    assert scripted_solvers == [("batch", 2, "cpu")]
    assert port_stats.get_analysis_count() == 2


@pytest.mark.parametrize("args", [
    ("a.dat", 1e6, -2.0, 6.0, 0.05),      # step too small
    ("a.dat", 1e6, -2.0, 6.0, 6.0),       # step too large
    ("a.dat", 1e6, -10.0, 20.0, 0.2),     # 151 points
    ("a.dat", 1e6, -12.0, 6.0, 1.0),      # alpha outside the envelope
    ("a.dat", 1e3, -2.0, 6.0, 1.0),       # Reynolds outside it
    ("a.txt", 1e6, -2.0, 6.0, 1.0),       # not a .dat file
])
def test_handle_polar_400s_equal_jax(scripted_solvers, args):
    name, re_, a0, a1, step = args
    errs = []
    for fn, kw in ((port_handlers.handle_polar, {"device": "cpu"}),
                   (jax_handlers.handle_polar, {})):
        with pytest.raises(Exception) as err:
            fn(name, _dat(), re_, a0, a1, step, **kw)
        errs.append((err.value.status_code, err.value.detail))
    assert errs[0] == errs[1] and errs[0][0] == 400
    assert scripted_solvers == []


@pytest.mark.parametrize("n_files,alpha", [(0, 2.0), (11, 2.0), (2, 25.0)])
def test_handle_batch_400s_equal_jax(scripted_solvers, n_files, alpha):
    files = [(f"f{i}.dat", _dat()) for i in range(n_files)]
    errs = []
    for fn, kw in ((port_handlers.handle_batch, {"device": "cpu"}),
                   (jax_handlers.handle_batch, {})):
        with pytest.raises(Exception) as err:
            fn(files, 1e6, alpha, **kw)
        errs.append((err.value.status_code, err.value.detail))
    assert errs[0] == errs[1] and errs[0][0] == 400


def test_handle_stats_equals_jax(tmp_path, monkeypatch):
    from airfoil_tpu.utils import stats as jax_stats

    monkeypatch.delenv("DATABASE_URL", raising=False)
    monkeypatch.setattr(port_stats, "_SQLITE_PATH", str(tmp_path / "p.db"))
    monkeypatch.setattr(jax_stats, "_SQLITE_PATH", str(tmp_path / "j.db"))
    for mod in (port_stats, jax_stats):
        mod.init_db()
        for _ in range(3):
            mod.increment_analysis_count()
    assert port_handlers.handle_stats() == jax_handlers.handle_stats() \
        == (200, {"total_analyses": 3})


def test_served_dat_parses_back_to_the_loop():
    """``chip_smoke.py``'s served polar is held to the library's answer on
    the same loop: its .dat must parse back to the same float32 values."""
    from chip_smoke import naca4_coords, precise_dat

    for spec in ((2, 4, 12, 80), (0, 0, 12, 70)):
        coords = np.asarray(naca4_coords(*spec), np.float32)
        parsed, _fixes = port_handlers.parse_upload(
            "a.dat", precise_dat("NACA", coords).encode())
        np.testing.assert_array_equal(np.asarray(parsed, np.float32), coords)


_MEMBER = {"cl": 0.5, "cd": 0.006, "cm": -0.05, "xtr_upper": 0.4,
           "xtr_lower": 0.9, "converged": True}


def test_held_to_polar_takes_the_members_of_its_mode():
    from chip_smoke import held_to_polar

    member = _MEMBER
    golden = {"members": [dict(member, mode=0),
                          dict(member, mode=1, cl=0.9, cd=0.02)],
              "ensemble": {"mode": [0, 1], "converged": [True]}}
    assert held_to_polar(dict(member, mode=0, cl=0.52), golden)[0] == []
    assert held_to_polar(dict(member, mode=0, cl=0.9), golden)[0]
    assert held_to_polar(dict(member, mode=1, cl=0.9, cd=0.02),
                         golden)[0] == []
    assert "'mode': 2" in held_to_polar(dict(member, mode=2), golden)[0][0]


def test_held_to_polar_holds_jointly_to_one_member():
    """Each field within the members' range is not enough: the record must
    lie within the bars of one member on every field at once, or else on
    every field but CD (a knife edge, which the note names)."""
    from chip_smoke import held_to_polar

    golden = {"members": [dict(_MEMBER),
                          dict(_MEMBER, cl=0.6, cd=0.008, xtr_upper=0.2),
                          dict(_MEMBER, converged=False, cd=0.007)]}
    fails, note = held_to_polar(dict(_MEMBER, cd=0.0061), golden)
    assert fails == [] and note.startswith("nearest member 0 at 0.33")
    # Member 0 but for CD, which lies out of every member's bar.
    fails, note = held_to_polar(dict(_MEMBER, cd=0.0072), golden)
    assert fails == [] and "knife edge" in note and "members [0]" in note
    # CL of member 1, CD and transitions of member 0.
    fails, _ = held_to_polar(dict(_MEMBER, cl=0.6), golden)
    assert "in no member's basin" in fails[0]
    # Member 1's CL and CD with member 0's upper transition: between both.
    fails, _ = held_to_polar(dict(_MEMBER, cl=0.6, cd=0.008, xtr_upper=0.3),
                             golden)
    assert "in no member's basin" in fails[0]
    # The unconverged member is no candidate for a converged record.
    fails, _ = held_to_polar(dict(_MEMBER, cd=0.007, xtr_upper=0.3), golden)
    assert fails


class _ScriptedNewton:
    """Stands in for the port's newton module: the lanes' answer at the
    given state is the scripted one."""

    def __init__(self, lanes):
        self.lanes = lanes
        self.init_state = None

    @staticmethod
    def state_from_numpy(zz, xtr_u, xtr_l, device=None):
        return tuple(torch.as_tensor(np.asarray(a, np.float32))
                     for a in (zz, xtr_u, xtr_l))

    def _prepare(self, op, alphas, reynolds, *args, init_state=None):
        self.init_state = init_state
        system = type("System", (), {"residual": staticmethod(
            lambda zz: zz)})
        return system, None, None, init_state[0]

    @staticmethod
    def _rms(r):
        return r.abs().mean(-1)

    def _lane_answer(self, system, sc, warm_state, zz, rms):
        return (self.lanes,)

    @staticmethod
    def _points_out(lanes):
        names = ("cl", "cd", "cdp", "cm", "converged", "xtr_upper",
                 "xtr_lower", "sep_fraction")
        merged = tuple(torch.tensor([ln[f] for ln in lanes]) for f in names)
        nok = torch.tensor([ln["newton_converged"] for ln in lanes])
        return merged, (nok, None)


def _pass_lane(**kw):
    rec = dict(_MEMBER, cdp=0.002, sep_fraction=0.0, alpha=2.0,
               newton_converged=True)
    rec.update(kw)
    return rec


@pytest.mark.parametrize("got, fails", [
    ([_pass_lane(cl=0.50005), _pass_lane(converged=False,
                                         newton_converged=False, cl=0.1)],
     False),
    ([_pass_lane(cd=0.006001), _pass_lane(converged=False,
                                          newton_converged=False)], True),
    ([_pass_lane(xtr_upper=0.4002), _pass_lane(converged=False,
                                               newton_converged=False)],
     True),
    ([_pass_lane(), _pass_lane(newton_converged=False)], True),
])
def test_held_from_states(got, fails):
    """A lane's answer at the reference's state must be the reference's
    within ``STATE_BARS``, with its verdicts; a lane the reference did not
    solve is held by its verdicts only. The system is set up at the
    reference's states."""
    import chip_smoke

    want = [_pass_lane(), _pass_lane(converged=False,
                                     newton_converged=False)]
    for i, w in enumerate(want):
        w["state"] = {"zz": [float(i)] * 3, "xtr_u": 0.4, "xtr_l": 0.9}
    fake = _ScriptedNewton(got)
    if fails:
        with pytest.raises(RuntimeError, match="check failed"):
            chip_smoke.held_from_states(fake, None, want, 1e6,
                                        torch.device("cpu"), "scripted")
    else:
        assert chip_smoke.held_from_states(
            fake, None, want, 1e6, torch.device("cpu"), "scripted") <= 1.0
    assert fake.init_state[0].tolist() == [[0.0] * 3, [1.0] * 3]
