"""The port's boundary-layer closures and march
(``airfoil_tpu_torch.viscous.closures``, ``.march``, ``.kernel``) against
the JAX reference on the CPU.

The CUDA march kernel cannot run here: on a CPU tensor its wrapper runs
the plain torch march, and ``chip_smoke.py`` holds the kernel to that
march on the card. The plain march is launch-bound (a few thousand small
torch ops per Newton iteration), so the marches below run their cases as
lanes of one call: the flat-plate cases and the Falkner-Skan cases each
in one. The airfoil-side marches are in ``test_torch_coupled.py``.

Tolerances:
- closures rtol 1e-6, with atol 1e-6 of the function's largest magnitude
  on the grid (several cross zero, e.g. the laminar Cf near separation);
- the Newton Jacobian (forward mode on ``numerics.Dual``) equals
  ``torch.func.jacfwd`` of the same residual to rtol 1e-6 and JAX's
  ``jacfwd`` to rtol 1e-5 with atol 1e-6 of the largest entry;
- marches: theta, dstar, hk and cf rtol 1e-4; amp and ctau rtol 1e-4 with
  atol 1e-5 (amp starts at 0); turb and separated flags and x_transition
  identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.viscous import closures as jcl
from airfoil_tpu.viscous import march as jmarch
from airfoil_tpu_torch.viscous import closures as cl
from airfoil_tpu_torch.viscous import kernel, march
from torch_parity import as_numpy, compare

MARCH_FIELDS = ["theta", "dstar", "hk", "cf"]


# ── closures ────────────────────────────────────────────────────────────────
def _grid():
    """(Hk, Re_theta, ctau) crossing every clip edge and branch switch: Hk
    at 1.0/1.02/1.05 (clips), 2.1 and 2.55-5.2 (amplification clip and
    H-modulation knots), 4.0 (laminar branches), 7.4 (laminar Cf), 12 and
    13 (upper clip); Re_theta at 0.5/1 (clip), 50 and 400 (turbulent
    clips) up to 1e6, so the turbulent H* switch at h0 = 3 + 400/Re_theta
    is crossed from both sides."""
    hk = np.array([1.0, 1.02, 1.03, 1.05, 1.3, 1.6, 2.1, 2.3, 2.55, 2.59,
                   2.9, 3.2, 3.5, 3.6, 3.99, 4.0, 4.01, 4.2, 4.6, 5.2, 5.5,
                   5.8, 7.0, 7.4, 7.5, 9.0, 12.0, 13.0])
    ret = np.array([0.5, 1.0, 10.0, 50.0, 100.0, 200.0, 399.0, 400.0,
                    1e3, 1e4, 1e5, 1e6])
    h, r = np.meshgrid(hk, ret, indexing="ij")
    h, r = h.ravel(), r.ravel()
    ctau = np.resize([-0.01, 0.0, 1e-4, 0.03, 0.3, 0.5], h.shape)
    return (h.astype(np.float32), r.astype(np.float32),
            ctau.astype(np.float32))


CLOSURES = {
    "lam_hstar": lambda m, h, r, c: m.lam_hstar(h),
    "lam_cf": lambda m, h, r, c: m.lam_cf(h, r),
    "lam_diss": lambda m, h, r, c: m.lam_diss(h, r, m.lam_hstar(h)),
    "log10_ret_crit": lambda m, h, r, c: m.log10_ret_crit(h),
    "amplification_rate": lambda m, h, r, c: m.amplification_rate(
        h, r * 1e-6, r),
    "_amp_h_mod": lambda m, h, r, c: m._amp_h_mod(h),
    "_sep_boost": lambda m, h, r, c: m._sep_boost(h),
    "turb_hstar": lambda m, h, r, c: m.turb_hstar(h, r),
    "turb_cf": lambda m, h, r, c: m.turb_cf(h, r),
    "turb_us": lambda m, h, r, c: m.turb_us(h, m.turb_hstar(h, r)),
    "turb_cteq": lambda m, h, r, c: m.turb_cteq(h, r, m.turb_hstar(h, r)),
    "turb_diss": lambda m, h, r, c: m.turb_diss(h, r, c, m.turb_hstar(h, r)),
    "delta_thickness": lambda m, h, r, c: m.delta_thickness(
        r * 1e-6, h * r * 1e-6, h),
}


@pytest.mark.parametrize("name", list(CLOSURES))
def test_closure(name):
    h, r, c = _grid()
    ref = CLOSURES[name](jcl, jnp.asarray(h), jnp.asarray(r), jnp.asarray(c))
    port = CLOSURES[name](cl, torch.tensor(h), torch.tensor(r),
                          torch.tensor(c))
    compare(port, ref, rtol=1e-6, atol_scale=1e-6, name=name)


def test_closure_constants():
    assert cl.HK_LAM_MAX == jcl.HK_LAM_MAX
    assert cl.HK_TURB_MAX == jcl.HK_TURB_MAX


# ── Newton Jacobian ─────────────────────────────────────────────────────────
def _states():
    """Three lanes of interval states (laminar, transitional, separated
    laminar) around a flat-plate-like march."""
    f32 = np.float32
    t1 = np.array([3e-4, 1.1e-3, 2e-3], f32)
    d1 = np.array([7e-4, 2.2e-3, 9e-3], f32)
    a1 = np.array([0.0, -3.5, 4.0], f32)
    z = np.stack([np.log(t1 * 1.05), np.log(d1 * 1.02), a1 + 0.3], 1)
    return dict(z=z.astype(f32),
                carry=(t1, d1, a1),
                st1=(np.array([.01, .3, .5], f32), np.array([1., 1.2, .9], f32),
                     np.array([.01, .3, .5], f32)),
                st2=(np.array([.02, .32, .53], f32),
                     np.array([1.01, 1.19, .88], f32),
                     np.array([.02, .32, .53], f32)),
                nu=np.array([1e-6, 1e-6, 2e-6], f32))


@pytest.mark.parametrize("regime", ["laminar", "turbulent", "wake"])
def test_jacobian(regime):
    st = _states()
    turb_np = np.full(3, regime != "laminar")
    wake = regime == "wake"
    t = {k: (tuple(torch.tensor(a) for a in v) if isinstance(v, tuple)
             else torch.tensor(v)) for k, v in st.items()}
    turb = torch.tensor(turb_np)
    jac, r = march._jacobian(t["z"], t["carry"], t["st1"], t["st2"], t["nu"],
                             turb, wake)

    def res(z):
        return march._step_residual(z, t["carry"], t["st1"], t["st2"],
                                    t["nu"], turb, wake)

    full = torch.func.jacfwd(res)(t["z"])               # (L, 3, L, 3)
    block = torch.stack([full[i, :, i, :] for i in range(3)])
    np.testing.assert_allclose(jac.numpy(), block.numpy(), rtol=1e-6,
                               atol=1e-6 * float(block.abs().max()))
    np.testing.assert_array_equal(r.numpy(), res(t["z"]).numpy())
    for i in range(3):
        lane = lambda v: (tuple(jnp.asarray(a[i]) for a in v)
                          if isinstance(v, tuple) else jnp.asarray(v[i]))
        args = (lane(st["carry"]), lane(st["st1"]), lane(st["st2"]),
                lane(st["nu"]), jnp.asarray(turb_np[i]))
        ref = jax.jacfwd(jmarch._step_residual)(jnp.asarray(st["z"][i]),
                                                *args, wake=wake)
        ref = np.asarray(ref)
        np.testing.assert_allclose(jac[i].numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


# ── marches ─────────────────────────────────────────────────────────────────
def _jax_lanes(s, ue, x, nu, n_crit, xtrip):
    return jax.vmap(jmarch.march_side)(*(jnp.asarray(a) for a in
                                         (s, ue, x, nu, n_crit, xtrip)))


def _port_lanes(s, ue, x, nu, n_crit, xtrip):
    return kernel.march_side(*(torch.tensor(a) for a in
                               (s, ue, x, nu, n_crit, xtrip)))


def _hold(port, ref, name):
    compare(port, ref, rtol=1e-4, fields=MARCH_FIELDS, name=name)
    compare(port, ref, rtol=1e-4, atol=1e-5, fields=["amp", "ctau"],
            name=name)
    compare(port, ref, rtol=0.0, fields=["turb", "separated",
                                         "x_transition"], name=name)


# (Re, n_crit, x_trip): Blasius (no transition), tripped at 0.05, free
# transition at 6e6 and 1e7, none at 2e5 (tests/test_viscous.py:76-105).
FLAT_PLATE = [(1e6, 30.0, 1.0), (1e6, 9.0, 0.05), (6e6, 9.0, 1.0),
              (1e7, 9.0, 1.0), (2e5, 9.0, 1.0)]


@pytest.fixture(scope="module")
def flat_plate():
    n = len(FLAT_PLATE)
    s = np.tile(np.linspace(0.004, 1.0, 120, dtype=np.float32), (n, 1))
    ue = np.ones_like(s)
    nu, n_crit, xtrip = (np.array(c, np.float32) for c in zip(*FLAT_PLATE))
    nu = (1.0 / nu).astype(np.float32)
    args = (s, ue, s, nu, n_crit, xtrip)
    before = kernel.march_launches
    port = _port_lanes(*args)
    assert kernel.march_launches == before      # CPU: the plain march
    return port, _jax_lanes(*args)


def test_flat_plate_matches_jax(flat_plate):
    _hold(*flat_plate, "flat plate")


def test_flat_plate_physics(flat_plate):
    """tests/test_viscous.py's flat-plate anchors, on the port."""
    bl = as_numpy(flat_plate[0])
    theta_exact = 0.664 / np.sqrt(1e6)
    assert abs(bl["theta"][0, -1] - theta_exact) / theta_exact < 0.02
    assert abs(bl["hk"][0, -1] - 2.59) < 0.02
    assert 0.0028 < bl["cf"][1, -1] < 0.0046 and 1.25 < bl["hk"][1, -1] < 1.55
    for lane, re in ((2, 6e6), (3, 1e7)):
        assert 2.5e6 < re * bl["x_transition"][lane] < 3.6e6
    assert bl["x_transition"][4] >= 0.99


FALKNER_SKAN = [(0.0, 2.591), (-0.05, 2.676), (-0.10, 2.801), (-0.14, 2.963)]


def test_falkner_skan_matches_jax():
    """ue = x^m power-law edge flows, no transition
    (tests/test_viscous.py:54-73), four lanes of 256 stations."""
    n = 256
    x = np.linspace(1e-3, 1.0, n, dtype=np.float32)
    lanes = len(FALKNER_SKAN)
    s = np.tile(x, (lanes, 1))
    ue = np.stack([x ** (b / (2.0 - b)) for b, _ in FALKNER_SKAN]
                  ).astype(np.float32)
    full = lambda v: np.full(lanes, v, np.float32)
    args = (s, ue, s, full(1.0 / 5e5), full(1e9), full(2.0))
    port = _port_lanes(*args)
    _hold(port, _jax_lanes(*args), "falkner-skan")
    hk = port.dstar.numpy() / np.maximum(port.theta.numpy(), 1e-12)
    for i, (_, h_ref) in enumerate(FALKNER_SKAN):
        assert abs(np.median(hk[i, n // 3: 2 * n // 3]) - h_ref) / h_ref < 0.01


def test_wake_matches_jax():
    """The wake relaxation case (tests/test_viscous.py:108-116)."""
    s = np.linspace(0.01, 1.0, 40, dtype=np.float32)
    ue = np.full(40, 0.9, np.float32)
    states = (np.float32(1e-6), np.float32(0.004), np.float32(0.008),
              np.float32(0.002))
    ref = jmarch.march_wake(jnp.asarray(s), jnp.asarray(ue),
                            *(jnp.asarray(v) for v in states))
    before = kernel.wake_launches
    port = kernel.march_wake(torch.tensor(s), torch.tensor(ue),
                             *(torch.tensor(v) for v in states))
    assert kernel.wake_launches == before       # CPU: the plain march
    compare(port, ref, rtol=1e-4)
    theta, _, hk = as_numpy(port)
    assert hk[-1] < 1.3
    np.testing.assert_allclose(theta[-1], 0.004, rtol=1e-3)


def test_single_lane_equals_batched():
    s = np.linspace(0.004, 0.2, 20, dtype=np.float32)
    ue = np.ones_like(s)
    one = kernel.march_side(torch.tensor(s), torch.tensor(ue),
                            torch.tensor(s), 1.0 / 6e6, 9.0, 1.0)
    both = _port_lanes(np.stack([s, s]), np.stack([ue, ue]), np.stack([s, s]),
                       np.float32([1e-6, 1.0 / 6e6]), np.float32([30, 9]),
                       np.float32([1, 1]))
    for a, b in zip(one, both):
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())


def test_wake_ctau0_matches_jax(flat_plate):
    port, ref = flat_plate
    pick = lambda bl, i, lib: type(bl)(*(a[i] for a in bl))
    args = (np.float32(0.003), np.float32(0.005), np.float32(0.95),
            np.float32(1e-6))
    for lam, turb in ((0, 1), (4, 2), (1, 1)):
        got = march.wake_ctau0(pick(port, lam, torch), pick(port, turb, torch),
                               *(torch.tensor(a) for a in args))
        want = jmarch.wake_ctau0(pick(ref, lam, jnp), pick(ref, turb, jnp),
                                 *(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_stagnation_ic_matches_jax():
    s1 = np.array([1e-9, 1e-4, 0.01], np.float32)
    ue1 = np.array([0.3, 1e-9, 0.9], np.float32)
    compare(march.stagnation_ic(torch.tensor(s1), torch.tensor(ue1), 1e-6),
            jmarch.stagnation_ic(jnp.asarray(s1), jnp.asarray(ue1), 1e-6),
            rtol=1e-6)


def test_kernel_wrapper_rejects_bad_input():
    s = torch.linspace(0.01, 1.0, 10)
    with pytest.raises(TypeError, match="float32"):
        kernel.march_side(s.double(), s, s, 1e-6)
    with pytest.raises(ValueError, match="shape"):
        kernel.march_side(s, s[:-1], s, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.ones(2, 20)
        kernel.march_side(wide[:, ::2], wide[:, ::2].contiguous(),
                          wide[:, ::2].contiguous(), 1e-6)
    with pytest.raises(TypeError, match="float32"):
        kernel.march_wake(s.double(), s, 1e-6, 1e-3, 2e-3, 1e-3)
