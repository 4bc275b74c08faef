"""The port's simultaneous-Newton system (``airfoil_tpu_torch.viscous.newton``)
against the JAX reference, live on the CPU, at fixed states made from a
seed with numpy.

Both packages get the same point: the reference's operator, wake operator,
station grid and inviscid edge velocities at NACA 2412, alpha 4, 160 panels
and a reduced station count (32 a side, 8 in the wake), carried into the
port as numpy. The states are seeded random walks of (ln theta, ln m,
ln ctau, n) that cover laminar, transitional and turbulent stations.

Tolerances:
- the residual: rtol 1e-5 with atol 1e-5 of the largest entry (each
  package rounds exp, log and the sigmoid in its own way, a few ulps);
- a batch of states gives each state's residual to 1e-6;
- the colored structured Jacobian against ``jax.jacfwd`` of the reference's
  dense residual at the linearisation point: rtol 1e-4 with atol 1e-5 of
  the largest entry;
- ``_seed_plan``: equal, array for array;
- ``_w_station``, ``_soft_floor`` and ``numerics.sigmoid``/``softplus``:
  values and JVPs (``jax.jvp``) to 2e-6 relative;
- one LM iteration from the same (zz, lambda) on the same J^T J and J^T r:
  the four candidate steps to 1e-3 relative of the largest step, the same
  accepted candidate (the damping it leaves equal) and the state to 1e-5;
  where every damped matrix fails its Cholesky (a negative damping), JAX's
  factor is NaN on its whole lower triangle, and the port takes no step
  and raises the damping as the reference does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airfoil_tpu.inviscid import build_operator as jbuild
from airfoil_tpu.inviscid import solve_inviscid as jsolve
from airfoil_tpu.models import naca4
from airfoil_tpu.paneling import panel_geometry as jgeom
from airfoil_tpu.paneling import repanel as jrepanel
from airfoil_tpu.viscous import coupled as jc
from airfoil_tpu.viscous import newton as jn
from airfoil_tpu.viscous import wake as jw
from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.inviscid import operator_from_numpy
from airfoil_tpu_torch.paneling import Paneling
from airfoil_tpu_torch.viscous import newton as tn
from airfoil_tpu_torch.viscous.wake import WakeOperator
from torch_parity import compare, to_torch

M_S, N_W = 32, 8
ALPHA, RE = 4.0, 1e6


def _fields(op):
    f = {k: np.asarray(v) for k, v in op._asdict().items() if k != "pan"}
    f["pan"] = {k: np.asarray(v) for k, v in op.pan._asdict().items()}
    return f


@pytest.fixture(scope="module")
def point():
    """The reference's point (operator, wake operator, grid, vt0) and the
    port's, made from the same numpy arrays."""
    ref_op = jbuild(jgeom(*jrepanel(naca4(2, 4, 12, 100), 160)))
    pan = ref_op.pan
    vt0 = jsolve(ref_op, ALPHA).vt
    wop = jw.build_wake_operator(ref_op, ALPHA, n_wake=N_W)
    s_mid = 0.5 * (pan.s[:-1] + pan.s[1:])
    s0 = jc._find_stagnation(s_mid, vt0, pan.s[jnp.argmin(pan.xp)])
    xi_u, s_q_u, _, x_u, y_u = jc._side_stations(pan, vt0, s0, True, M_S)
    xi_l, s_q_l, _, x_l, y_l = jc._side_stations(pan, vt0, s0, False, M_S)

    def trip(x):
        return jnp.where(jnp.arange(x.shape[0]) >= jnp.argmin(x), x, -1.0)

    grid = jn._Grid(xi_u=xi_u, xi_l=xi_l, xi_w=wop.xi, x_u=x_u, y_u=y_u,
                    x_l=x_l, y_l=y_l, s_q_u=s_q_u, s_q_l=s_q_l, s0=s0,
                    te_gap=jnp.hypot(pan.xp[0] - pan.xp[-1],
                                     pan.yp[0] - pan.yp[-1]),
                    xt_u=trip(x_u), xt_l=trip(x_l))
    nu = np.float32(1.0) / np.float32(RE)
    # The upper side's trip pulled forward, so its ramp shows.
    scalars = [nu, np.float32(9.0), np.float32(0.55), np.float32(1.0)]
    port_wop = WakeOperator(
        Paneling(*to_torch([np.asarray(a) for a in wop.wpan])),
        *to_torch([np.asarray(a) for a in wop[1:]]))
    port = dict(op=operator_from_numpy(_fields(ref_op), "cpu"), wop=port_wop,
                grid=tn._Grid(*to_torch([np.asarray(a) for a in grid])),
                vt0=torch.tensor(np.asarray(vt0)),
                scalars=to_torch(scalars))
    res = jax.jit(functools.partial(
        jn._residual, op=ref_op, wop=wop, grid=grid, vt0=vt0,
        nu=jnp.asarray(nu), m_s=M_S, n_w=N_W, n_crit=jnp.asarray(scalars[1]),
        x_trip_u=jnp.asarray(scalars[2]), x_trip_l=jnp.asarray(scalars[3])))
    ref = dict(res=res, jac=jax.jit(jax.jacfwd(res)))
    return ref, port


def seeded_state(seed: int) -> np.ndarray:
    """(ln theta, ln m, ln ctau, n) a station: sides thickening from the
    stagnation point with Hk 1.4-4 and n rising through n_crit, a wake of
    Hk 1.1-2.5 with n = 0."""
    rng = np.random.default_rng(seed)

    def side():
        f = np.linspace(0.0, 1.0, M_S)
        theta = (3e-5 + 2e-3 * f ** 1.3) * np.exp(0.05 * rng.standard_normal(M_S))
        hk = rng.uniform(1.4, 4.0, M_S)
        ct = 10.0 ** rng.uniform(-4.0, -1.5, M_S)
        n = np.sort(rng.uniform(0.0, 13.0, M_S))
        return np.stack([np.log(theta), np.log(theta * hk), np.log(ct), n], 1)

    theta_w = 4e-3 * (1.0 + 0.3 * rng.random(N_W))
    zw = np.stack([np.log(theta_w),
                   np.log(theta_w * rng.uniform(1.1, 2.5, N_W)),
                   np.log(10.0 ** rng.uniform(-3.0, -1.5, N_W)),
                   np.zeros(N_W)], 1)
    return np.concatenate([side().ravel(), side().ravel(),
                           zw.ravel()]).astype(np.float32)


def _port_system(port, zz_lin):
    return tn._System(port["op"], port["wop"], port["grid"], port["vt0"],
                      port["scalars"][0], M_S, N_W, *port["scalars"][1:],
                      zz_lin)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_residual(point, seed):
    ref, port = point
    zz = seeded_state(seed)
    want = ref["res"](jnp.asarray(zz))
    got = _port_system(port, torch.tensor(zz)).residual(torch.tensor(zz))
    assert got.shape == (4 * (2 * M_S + N_W),)
    compare(got, want, rtol=1e-5, atol_scale=1e-5)


def test_residual_of_a_batch_is_each_states(point):
    _, port = point
    zz = torch.tensor(np.stack([seeded_state(s) for s in (3, 4, 5)]))
    system = _port_system(port, zz[0])
    batch = system.residual(zz)
    for i in range(3):
        compare(batch[i], system.residual(zz[i]), rtol=1e-6, atol_scale=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_colored_jacobian_is_jacfwd(point, seed):
    """The structured Jacobian at the linearisation point of its
    interaction operator equals the dense forward-mode Jacobian."""
    ref, port = point
    zz = seeded_state(seed)
    want = ref["jac"](jnp.asarray(zz))
    got = _port_system(port, torch.tensor(zz)).jacobian(torch.tensor(zz))
    compare(got, want, rtol=1e-4, atol_scale=1e-5)


@pytest.mark.parametrize("shape", [(32, 8), (96, 20), (5, 3)])
def test_seed_plan(shape):
    got, want = tn._seed_plan(*shape), jn._seed_plan(*shape)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pairs = set(zip(got["rows_z"].tolist(), got["cols_z"].tolist()))
    assert len(pairs) == len(got["rows_z"])      # the scatter sets once


def _jvp_pair(jax_fn, port_fn, x, *args):
    """(port value, port tangent), (JAX value, JAX tangent) at ``x`` along
    a seeded direction."""
    dx = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    v, t = jax.jvp(lambda a: jax_fn(a, *(jnp.asarray(b) for b in args)),
                   (jnp.asarray(x),), (jnp.asarray(dx),))
    out = port_fn(nm.Dual(torch.tensor(x), torch.tensor(dx)[None]),
                  *to_torch(list(args)))
    return (out.v, out.t[0]), (v, t)


_XS = np.concatenate([np.linspace(-40.0, 40.0, 161),
                      np.random.default_rng(3).normal(0.0, 3.0, 200),
                      [0.0, 1e-6, -1e-6, 30.0, 120.0]]).astype(np.float32)


@pytest.mark.parametrize("name", ["sigmoid", "softplus"])
def test_sigmoid_softplus(name):
    got, want = _jvp_pair(getattr(jax.nn, name), getattr(nm, name), _XS)
    compare(got, want, rtol=2e-6, atol=1e-30)
    compare(getattr(nm, name)(torch.tensor(_XS)),
            getattr(jax.nn, name)(_XS), rtol=2e-6, atol=1e-30)


def test_w_station():
    rng = np.random.default_rng(11)
    n = rng.uniform(-8.0, 35.0, 300).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, 300).astype(np.float32)
    got, want = _jvp_pair(jn._w_station, tn._w_station, n, x,
                          np.float32(9.0), np.float32(0.4))
    compare(got, want, rtol=2e-6, atol=1e-30)


@pytest.mark.parametrize("lo", [0.02, 0.05])
def test_soft_floor(lo):
    x = np.random.default_rng(12).uniform(-0.2, 1.5, 300).astype(np.float32)
    got, want = _jvp_pair(lambda a, b: jn._soft_floor(a, b),
                          lambda a, b: tn._soft_floor(a, b), x,
                          np.float32(lo))
    compare(got, want, rtol=2e-6, atol=1e-30)


def _jax_lm_step(res, jac, zz, lam):
    """The reference's LM iteration (``newton.py`` ``lm_step``) on a given
    Jacobian: (candidate steps, their rms, new zz, new lam)."""
    factors = jnp.asarray(tn._LAM_FACTORS, jnp.float32)
    step_clip = jnp.tile(jnp.asarray(tn._STEP_CLIP, jnp.float32),
                         zz.shape[0] // 4)

    def rms(r):
        r = jnp.where(jnp.isfinite(r), r, 1e6)
        return jnp.sqrt(jnp.mean(r * r))

    r = res(zz)
    jtj, jtr = jac.T @ jac, jac.T @ r
    diag = jnp.maximum(jnp.diag(jtj), 1e-8)

    def candidate(factor):
        chol = jax.lax.linalg.cholesky(jtj + jnp.diag(lam * factor * diag))
        dz = jax.lax.linalg.triangular_solve(
            chol, jax.lax.linalg.triangular_solve(
                chol, -jtr[:, None], left_side=True, lower=True),
            left_side=True, lower=True, transpose_a=True)[:, 0]
        dz = jnp.clip(dz, -step_clip, step_clip)
        dz = jnp.where(jnp.all(jnp.isfinite(dz)), dz, jnp.zeros_like(dz))
        return dz, rms(res(zz + dz))

    dzs, rmss = jax.vmap(candidate)(factors)
    best = jnp.argmax(rmss <= jnp.min(rmss) * 1.01)
    accept = rmss[best] < rms(r)
    zz_new = jnp.where(accept, zz + dzs[best], zz)
    lam_new = jnp.clip(jnp.where(accept, lam * factors[best] / 3.0,
                                 lam * 64.0), 1e-7, 1e6)
    return dzs, rmss, zz_new, lam_new


@pytest.mark.parametrize("seed,lam", [(0, 0.05), (1, 2.0), (2, 0.3)])
def test_lm_step(point, seed, lam):
    """One LM iteration on the same J (the reference's dense jacfwd, given
    to both): the same candidates, the same choice, the same state."""
    ref, port = point
    zz = seeded_state(seed)
    res = ref["res"]
    jac = ref["jac"](jnp.asarray(zz))
    dzs, rmss, zz_new, lam_new = _jax_lm_step(res, jac, jnp.asarray(zz),
                                              jnp.float32(lam))
    system = _port_system(port, torch.tensor(zz))
    system.jacobian = lambda z: torch.tensor(np.asarray(jac))
    z_t, lam_t = torch.tensor(zz), torch.tensor(lam, dtype=torch.float32)
    _, jtj, jtr = system.normal_equations(z_t)
    got_dzs = system.candidate_steps(jtj, jtr, lam_t)
    compare(got_dzs, dzs, rtol=0.0, atol=1e-3 * float(jnp.abs(dzs).max()))
    got_z, got_lam = system.lm_step(z_t, lam_t)
    assert float(got_lam) == pytest.approx(float(lam_new), rel=1e-6)
    assert float(lam_new) != pytest.approx(lam * 64.0)   # a step was taken
    compare(got_z, zz_new, rtol=1e-5, atol=1e-5)


def test_lm_step_takes_no_step_where_every_cholesky_fails(point):
    ref, port = point
    zz = seeded_state(0)
    res = ref["res"]
    jac = ref["jac"](jnp.asarray(zz))
    lam = np.float32(-1e3)          # every damped matrix is indefinite
    jtj = jac.T @ jac
    chol = np.asarray(jax.lax.linalg.cholesky(
        jtj + jnp.diag(lam * jnp.maximum(jnp.diag(jtj), 1e-8))))
    assert np.isnan(chol[np.tril_indices(chol.shape[0])]).all()
    dzs, _rmss, zz_new, lam_new = _jax_lm_step(res, jac, jnp.asarray(zz),
                                               jnp.float32(lam))
    assert not np.asarray(dzs).any()
    system = _port_system(port, torch.tensor(zz))
    system.jacobian = lambda z: torch.tensor(np.asarray(jac))
    z_t, lam_t = torch.tensor(zz), torch.tensor(lam)
    _, jtj_t, jtr_t = system.normal_equations(z_t)
    assert not system.candidate_steps(jtj_t, jtr_t, lam_t).any()
    got_z, got_lam = system.lm_step(z_t, lam_t)
    assert torch.equal(got_z, z_t)
    assert float(got_lam) == float(lam_new) == pytest.approx(1e-7)
