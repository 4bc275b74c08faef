"""Polar sweeps: port of ``airfoil_tpu/polar/sweep.py``.

A polar is a hybrid parallel/sequential pipeline:

1. **Batched per-point pass**: every (alpha, Re) point runs the warm-start
   simultaneous-Newton solve as one lane of ``solve_polar_points``, all
   lanes through the same LM iterations (the reference's ``vmap``).
2. **Continuation walk**: one sequential walk over the sorted alphas,
   outward from alpha ~ 0, up then down. Each step audits the per-point
   result against the trend of its accepted neighbours and re-solves by
   continuation from the last accepted state where it fails (or, in the
   engaged stall regime, always); a failed free continuation retries with
   the transition tripped at the donor's front. The reference gates each
   re-solve by ``lax.cond``; here the walk reads the gate (``run_cont``,
   then ``run_trip``) on the host once per step and runs the solve only
   when it is true.
3. **Fallback strategies**: still-failed points take the smoothed-geometry
   solve (a bucket of at most 8 lanes), then the inviscid fill, tagged in
   ``mode`` as the reference service tags its strategies.

The audits, the carry and the selection are the reference's, decision for
decision; see its module for why each band and gate is what it is.
``warm_polar_kernels`` builds the march kernel and captures the polar's
CUDA graphs (the operator build, the Newton solve's, the walk's inviscid
fill) of a point-count bucket before the first request, where the
reference compiles its jitted pipeline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airfoil_tpu_torch import numerics as nm
from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.inviscid.programs import (inviscid_program,
                                                 operator_program)
from airfoil_tpu_torch.models import naca4
from airfoil_tpu_torch.viscous.newton import (
    solve_polar_point_cont,
    solve_polar_points,
)

__all__ = ["PolarResult", "solve_polar", "warm_polar_kernels",
           "MODE_VISCOUS", "MODE_VISCOUS_SMOOTHED", "MODE_INVISCID"]

MODE_VISCOUS = 0
MODE_VISCOUS_SMOOTHED = 1
MODE_INVISCID = 2

_N_STATIONS = 96

# Tier-2 forced-trip continuation rescue (see _walk): when the free
# continuation from a donor fails or is audit-rejected, retry with the
# transition tripped just aft of the donor's own front.
_TRIP_RESCUE = True
_TRIP_SLACK = 0.02

# Continuation-preferred acceptance: once the walk carries a lift deficit
# of at least _PREFER_CONT_D1, the continued chain state wins over an
# independently converged per-point result.
_PREFER_CONT = True
_PREFER_CONT_D1 = 0.05

# The walk's continuation solves so far, free ("cont") and tripped
# ("trip"): each is one single-lane Newton solve.
walk_solves = {"cont": 0, "trip": 0}


class PolarResult(NamedTuple):
    """Per-point polar arrays (numpy, on the host), all shapes (P,) for P
    (alpha, Re) pairs."""

    alpha: np.ndarray
    reynolds: np.ndarray
    cl: np.ndarray
    cd: np.ndarray
    cdp: np.ndarray
    cm: np.ndarray
    mode: np.ndarray          # int: 0 viscous / 1 smoothed / 2 inviscid
    converged: np.ndarray     # bool: any strategy converged (2 always does)
    xtr_upper: np.ndarray
    xtr_lower: np.ndarray
    sep_fraction: np.ndarray


def _tree_where(pred, a, b):
    """``torch.where`` field by field over (nested) tuples, ``pred`` one
    value a leading position."""
    if isinstance(a, torch.Tensor):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    return tuple(_tree_where(pred, x, y) for x, y in zip(a, b))


def _deficit(cl_inv, cl):
    """Absolute lift deficit, signed so 'viscosity sheds circulation' is
    positive for either lift sign."""
    return torch.where(cl_inv >= 0, cl_inv - cl, cl - cl_inv)


def _deficit_ok(d, cli, hist):
    """Deficit-growth audit: the absolute lift deficit must grow at >= ~0.08
    CL per unit of inviscid loading |cl_inv| as the walk climbs, once its
    baseline d1 >= 0.05 (0.025 CL of slack)."""
    n_acc, _a1, _cl1, _cd1, _a2, _cl2, _cd2, cli1, d1 = hist
    dcli = torch.abs(cli) - torch.abs(cli1)
    need = 0.08 * dcli - 0.025
    disengaged = (d1 < 0.05) | (dcli <= 1e-6)
    return (n_acc < 1) | disengaged | (d >= d1 + need)


def _trend_ok(a, cl, cd, hist):
    """Is (cl, cd) at alpha ``a`` consistent with the walk's history
    ``hist`` = (n_acc, a1, cl1, cd1, a2, cl2, cd2, cli1, d1)? With two
    accepted points CL and CD are extrapolated linearly, with one predicted
    flat in a wider band; the CD band admits twice as much growth as
    collapse."""
    n_acc, a1, cl1, cd1, a2, cl2, cd2, _cli1, _d1 = hist
    da = a - a1
    dd = torch.where(torch.abs(a1 - a2) < 1e-6, 1.0, a1 - a2)
    slope_cl = (cl1 - cl2) / dd
    slope_cd = (cd1 - cd2) / dd
    two = n_acc >= 2
    cl_pred = torch.where(two, cl1 + slope_cl * da, cl1)
    cd_pred = torch.where(two, cd1 + slope_cd * da, cd1)
    band_cl = torch.where(two, 0.045 + 0.05 * torch.abs(da),
                          0.05 + 0.13 * torch.abs(da))
    band_cd_up = torch.where(two,
                             nm.maximum(0.0030, 0.60 * torch.abs(cd_pred)),
                             nm.maximum(0.0060, 0.90 * torch.abs(cd_pred)))
    band_cd_dn = torch.where(two,
                             nm.maximum(0.0015, 0.30 * torch.abs(cd_pred)),
                             nm.maximum(0.0030, 0.50 * torch.abs(cd_pred)))
    cl_ok = torch.abs(cl - cl_pred) <= band_cl
    cd_ok = (cd - cd_pred <= band_cd_up) & (cd_pred - cd <= band_cd_dn)
    return (n_acc < 1) | (cl_ok & cd_ok)


def _shift_hist(hist, a, cl, cd, cli, d):
    n_acc, a1, cl1, cd1, _a2, _cl2, _cd2, _cli1, _d1 = hist
    return (torch.clamp(n_acc + 1, max=2), a, cl, cd, a1, cl1, cd1, cli, d)


def _walk(op, a_seq, re_seq, active, seg_start, cli_seq, slack_seq,
          m1_seq, nok1_seq, st1_seq, state_like):
    """The continuation walk over [ascending; descending] alphas: a loop
    of steps that each adopt the audited per-point result or re-solve by
    continuation from the carry (the last accepted state). The carry's
    history resets where a direction's first active step begins and at
    every ``seg_start`` step. Every acceptance passes the trend audit and
    the deficit audit. Returns (m_walk, used): the accepted 8-tuple of
    each step ((S,) tensors) and whether the step accepted one."""
    dev, f32 = a_seq.device, a_seq.dtype

    def zero():
        return torch.zeros((), dtype=f32, device=dev)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero_hist = (torch.zeros((), dtype=torch.int32, device=dev),) + tuple(
        zero() for _ in range(8))
    zeros8 = tuple(zero() for _ in range(4)) + (false,) + tuple(
        zero() for _ in range(3))

    prev_act, hist, st = false, zero_hist, state_like
    failcnt = torch.zeros((), dtype=torch.int32, device=dev)
    outs, useds = [], []
    for i in range(a_seq.shape[0]):
        a, re_, act, seg0, cli = (a_seq[i], re_seq[i], active[i],
                                  seg_start[i], cli_seq[i])
        sl_au, sl_mu, sl_al, sl_ml = (s[i] for s in slack_seq)
        m1 = tuple(m[i] for m in m1_seq)
        nok1 = nok1_seq[i]
        st1 = tuple(x[i] for x in st1_seq)

        reset = (act & ~prev_act) | seg0
        hist = _tree_where(reset, zero_hist, hist)
        failcnt = torch.where(reset, 0, failcnt)

        d1p = _deficit(cli, m1[0])
        adopt_trend = nok1 & _trend_ok(a, m1[0], m1[1], hist) & _deficit_ok(
            d1p, cli, hist)
        # Re-anchor after two consecutive walk failures on an independently
        # converged per-point result whose deficit passes the audit.
        re_anchor = (nok1 & _deficit_ok(d1p, cli, hist)
                     & (failcnt >= 2) & ~adopt_trend)
        adopt1 = adopt_trend | re_anchor
        can_cont = hist[0] >= 1
        prefer = ((hist[8] >= _PREFER_CONT_D1) & ~re_anchor) if _PREFER_CONT \
            else false
        run_cont = act & can_cont & (prefer | ~adopt1)

        def accept_cont(m):
            return _trend_ok(a, m[0], m[1], hist) & _deficit_ok(
                _deficit(cli, m[0]), cli, hist)

        slacks = dict(cont_slack_add=sl_au, cont_slack_mul=sl_mu,
                      cont_slack_add_l=sl_al, cont_slack_mul_l=sl_ml)
        # The reference's lax.cond: the host reads the gate, and the solve
        # runs only where it is set.
        if bool(run_cont):
            walk_solves["cont"] += 1
            mc, (nokc, stc_new) = solve_polar_point_cont(
                op, a, re_, *st, n_stations=_N_STATIONS, **slacks)
        else:
            mc, nokc, stc_new = zeros8, false, st
        usec = run_cont & nokc & accept_cont(mc)

        if _TRIP_RESCUE:
            # Tier-2 trip rescue: retry a failed (or audit-rejected) free
            # continuation with the transition tripped just aft of the
            # donor's front.
            run_trip = run_cont & ~usec
            if bool(run_cont) and bool(run_trip):
                walk_solves["trip"] += 1
                trip_u = torch.clamp(st[1] + _TRIP_SLACK, 0.01, 1.0)
                trip_l = torch.clamp(st[2] + _TRIP_SLACK, 0.01, 1.0)
                mt, (nokt, stt_new) = solve_polar_point_cont(
                    op, a, re_, *st, n_stations=_N_STATIONS,
                    x_forced_transition=trip_u,
                    x_forced_transition_lower=trip_l, **slacks)
            else:
                mt, nokt, stt_new = zeros8, false, st
            uset = run_trip & nokt & accept_cont(mt)
            mc = _tree_where(usec, mc, mt)
            stc_new = _tree_where(usec, stc_new, stt_new)
            usec = usec | uset

        # Precedence: in the engaged regime an accepted cont/trip state
        # wins over the per-point result; otherwise the per-point adoption
        # is the cheap first choice.
        use1 = act & adopt1 & ~(prefer & usec)
        used = use1 | usec
        m_out = _tree_where(use1, m1, _tree_where(usec, mc, zeros8))
        st_out = _tree_where(use1, st1, _tree_where(usec, stc_new, st))
        hist = _tree_where(re_anchor, zero_hist, hist)
        hist = _tree_where(used, _shift_hist(
            hist, a, m_out[0], m_out[1], cli, _deficit(cli, m_out[0])), hist)
        failcnt = torch.where(~act, failcnt, torch.where(used, 0,
                                                         failcnt + 1))
        prev_act, st = act, st_out
        outs.append(m_out)
        useds.append(used)
    m_walk = tuple(torch.stack(f) for f in zip(*outs))
    return m_walk, torch.stack(useds)


def _op_kernel(coords, n_panels=160):
    """Repanel + inviscid operator build (shared by the pass and the
    walk): the program ``"operator"``."""
    return operator_program(coords, n_panels)


def _op_kernel_smoothed(coords, n_panels=160):
    """Operator on the smoothed geometry (reference Strategy 2)."""
    return operator_program(coords, n_panels, smooth=True)[0]


def _points_kernel(op, alphas, reynolds):
    """Pass 1: the per-point solves, one lane a point."""
    return solve_polar_points(op, alphas, reynolds, n_stations=_N_STATIONS)


def _walk_kernel(op, alphas, reynolds, m1, nok1, st1):
    """Pass 2: the continuation walk (audit + repair + extend), plus the
    inviscid per-point fill used by Strategy 3. Returns (v1, cl3, cm3):
    the audited walk output tuple (slot 4 = point accepted by strategy 1)
    and the inviscid CL/Cm fill."""
    p_total = alphas.shape[0]
    # Stable sorts: a padded bucket repeats its last alpha.
    order = torch.argsort(alphas, stable=True)
    inv = torch.argsort(order, stable=True)
    a_s = alphas[order]
    re_s = reynolds[order]
    m1_s = tuple(x[order] for x in m1)
    nok1_s = nok1[order]
    st1_s = tuple(x[order] for x in st1)
    pos0 = torch.argmin(torch.abs(a_s))
    pos = torch.arange(p_total, device=alphas.device)

    def both(x):       # [ascending; descending]
        return torch.cat([x, x.flip(0)])

    # Segment 1 ascends from the point nearest alpha = 0; segment 2
    # descends over the whole range, its first step resetting the history.
    a_seq = both(a_s)
    re_seq = both(re_s)
    active = torch.cat([pos >= pos0, torch.ones_like(pos, dtype=torch.bool)])
    seg_start = torch.zeros(2 * p_total, dtype=torch.bool,
                            device=alphas.device)
    seg_start[p_total] = True

    def seq(up_val, dn_val):
        return torch.cat([torch.full((p_total,), up_val, dtype=a_s.dtype,
                                     device=a_s.device),
                          torch.full((p_total,), dn_val, dtype=a_s.dtype,
                                     device=a_s.device)])

    slack_seq = (seq(0.0, 0.15), seq(0.0, 0.5),       # upper add, mul
                 seq(0.15, 0.0), seq(0.5, 0.0))       # lower add, mul
    m1_seq = tuple(both(x) for x in m1_s)
    nok1_seq = both(nok1_s)
    st1_seq = tuple(both(x) for x in st1_s)
    state_like = tuple(x[0] for x in st1)

    # Inviscid per-point fill (Strategy 3), before the walk: the deficit
    # audit compares every accepted CL against the point's inviscid CL.
    sol = inviscid_program(op, alphas)
    cl3, cm3 = sol.cl, sol.cm
    cli_seq = both(cl3[order])

    m_walk, used = _walk(op, a_seq, re_seq, active, seg_start, cli_seq,
                         slack_seq, m1_seq, nok1_seq, st1_seq, state_like)

    m_up = tuple(x[:p_total] for x in m_walk)
    m_dn = tuple(x[p_total:].flip(0) for x in m_walk)
    used_up = used[:p_total]
    used_dn = used[p_total:].flip(0)
    # Prefer the ascent's result where it accepted one.
    m_sorted = _tree_where(used_up, m_up, m_dn)
    used_sorted = used_up | used_dn
    v1 = tuple(x[inv] for x in m_sorted)
    walk_used = used_sorted[inv]
    v1 = v1[:4] + (v1[4] & walk_used,) + v1[5:]
    return v1, cl3, cm3


def _rescue_kernel(op_s, a_b, re_b):
    """Pass 3: smoothed-geometry rescue (reference Strategy 2), on the
    failed-point bucket only."""
    out, _extra = solve_polar_points(op_s, a_b, re_b, n_stations=_N_STATIONS)
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _polar_kernel(coords, alphas, reynolds, n_panels=160):
    """The polar pipeline (see the module docstring): operator build, the
    per-point pass, the walk and inviscid fill, and the smoothed-geometry
    rescue where a point failed. The walk reads its gates on the host; the
    only other host read between stages is the (P,)-bool failure mask.
    Returns numpy arrays."""
    p_total = int(alphas.shape[0])
    op, _xp, _yp = _op_kernel(coords, n_panels)
    m1, (nok1, st1) = _points_kernel(op, alphas, reynolds)
    v1, cl3, cm3 = _walk_kernel(op, alphas, reynolds, m1, nok1, st1)

    use1 = _host(v1[4])
    v2_ok = np.zeros(p_total, bool)
    v2 = None
    if not use1.all():
        # Failed points gather into a bucket of at most 8 lanes; excess
        # failures are left to the inviscid fill.
        bucket = min(8, p_total)
        idx_b = np.argsort(use1, kind="stable")[:bucket]
        op_s = _op_kernel_smoothed(coords, n_panels)
        sel = torch.as_tensor(idx_b, device=alphas.device)
        out_b = [_host(x) for x in _rescue_kernel(op_s, alphas[sel],
                                                  reynolds[sel])]
        valid_b = ~use1[idx_b]
        v2 = [np.zeros((p_total,) + x.shape[1:], x.dtype) for x in out_b]
        for slot, xb in enumerate(out_b):
            v2[slot][idx_b] = np.where(valid_b, xb, 0.0 * xb)
        v2_ok = np.zeros(p_total, bool)
        v2_ok[idx_b] = valid_b & out_b[4].astype(bool)

    # ── final selection (the reference's three-strategy precedence) ──
    v1 = [_host(x) for x in v1]
    cl3 = _host(cl3)
    cm3 = _host(cm3)
    if v2 is None:
        v2 = [np.zeros_like(x) for x in v1]
    use2 = ~use1 & v2_ok
    use3 = ~(use1 | use2)

    def pick(i1, i2, i3):
        return np.where(use1, i1, np.where(use2, i2, i3))

    one = np.ones(p_total, cl3.dtype)
    cl = pick(v1[0], v2[0], cl3)
    cd = pick(v1[1], v2[1], 0.0 * one)      # inviscid: CD unrealistically 0
    cdp = pick(v1[2], v2[2], 0.0 * one)
    cm = pick(v1[3], v2[3], cm3)
    xtru = pick(v1[5], v2[5], one)
    xtrl = pick(v1[6], v2[6], one)
    sep = pick(v1[7], v2[7], 0.0 * one)
    mode = np.where(use1, MODE_VISCOUS,
                    np.where(use2, MODE_VISCOUS_SMOOTHED, MODE_INVISCID))
    converged = use1 | use2 | use3
    return cl, cd, cdp, cm, mode, converged, xtru, xtrl, sep


# Point-count buckets: a polar pads (duplicating its last point) up to the
# next bucket, as the reference does for its compile cache; the padding is
# part of the result's semantics (the walk sees the duplicates, and the
# rescue bucket is min(8, padded count)).
_P_BUCKETS = (8, 16, 32, 64, 128)

# Input-coordinate buckets: padding by repeating the trailing point is
# exact through ``repanel`` (zero-length arc segments at the loop's end).
_C_BUCKETS = (128, 192, 256)


def _bucket_size(p: int) -> int:
    for b in _P_BUCKETS:
        if p <= b:
            return b
    return ((p + 63) // 64) * 64


def _pad_coords(coords: torch.Tensor) -> torch.Tensor:
    m = int(coords.shape[0])
    target = next((b for b in _C_BUCKETS if m <= b),
                  ((m + 63) // 64) * 64)
    if target == m:
        return coords
    tail = coords[-1:].expand(target - m, coords.shape[1])
    return torch.cat([coords, tail])


def _naca_loop(n_coords: int, dev) -> torch.Tensor:
    """NACA 2412 with about ``n_coords`` points, padded to its bucket."""
    return _pad_coords(torch.as_tensor(
        np.asarray(naca4(2, 4, 12, (n_coords - 1) // 2), np.float32),
        device=dev))


def warm_polar_kernels(p: int = 32, n_coords: int = 192,
                       n_panels: int = 160, rescue: bool = True,
                       device=None) -> None:
    """Build the march kernel and capture the polar's graphs
    (``viscous.graphs``: the operator build, the Newton solve's set-up and
    warm start, a round's re-projection, LM iteration and bookkeeping, its
    answer, and the walk's inviscid fill) of every shape key a polar of
    ``p`` points solves at, so that the first real ``solve_polar`` in that
    bucket captures nothing.

    Dummy inputs at the served shapes, as the reference's: NACA 2412 with
    ``n_coords`` points, alphas over -10..20 at Re 1e6, ``p`` rounded up
    to its bucket (``solve_polar`` pads to it); the operator, the
    per-point pass (one lane a point), the walk's inviscid fill over the
    bucket, one continuation solve from the pass's first lane (the walk's
    one-lane key) and, with ``rescue``, the smoothed operator and rescue
    (min(8, bucket) lanes). The operator's key is the loop's coordinate
    bucket, so it is built (and smoothed, with ``rescue``) at every other
    bucket up to 256 points too. One after another: the reference's
    threads overlap XLA compiles, which the port does not have. On
    ``device`` (see ``resolve_device``); on the CPU the same solves run
    eagerly."""
    dev = resolve_device(device)
    coords = _naca_loop(n_coords, dev)
    b = _bucket_size(p)
    alphas = torch.as_tensor(np.linspace(-10.0, 20.0, b, dtype=np.float32),
                             device=dev)
    res = torch.full((b,), 1e6, dtype=DTYPE, device=dev)
    op, _xp, _yp = _op_kernel(coords, n_panels)
    _m1, (_nok1, st1) = _points_kernel(op, alphas, res)
    inviscid_program(op, alphas)
    solve_polar_point_cont(op, alphas[0], res[0], *(x[0] for x in st1),
                           n_stations=_N_STATIONS)
    if rescue:
        r = min(8, b)
        _rescue_kernel(_op_kernel_smoothed(coords, n_panels), alphas[:r],
                       res[:r])
    for m in _C_BUCKETS:
        if m != coords.shape[0]:
            loop = _naca_loop(m, dev)
            _op_kernel(loop, n_panels)
            if rescue:
                _op_kernel_smoothed(loop, n_panels)


def solve_polar(
    coords,
    alphas,
    reynolds,
    n_panels: int = 160,
    device=None,
) -> PolarResult:
    """Run a whole polar on ``device`` (see ``resolve_device``).

    ``alphas`` and ``reynolds`` are broadcast against each other: a scalar
    Re with an alpha vector for a classic polar, or equal-length vectors
    for a general (alpha, Re) set. The walk audits points in sorted-alpha
    order regardless of Re. Returns numpy arrays.
    """
    dev = resolve_device(device)
    coords = _pad_coords(torch.as_tensor(np.asarray(coords, np.float32),
                                         device=dev))
    alphas = np.atleast_1d(np.asarray(alphas, np.float32))
    reynolds = np.broadcast_to(np.asarray(reynolds, np.float32),
                               alphas.shape)
    p = int(alphas.shape[0])
    pad = _bucket_size(p) - p
    a_in = np.concatenate([alphas, np.repeat(alphas[-1:], pad)])
    re_in = np.concatenate([reynolds, np.repeat(reynolds[-1:], pad)])
    out = _polar_kernel(coords, torch.as_tensor(a_in, dtype=DTYPE,
                                                device=dev),
                        torch.as_tensor(re_in, dtype=DTYPE, device=dev),
                        n_panels)
    out = tuple(o[:p] for o in out)
    cl, cd, cdp, cm, mode, conv, xtru, xtrl, sep = out
    return PolarResult(alphas, np.array(reynolds), cl, cd, cdp, cm, mode,
                       conv, xtru, xtrl, sep)
