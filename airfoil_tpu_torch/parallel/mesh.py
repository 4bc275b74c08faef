"""Multi-device polars: port of ``airfoil_tpu/parallel/mesh.py``.

Points shard data-parallel over the ranks of a ``torch.distributed``
process group, one process a rank, every rank running the same call
(SPMD). As in the reference, the points are sorted by alpha and split into
contiguous alpha segments, one a rank: each rank runs its own batched
per-point pass, its own continuation walk and its own smoothed-geometry
rescue over its segment, and the ranks meet only in the final gather. A
rank deep in the stall region has no attached-flow seed of its own, so its
walk re-anchors on its best local per-point result; those few extra
failures fall through to the inviscid fill, as in the reference.

One process a rank is the only layout in which the ranks' host work runs in
parallel, and the polar is host-bound (its walk is a host loop). Where the
reference has one controller and a ``jax.sharding.Mesh``, a rank here holds
a ``Mesh`` record of its place in the group (``batch_mesh``); the ranks are
started by ``parallel.launch.run``.

Collectives: under NCCL (every rank a card of its own) the ranks exchange
CUDA tensors; under gloo (the CPU, or ranks that share one card) the
exchanged tensors are staged through pinned host memory, since gloo's
point-to-point calls take CPU tensors. With one rank no collective runs:
an exchange is a local copy, as JAX's ``ppermute`` is with the pair
(0, 0), and a gather is the rank's own block.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from airfoil_tpu_torch.device import DTYPE, resolve_device
from airfoil_tpu_torch.inviscid.programs import inviscid_program
from airfoil_tpu_torch.polar.sweep import (
    _N_STATIONS,
    MODE_INVISCID,
    MODE_VISCOUS,
    MODE_VISCOUS_SMOOTHED,
    _op_kernel,
    _op_kernel_smoothed,
    _tree_where,
    _walk,
)
from airfoil_tpu_torch.viscous.newton import solve_polar_points

__all__ = ["Mesh", "all_gather", "batch_mesh", "neighbour_exchange",
           "shard_polar_inputs", "sharded_polar"]

# Seconds of the last ``sharded_polar`` call on this rank, stage by stage
# (synchronised on a card): the per-point pass, the walk with its inviscid
# fill, the rescue (0 when skipped), the selection and the gather.
stage_seconds: dict = {}


@dataclass(frozen=True)
class Mesh:
    """One rank's place in a 1-D data-parallel group: its ``rank`` of
    ``size``, its ``device``, the group's ``backend`` (``"nccl"``,
    ``"gloo"``, or ``None`` outside any group), whether exchanges go
    through host memory (``staged``) and the process ``group``."""

    rank: int
    size: int
    device: torch.device
    backend: str | None = None
    staged: bool = False
    group: object = None


def batch_mesh(device=None, group=None) -> Mesh:
    """This rank's mesh in an initialised process group (``group``, or the
    default one); outside any process group, the one-rank mesh. The device
    comes from ``resolve_device``: ``cuda`` (the current card) unless the
    caller asks for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(0, 1, dev)
    group = dist.group.WORLD if group is None else group
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl group exchanges CUDA tensors, not {dev}")
    return Mesh(dist.get_rank(group), dist.get_world_size(group), dev,
                backend, backend == "gloo" and dev.type == "cuda", group)


def _peer(mesh: Mesh, rank: int) -> int:
    return dist.get_global_rank(mesh.group, rank)


_PINNED: dict = {}


def _pinned(key, like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer shaped as ``like``, kept across calls."""
    key = (key, tuple(like.shape), like.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(like.shape, dtype=like.dtype,
                                         pin_memory=True)
    return buf


def _to_host(mesh: Mesh, key, t: torch.Tensor) -> torch.Tensor:
    buf = _pinned(key, t)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(mesh.device).synchronize()
    return buf


def neighbour_exchange(mesh: Mesh, to_next: torch.Tensor,
                       to_prev: torch.Tensor):
    """Send ``to_next`` to rank + 1 and ``to_prev`` to rank - 1 (modulo the
    size) and return (what rank - 1 sent forward, what rank + 1 sent back),
    on the mesh's device: JAX's ``ppermute`` of the two ring directions.
    With one rank that is the rank's own two tensors."""
    if mesh.size == 1:
        return to_next, to_prev
    nxt = _peer(mesh, (mesh.rank + 1) % mesh.size)
    prv = _peer(mesh, (mesh.rank - 1) % mesh.size)
    if mesh.staged:
        s_next = _to_host(mesh, "send_next", to_next)
        s_prev = _to_host(mesh, "send_prev", to_prev)
        r_prev = _pinned("recv_prev", to_next)
        r_next = _pinned("recv_next", to_prev)
    else:
        s_next, s_prev = to_next.contiguous(), to_prev.contiguous()
        r_prev, r_next = torch.empty_like(s_next), torch.empty_like(s_prev)
    # Tags tell the two directions apart where both neighbours are one rank
    # (two ranks); NCCL ignores them and matches in posting order, which is
    # the same on every rank.
    ops = [dist.P2POp(dist.isend, s_next, nxt, mesh.group, 0),
           dist.P2POp(dist.isend, s_prev, prv, mesh.group, 1),
           dist.P2POp(dist.irecv, r_prev, prv, mesh.group, 0),
           dist.P2POp(dist.irecv, r_next, nxt, mesh.group, 1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if mesh.staged:
        return r_prev.to(mesh.device), r_next.to(mesh.device)
    return r_prev, r_next


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal in shape on every rank) stacked in rank
    order, (size, *t.shape): on the host where the mesh is staged, else on
    ``t``'s device."""
    if mesh.size == 1:
        return t.unsqueeze(0)
    t = t.contiguous()
    if mesh.staged:
        t = _to_host(mesh, "gather", t)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts)


def shard_polar_inputs(mesh: Mesh, alphas, reynolds):
    """Sort by alpha (stably), pad to a multiple of the mesh's size by
    repeating the last point, and return this rank's contiguous block on
    its device: (alphas, reynolds, pad, unsort), where ``unsort`` maps the
    sorted order back to the caller's. Sorting first makes each block a
    contiguous alpha segment, the layout the per-rank walk needs."""
    alphas = np.atleast_1d(np.asarray(alphas, np.float32))
    reynolds = np.broadcast_to(np.asarray(reynolds, np.float32),
                               alphas.shape)
    order = np.argsort(alphas, kind="stable")
    alphas = alphas[order]
    reynolds = reynolds[order]
    pad = (-alphas.shape[0]) % mesh.size
    if pad:
        alphas = np.concatenate([alphas, np.repeat(alphas[-1:], pad)])
        reynolds = np.concatenate([reynolds, np.repeat(reynolds[-1:], pad)])
    unsort = np.argsort(order, kind="stable")
    rows = alphas.shape[0] // mesh.size
    block = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    return (torch.as_tensor(alphas[block], dtype=DTYPE, device=mesh.device),
            torch.as_tensor(reynolds[block], dtype=DTYPE, device=mesh.device),
            pad, unsort)


def _local_points(op, alphas, reynolds):
    """One rank's batched per-point pass over its alpha block, one lane a
    point."""
    return solve_polar_points(op, alphas, reynolds, n_stations=_N_STATIONS)


def _local_walk(op, alphas, reynolds, m1, nok1, st1):
    """One rank's continuation walk, inviscid fill and selection over its
    block (sorted ascending). Returns (v1, use1, cl3, cm3): the walk's
    per-point tuple, the strategy-1 acceptance mask and the inviscid CL
    and Cm."""
    p_local = alphas.shape[0]
    dev, f32 = alphas.device, alphas.dtype
    pos0 = torch.argmin(torch.abs(alphas))
    pos = torch.arange(p_local, device=dev)

    def both(x):       # [ascending; descending]
        return torch.cat([x, x.flip(0)])

    a_seq = both(alphas)
    re_seq = both(reynolds)
    active = torch.cat([pos >= pos0, torch.ones_like(pos, dtype=torch.bool)])
    seg_start = torch.zeros(2 * p_local, dtype=torch.bool, device=dev)
    seg_start[p_local] = True
    m1_seq = tuple(both(x) for x in m1)
    nok1_seq = both(nok1)
    st1_seq = tuple(both(x) for x in st1)
    state_like = tuple(x[0] for x in st1)

    # The direction- and side-dependent donor-ceiling slack of the
    # single-device walk: the advancing side (upper on the ascent, lower on
    # the descent) is pinned to its donor front, the retreating side keeps
    # aft mobility.
    def seq(up_val, dn_val):
        return torch.cat([torch.full((p_local,), up_val, dtype=f32,
                                     device=dev),
                          torch.full((p_local,), dn_val, dtype=f32,
                                     device=dev)])

    slack_seq = (seq(0.0, 0.15), seq(0.0, 0.5),
                 seq(0.15, 0.0), seq(0.5, 0.0))

    # The inviscid fill before the walk: the deficit audit compares every
    # accepted CL against its point's inviscid CL.
    sol = inviscid_program(op, alphas)
    cl3, cm3 = sol.cl, sol.cm
    cli_seq = both(cl3)

    m_walk, used = _walk(op, a_seq, re_seq, active, seg_start, cli_seq,
                         slack_seq, m1_seq, nok1_seq, st1_seq, state_like)
    m_up = tuple(x[:p_local] for x in m_walk)
    m_dn = tuple(x[p_local:].flip(0) for x in m_walk)
    used_up = used[:p_local]
    used_dn = used[p_local:].flip(0)
    v1 = _tree_where(used_up, m_up, m_dn)
    use1 = v1[4] & (used_up | used_dn)
    return v1, use1, cl3, cm3


def _local_rescue(coords, n_panels, alphas, reynolds, use1):
    """Strategy 2 on one rank's block: any local failure runs the whole
    block on the smoothed-geometry operator of ``coords`` (the reference's
    ``lax.cond``; the host reads the mask once); a clean block skips it,
    building no operator, and answers zeros with slot 4 False."""
    if bool(use1.all()):
        z = torch.zeros_like(alphas)
        return (z, z, z, z, torch.zeros(alphas.shape, dtype=torch.bool,
                                        device=alphas.device), z, z, z)
    op_s = _op_kernel_smoothed(coords, n_panels)
    out, _extra = solve_polar_points(op_s, alphas, reynolds,
                                     n_stations=_N_STATIONS)
    return out


def _select_three_strategy(v1, use1, v2, cl3, cm3):
    """The three-strategy precedence (viscous, smoothed, inviscid), point
    by point: the single-device pipeline's tail."""
    use2 = ~use1 & v2[4]
    use3 = ~(use1 | use2)

    def pick(i1, i2, i3):
        return torch.where(use1, i1, torch.where(use2, i2, i3))

    one = torch.ones_like(cl3)
    cl = pick(v1[0], v2[0], cl3)
    cd = pick(v1[1], v2[1], 0.0 * one)
    cdp = pick(v1[2], v2[2], 0.0 * one)
    cm = pick(v1[3], v2[3], cm3)
    xtru = pick(v1[5], v2[5], one)
    xtrl = pick(v1[6], v2[6], one)
    sep = pick(v1[7], v2[7], 0.0 * one)
    mode = torch.where(use1, MODE_VISCOUS,
                       torch.where(use2, MODE_VISCOUS_SMOOTHED,
                                   MODE_INVISCID)).to(torch.int32)
    converged = use1 | use2 | use3
    return cl, cd, cdp, cm, mode, converged, xtru, xtrl, sep


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def sharded_polar(mesh: Mesh, coords, alphas, reynolds, n_panels: int = 160):
    """A polar with its points sharded over the mesh's ranks; every rank
    calls it with the same arguments and gets the whole answer.

    Returns the single-device polar kernel's tuple (cl, cd, cdp, cm, mode,
    converged, xtr_upper, xtr_lower, sep_fraction) as numpy arrays in the
    caller's point order, padding stripped. Every rank builds the operator
    from the same coordinates on its own device, solves its block (points
    pass, walk, and the rescue where one of its points failed: each rank
    reads its own failure mask) and selects; the ranks then all-gather the
    nine outputs, equal in size thanks to the padding."""
    dev = mesh.device
    t0 = _sync(dev)
    coords = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
    a_loc, re_loc, pad, unsort = shard_polar_inputs(mesh, alphas, reynolds)
    op, _xp, _yp = _op_kernel(coords, n_panels)
    m1, (nok1, st1) = _local_points(op, a_loc, re_loc)
    t1 = _sync(dev)
    v1, use1, cl3, cm3 = _local_walk(op, a_loc, re_loc, m1, nok1, st1)
    t2 = _sync(dev)
    v2 = _local_rescue(coords, n_panels, a_loc, re_loc, use1)
    t3 = _sync(dev)
    out = _select_three_strategy(v1, use1, v2, cl3, cm3)
    # One gather of all nine outputs: modes and flags are exact in float32.
    block = torch.stack([o.to(DTYPE) for o in out])
    t4 = _sync(dev)
    full = all_gather(mesh, block).permute(1, 0, 2).reshape(9, -1)
    full = full.cpu().numpy()
    t5 = time.perf_counter()
    stage_seconds.clear()
    stage_seconds.update(points=t1 - t0, walk=t2 - t1, rescue=t3 - t2,
                         select=t4 - t3, gather=t5 - t4)
    types = (np.float32,) * 4 + (np.int32, np.bool_) + (np.float32,) * 3
    res = tuple(full[i].astype(ty) for i, ty in enumerate(types))
    if pad:
        res = tuple(o[:-pad] for o in res)
    return tuple(o[unsort] for o in res)
