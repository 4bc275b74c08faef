"""The inviscid stage's programs of the compiled-program layer
(``viscous.graphs``): the operator build from coordinates and the
standalone inviscid solve, each a CUDA graph a shape key on the card and
its body eagerly on the CPU.

- ``operator_program(coords, n_panels, smooth)``: ``repanel``, then
  ``smooth_geometry`` where asked, ``panel_geometry`` and the influence
  fill (``panel_solver.influence``) as one graph; the LU factor
  (``panel_solver.factor``) eagerly; then the source sensitivities
  through the factor (``panel_solver.sensitivities``) as a second graph.
  The reference's ``_op_kernel`` and ``_op_kernel_smoothed``
  (``airfoil_tpu/polar/sweep.py:367-380``), and the operator part of its
  parser benchmark's, batch's and graft entry's programs. The factor stays
  outside the graphs because torch sends a batch of matrices to MAGMA,
  whose batched factor invalidates a capture (one matrix goes to
  cuSOLVER's, which captures): one design for every key, whatever torch's
  backend heuristics pick. Key: the device, the coordinates' shape
  without its last axis (lanes, points), ``n_panels`` and ``smooth``; the
  two graphs are its stages ``"influence"`` and ``"sensitivities"``.
- ``inviscid_program(op, alpha_deg, sigma)``: ``solve_inviscid``. Key:
  the device, the operator's lane shape, its panels, the angles' shape
  and whether ``sigma`` is given. Only the standalone solves call it: a
  solve inside a program that is already captured (the direct solve, the
  Newton set-up) calls ``solve_inviscid`` itself, since a capture cannot
  hold another.

The builds that the reference runs eagerly too (the upload's, the flow
field's and the paneling probe's operators, at a shape a file) call
``build_operator`` eagerly: a graph a file's point count would be one
capture and one memory pool a file.
"""

from __future__ import annotations

import functools

import torch

from airfoil_tpu_torch.device import DTYPE
from airfoil_tpu_torch.inviscid.panel_solver import (
    InviscidOperator,
    InviscidSolution,
    factor,
    influence,
    sensitivities,
    solve_inviscid,
)
from airfoil_tpu_torch.paneling import panel_geometry, repanel, smooth_geometry
from airfoil_tpu_torch.viscous import graphs

__all__ = ["inviscid_program", "operator_program"]


def _influence_body(n_panels: int, smooth: bool, flat):
    """(operator without its factor and sensitivities, xp, yp) of the
    coordinates ``flat[0]``: the first graph of ``"operator"``."""
    (coords,) = flat
    xp, yp = repanel(coords, n_panels)
    xs, ys = smooth_geometry(xp, yp) if smooth else (xp, yp)
    return influence(panel_geometry(xs, ys)), xp, yp


def _sensitivity_body(flat):
    """(dgamma_dsigma, due_dsigma) from (a_full, lu, piv, bn, at_full, bt):
    the second graph of ``"operator"``."""
    return sensitivities(*flat)


def operator_program(coords: torch.Tensor, n_panels: int = 160,
                     smooth: bool = False
                     ) -> tuple[InviscidOperator, torch.Tensor, torch.Tensor]:
    """(operator, xp, yp) of a (M, 2) loop, or of each lane of an
    (..., M, 2) stack of loops: ``build_operator(panel_geometry(
    *repanel(coords, n_panels)))``, with ``smooth_geometry`` of the nodes
    before the paneling where ``smooth`` (one loop only, as
    ``smooth_geometry`` takes); ``xp, yp`` are the repaneled nodes before
    any smoothing. The program runs on ``coords``' device."""
    coords = coords.to(DTYPE)
    if smooth and coords.dim() != 2:
        raise ValueError("smoothing takes one loop, not lanes")
    key = (coords.device, tuple(coords.shape[:-1]), n_panels, smooth)
    op, xp, yp = graphs.run(
        "operator", (*key, "influence"),
        functools.partial(_influence_body, n_panels, smooth), [coords])
    lu, piv = factor(op.a_full)
    ginf, due = graphs.run("operator", (*key, "sensitivities"),
                           _sensitivity_body,
                           [op.a_full, lu, piv, op.bn, op.at_full, op.bt])
    return (op._replace(lu=lu, piv=piv, due_dsigma=due, dgamma_dsigma=ginf),
            xp, yp)


def _inviscid_body(spec, flat) -> InviscidSolution:
    op, alpha, sigma = graphs.unflatten(spec, flat)
    return solve_inviscid(op, alpha, sigma)


def inviscid_program(op: InviscidOperator, alpha_deg,
                     sigma: torch.Tensor | None = None) -> InviscidSolution:
    """``solve_inviscid(op, alpha_deg, sigma)`` as the program
    ``"inviscid"``: ``alpha_deg`` a number, a 0-dim or a (A,) tensor or
    array. Only the fields the solve reads are copied into the graph."""
    xm = op.pan.xm
    alpha = graphs.as_input(alpha_deg, xm)
    unread = dict(at_a=None, at_b=None, due_dsigma=None, dgamma_dsigma=None)
    if sigma is None:
        unread.update(bn=None, bt=None)
    read = op._replace(pan=op.pan._replace(xp=None, yp=None, s=None),
                       **unread)
    flat, spec = graphs.flatten((read, alpha, sigma))
    key = (xm.device, tuple(xm.shape[:-1]), xm.shape[-1], tuple(alpha.shape),
           sigma is not None)
    return graphs.run("inviscid", key,
                      functools.partial(_inviscid_body, spec), flat)
