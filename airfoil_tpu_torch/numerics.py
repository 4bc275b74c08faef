"""Torch counterparts of the jnp primitives that torch lacks or defines
differently, each with jnp's semantics (``jax.numpy`` 0.9), and a small
forward-mode dual type for the boundary-layer march.

- ``interp``: ``jnp.interp`` without ``left``/``right``/``period``: the
  segment is the one ``searchsorted(xp, x, side='right')`` picks (so at a
  knot the slope is that of the segment to its right), and outside ``xp``
  the result is clamped to ``fp[0]``/``fp[-1]``. The index comes from
  comparisons, so the function also runs on ``Dual`` numbers and under
  ``torch.func`` transforms, where it gives the piecewise slope as
  ``jax.jvp`` does.
- ``gradient``: ``jnp.gradient`` of a 1-D array with unit spacing (central
  differences inside, one-sided at the ends), which is ``torch.gradient``.
- ``nanmax``/``nanmin``: NaN-ignoring reductions to a 0-d tensor; NaN when
  every element is NaN. No host synchronisation.
- ``clip``, ``maximum``, ``minimum``: as JAX writes ``jnp.clip``
  (``minimum(hi, maximum(lo, x))``), NaN-propagating, with the derivative
  split 0.5/0.5 at a tie as in JAX (``torch.clamp``'s is 1 at the bound).
- ``where``, ``exp``, ``log``, ``log10``, ``sqrt``, ``tanh``, ``stack``,
  ``cat``: the torch function for tensors, the dual rule for ``Dual``.
  ``log10`` is ``log(x) * 0.4342944920063019`` in float32, as JAX lowers
  ``jnp.log10``.
- ``sigmoid``: ``jax.nn.sigmoid`` (``lax.logistic``), JVP sigma (1 - sigma).
- ``softplus``: ``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``:
  max(x, 0) + log1p(exp(-|x|)) (``torch.nn.functional.softplus`` instead
  returns x past its threshold), JVP exp(x - softplus(x)).
- ``matvec``: ``a @ x`` over the last axis of ``x``, which may carry
  leading batch axes or be a ``Dual``; ``a`` may hold one matrix a lane.
- ``take``: ``a[..., j]`` lane by lane (``torch.take_along_dim`` with
  the leading axes broadcast).

``Dual`` carries a value ``v`` and K tangents ``t`` (K leading, so ``t``
is (K, *v.shape)); arithmetic, comparisons and the functions above follow
JAX's JVP rules. The march's Newton Jacobian is one evaluation of its
residual on a ``Dual`` seeded with the three unit directions: the forward
mode of ``jax.jacfwd``, without the per-op dispatch cost of
``torch.func`` (80 ms against ~5 ms per Newton iteration on a CPU).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Dual", "cat", "clip", "exp", "gradient", "interp", "log",
           "log10", "matvec", "maximum", "minimum", "nanmax", "nanmin",
           "sigmoid", "softplus", "sqrt", "stack", "take", "tanh", "value",
           "where", "zeros_like"]

# jnp.interp treats a segment as empty below this width.
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))
_LOG10_E = 0.4342944920063019


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _scale(t, f):
    return None if t is None else t * f


def _neg(t):
    return None if t is None else -t


class Dual:
    """Forward-mode dual number: value ``v``, tangents ``t`` (K, *v.shape),
    ``t`` None for a constant."""

    __slots__ = ("v", "t")

    def __init__(self, v: torch.Tensor, t: torch.Tensor | None):
        self.v = v
        self.t = t

    def __getitem__(self, idx):
        return Dual(self.v[idx], self.t[(slice(None), idx)]
                    if not isinstance(idx, tuple) else
                    self.t[(slice(None),) + idx])

    def reshape(self, *shape):
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        return Dual(self.v.reshape(shape),
                    self.t.reshape(self.t.shape[0], *shape))

    def __neg__(self):
        return Dual(-self.v, _neg(self.t))

    def __add__(self, o):
        return Dual(self.v + value(o), _add(self.t, tangent(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return Dual(self.v - value(o), _add(self.t, _neg(tangent(o))))

    def __rsub__(self, o):
        return Dual(value(o) - self.v, _add(tangent(o), _neg(self.t)))

    def __mul__(self, o):
        ov, ot = value(o), tangent(o)
        return Dual(self.v * ov, _add(_scale(self.t, ov), _scale(ot, self.v)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        ov, ot = value(o), tangent(o)
        out = self.v / ov
        t = _add(self.t, _scale(ot, -out))
        return Dual(out, None if t is None else t / ov)

    def __rtruediv__(self, o):
        out = value(o) / self.v
        t = _add(tangent(o), _scale(self.t, -out))
        return Dual(out, None if t is None else t / self.v)

    def __pow__(self, p):
        if isinstance(p, (int, float)):
            # jnp's x ** 2 is integer_pow; its JVP is 2 x.
            d = self.v * 2.0 if p == 2 else p * self.v ** (p - 1)
            return Dual(self.v ** p, _scale(self.t, d))
        pv, pt = value(p), tangent(p)
        out = self.v ** pv
        t = _scale(self.t, pv * self.v ** (pv - 1.0))
        if pt is not None:
            logx = torch.log(torch.where(self.v == 0.0, 1.0, self.v))
            t = _add(t, pt * (logx * out))
        return Dual(out, t)

    def __lt__(self, o):
        return self.v < value(o)

    def __le__(self, o):
        return self.v <= value(o)

    def __gt__(self, o):
        return self.v > value(o)

    def __ge__(self, o):
        return self.v >= value(o)


def value(x):
    return x.v if isinstance(x, Dual) else x


def tangent(x):
    return x.t if isinstance(x, Dual) else None


_CONSTS: dict = {}   # (value, dtype, device) -> 0-d tensor


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a cached 0-d tensor: torch ops take a 0-d tensor
    operand at about half the cost of a Python scalar."""
    key = (c, like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS.setdefault(key, torch.tensor(c, dtype=like.dtype,
                                                 device=like.device))
    return t


def _select_max(a, b, larger: bool):
    """``jnp.maximum``/``jnp.minimum`` with JAX's tie rule: the tangent of
    the operand that wins, the mean of both at a tie."""
    av, bv = value(a), value(b)
    if not isinstance(av, torch.Tensor):
        av = _const(av, bv)
    if not isinstance(bv, torch.Tensor):
        bv = _const(bv, av)
    out = torch.maximum(av, bv) if larger else torch.minimum(av, bv)
    at, bt = tangent(a), tangent(b)
    if at is None and bt is None:
        return out
    zero = _const(0.0, out)
    at = zero if at is None else at
    bt = zero if bt is None else bt
    a_wins, b_wins = (av > bv, bv > av) if larger else (av < bv, bv < av)
    tie = _const(0.5, out) * (at + bt)
    return Dual(out, torch.where(a_wins, at, torch.where(b_wins, bt, tie)))


def maximum(a, b):
    return _select_max(a, b, True)


def minimum(a, b):
    return _select_max(a, b, False)


def clip(x, lo=None, hi=None):
    """``jnp.clip(x, lo, hi)``: NaN-propagating, ties split 0.5/0.5."""
    if lo is not None:
        x = maximum(lo, x)
    if hi is not None:
        x = minimum(hi, x)
    return x


def where(c, a, b):
    av, bv = value(a), value(b)
    out = torch.where(c, av, bv)
    at, bt = tangent(a), tangent(b)
    if at is None and bt is None:
        return out
    zero = _const(0.0, out)

    def lift(t):     # (K, *v.shape) -> (K, 1.., *v.shape) of out's rank
        if t is None:
            return zero
        return t.reshape(t.shape[0], *[1] * (out.dim() + 1 - t.dim()),
                         *t.shape[1:])

    return Dual(out, torch.where(c, lift(at), lift(bt)))


def zeros_like(x):
    return torch.zeros_like(value(x))


def exp(x):
    if not isinstance(x, Dual):
        return torch.exp(x)
    out = torch.exp(x.v)
    return Dual(out, x.t * out)


def log(x):
    if not isinstance(x, Dual):
        return torch.log(x)
    return Dual(torch.log(x.v), x.t / x.v)


def log10(x):
    """``jnp.log10`` as JAX lowers it."""
    return log(x) * _LOG10_E


def sqrt(x):
    if not isinstance(x, Dual):
        return torch.sqrt(x)
    out = torch.sqrt(x.v)
    return Dual(out, x.t * (0.5 / out))


def tanh(x):
    if not isinstance(x, Dual):
        return torch.tanh(x)
    out = torch.tanh(x.v)
    return Dual(out, x.t * (1.0 - out * out))


def sigmoid(x):
    """``jax.nn.sigmoid``; JVP sigma (1 - sigma), as ``lax.logistic``'s."""
    if not isinstance(x, Dual):
        return torch.sigmoid(x)
    out = torch.sigmoid(x.v)
    return Dual(out, x.t * (out * (1.0 - out)))


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == torch.inf, 0.0, x)


def softplus(x):
    """``jax.nn.softplus`` = ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), x itself where x is NaN; its JVP is JAX's,
    exp(x - softplus(x))."""
    xv = value(x)
    out = torch.where(torch.isnan(xv), xv,
                      torch.clamp(xv, min=0.0)
                      + torch.log1p(torch.exp(-xv.abs())))
    if not isinstance(x, Dual):
        return out
    return Dual(out, x.t * torch.exp(_finite_or_zero(xv)
                                     - _finite_or_zero(out)))


def stack(xs, dim: int = -1):
    """``torch.stack`` along ``dim`` (a negative axis of the values)."""
    if not any(isinstance(x, Dual) for x in xs):
        return torch.stack(xs, dim)
    vs = [value(x) for x in xs]
    ref = next(x.t for x in xs if isinstance(x, Dual))
    ts = [x.t if isinstance(x, Dual) else torch.zeros_like(ref) for x in xs]
    return Dual(torch.stack(vs, dim), torch.stack(ts, dim))


def cat(xs, dim: int = -1):
    """``torch.cat`` along ``dim`` (a negative axis of the values)."""
    if not any(isinstance(x, Dual) for x in xs):
        return torch.cat(xs, dim)
    k = next(x.t.shape[0] for x in xs if isinstance(x, Dual))
    ts = [x.t if isinstance(x, Dual) else x.new_zeros((k, *x.shape))
          for x in xs]
    return Dual(torch.cat([value(x) for x in xs], dim), torch.cat(ts, dim))


def matvec(a: torch.Tensor, x):
    """``a @ x`` for ``x`` (n,), (..., n) (each row a vector) or a
    ``Dual``; ``a`` (m, n), or (P, m, n), one matrix a lane, for ``x``
    (..., P, n)."""
    if a.dim() > 2:
        if isinstance(x, Dual):
            return Dual(_lane_matvec(a, x.v), _lane_matvec(a, x.t))
        return _lane_matvec(a, x)
    if isinstance(x, Dual):
        return Dual(x.v @ a.mT, x.t @ a.mT)
    return a @ x if x.dim() == 1 else x @ a.mT


def _lane_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("pij,...pj->...pi", a, x)


def take(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``a[..., j]`` lane by lane: ``torch.take_along_dim`` over the last
    axis, the leading axes of ``a`` and ``j`` broadcast against each
    other."""
    if a.dim() < j.dim():
        a = a.reshape((1,) * (j.dim() - a.dim()) + a.shape)
    elif j.dim() < a.dim():
        j = j.reshape((1,) * (a.dim() - j.dim()) + j.shape)
    return torch.take_along_dim(a, j, -1)


def _take_dual(f, j):
    if isinstance(f, Dual):
        return Dual(take(f.v, j), take(f.t, j))
    return take(f, j)


def interp(x, xp: torch.Tensor, fp):
    """``jnp.interp(x, xp, fp)`` for increasing ``xp``; ``x`` a tensor of
    any shape or a ``Dual``, ``fp`` a 1-D tensor or ``Dual``, or a batch
    (..., len(xp)) of them (one interpolation a row, as ``vmap`` over
    ``fp``). With a lane axis: ``xp`` (n,) shared or (*L, n), one grid a
    lane, ``x`` (*L, m) and ``fp`` (..., *L, n), the lanes aligned."""
    n = xp.shape[-1]
    xv = value(x)
    lanes = xp.dim() > 1
    i = ((xp.unsqueeze(-2) if lanes else xp)
         <= xv.unsqueeze(-1)).sum(-1).clamp(1, n - 1)
    rows = lanes or value(fp).dim() > 1

    def at(a, j):      # a[j], written so that vmap never sees a 0-d index
        return a[j.reshape(-1)].reshape(j.shape)

    if rows:
        x_lo, x_hi = take(xp, i - 1), take(xp, i)
        f_lo, f_hi = _take_dual(fp, i - 1), _take_dual(fp, i)
        first, last = fp[..., :1], fp[..., -1:]
    else:
        x_lo, x_hi = at(xp, i - 1), at(xp, i)
        f_lo, f_hi = at(fp, i - 1), at(fp, i)
        first, last = fp[0], fp[-1]
    lo, hi = (xp[..., :1], xp[..., -1:]) if lanes else (xp[0], xp[-1])
    dx = x_hi - x_lo
    dx0 = dx.abs() <= _DX_EPS
    f = where(dx0, f_lo,
              f_lo + ((x - x_lo) / torch.where(dx0, 1.0, dx)) * (f_hi - f_lo))
    f = where(xv < lo, first, f)
    return where(xv > hi, last, f)


def gradient(f: torch.Tensor) -> torch.Tensor:
    """``jnp.gradient(f)`` with unit spacing along the last axis (a 1-D
    tensor, or one row a lane)."""
    return torch.gradient(f, dim=-1)[0]


def _nan_reduce(x: torch.Tensor, fill: float, reduce) -> torch.Tensor:
    nan = torch.isnan(x)
    out = reduce(torch.where(nan, fill, x))
    return torch.where(nan.all(), torch.nan, out)


def nanmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmax(x)`` over all elements."""
    return _nan_reduce(x, -torch.inf, torch.max)


def nanmin(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmin(x)`` over all elements."""
    return _nan_reduce(x, torch.inf, torch.min)
