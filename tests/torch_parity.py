"""Parity helper for the port's tests: the same numpy inputs go to a JAX
function and to its ``airfoil_tpu_torch`` counterpart, and the outputs are
compared field by field at a stated tolerance.

Outputs may be arrays, scalars, tuples, NamedTuples or dicts of them, from
either package; ``as_numpy`` turns any of them into nested numpy values.
Float fields are held by ``np.testing.assert_allclose`` (NaNs must sit in
the same places), bool and integer fields must be equal.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_numpy", "compare", "run_both", "to_jax", "to_torch"]


def to_torch(x, device="cpu"):
    """numpy (or nested tuples/lists/dicts of it) -> torch on ``device``."""
    if isinstance(x, dict):
        return {k: to_torch(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_torch(v, device) for v in x)
    if isinstance(x, np.ndarray) or np.isscalar(x):
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(a.copy(), device=device)
    return x


def to_jax(x):
    """numpy (or nested tuples/lists/dicts of it) -> jax arrays."""
    import jax.numpy as jnp

    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_jax(v) for v in x)
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return jnp.asarray(x)
    return x


def as_numpy(x):
    """Nested outputs of either package -> nested numpy values (a
    NamedTuple becomes a dict of its fields)."""
    if hasattr(x, "_asdict"):
        return {k: as_numpy(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: as_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [as_numpy(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, x


def compare(port, ref, rtol: float, atol: float = 0.0,
            atol_scale: float = 0.0, fields=None, name: str = "") -> None:
    """Assert ``port`` matches ``ref`` leaf by leaf.

    Float leaves: ``|port - ref| <= atol + atol_scale * max|ref| + rtol
    |ref|`` (``atol_scale`` for fields whose entries cross zero, where a
    bare rtol is meaningless). ``fields``, if given, limits the check to
    those top-level names.
    """
    p, r = as_numpy(port), as_numpy(ref)
    if fields is not None:
        p = {k: p[k] for k in fields}
        r = {k: r[k] for k in fields}
    pl, rl = dict(_leaves(p)), dict(_leaves(r))
    assert pl.keys() == rl.keys(), (name, pl.keys(), rl.keys())
    for key, rv in rl.items():
        pv = np.asarray(pl[key])
        rv = np.asarray(rv)
        label = f"{name}{'.' if name and key else ''}{key}"
        assert pv.shape == rv.shape, (label, pv.shape, rv.shape)
        if rv.dtype == bool or np.issubdtype(rv.dtype, np.integer):
            np.testing.assert_array_equal(pv, rv, err_msg=label)
            continue
        finite = np.isfinite(rv)
        scale = float(np.abs(rv[finite]).max()) if finite.any() else 0.0
        np.testing.assert_allclose(
            pv.astype(np.float64), rv.astype(np.float64), rtol=rtol,
            atol=atol + atol_scale * scale, err_msg=label)


def run_both(jax_fn, torch_fn, *args, device="cpu", **kwargs):
    """Call ``jax_fn`` and ``torch_fn`` on the same numpy ``args``
    (converted for each); returns (port output, reference output)."""
    ref = jax_fn(*to_jax(list(args)), **kwargs)
    port = torch_fn(*to_torch(list(args), device), **kwargs)
    return port, ref
