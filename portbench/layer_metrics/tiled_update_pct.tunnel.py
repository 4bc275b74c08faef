"""The tiled LBM kernel's share of the step kernels' calls over the window,
in percent: the program's counters ``tiled_launches`` over it and
``launches`` (one a call of ``lbm_steps_tiled`` and of ``lbm_steps``;
``airfoil_tpu_torch.lbm.kernel``). A cell serves one lattice at one step
count, so this is also the tiled kernel's share of the lattice-site
updates. None where the cell does not read both counters or no step
kernel was called."""

COUNTERS = ("lbm_tiled_launches", "lbm_launches")


def read(ctx):
    if not all(k in ctx.counters for k in COUNTERS):
        return None
    tiled, resident = (ctx.counters[k] for k in COUNTERS)
    if tiled + resident <= 0:
        return None
    return 100.0 * tiled / (tiled + resident)
