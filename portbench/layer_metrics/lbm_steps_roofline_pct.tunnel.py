"""The resident LBM kernel's share of its roofline, in percent: the least
time one ``steps_per_frame``-step call could take on the card (the lattice
read and written once and the cell word read once, or the plain step's
float32 operations, whichever bounds it; ``portbench.peaks``) over the
kernel's mean device time a launch in the traced slice.

Frozen counts at the served 384x192 grid: 74 bytes a cell for the call and
201 operations a cell for one plain step (``peaks.lbm_call_bytes``,
``peaks.lbm_step_ops``), so 5,455,872 bytes and 14,819,328 operations a
step: the bound is 1.6286 us, set by the bytes.
"""

from portbench import peaks

KERNEL = "lbm_resident_kernel"
BYTES_PER_CELL = 74
OPS_PER_CELL_STEP = 201


def read(ctx):
    if ctx.trace is None:
        return None
    times = ctx.trace.kernel_us(KERNEL)
    if not times:
        return None
    lat = ctx.config["lattice"]
    cells = lat["nx"] * lat["ny"]
    bound = peaks.bound_s(BYTES_PER_CELL * cells,
                          OPS_PER_CELL_STEP * cells * lat["steps_per_frame"])
    return 100.0 * bound / (sum(times) / len(times) / 1e6)
