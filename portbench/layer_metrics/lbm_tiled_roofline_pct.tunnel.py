"""The tiled LBM kernel's share of its roofline, in percent: the least time
one ``steps_per_frame``-step call could take on the card (the lattice read
and written once and the cell word read once, or the plain step's float32
operations, whichever bounds it; ``portbench.peaks``) over the device time
of a call, which is the kernel's device time in the trace over the calls
that launched it (the program's ``lbm.step`` spans, one a call; a call
runs several launches, a few steps each).

Frozen counts: 74 bytes a cell for the call and 201 operations a cell for
one plain step (``peaks.lbm_call_bytes``, ``peaks.lbm_step_ops``). At
2048x1024 and 24 steps a call, 155,189,248 bytes (46.3 us) and
10,116,661,248 operations (151.0 us): the bound is 151.0 us, set by the
operations. The closed loop starts and stops the profiler between frames,
so every call in the trace has all its launches in it. None without a
trace, a launch of the kernel or a call.
"""

from portbench import peaks

KERNEL = "lbm_tiled_kernel"
SPAN = "lbm.step"
BYTES_PER_CELL = 74
OPS_PER_CELL_STEP = 201


def read(ctx):
    if ctx.trace is None:
        return None
    times = ctx.trace.kernel_us(KERNEL)
    calls = sum(name == SPAN for _, _, name in ctx.trace.host)
    if not times or not calls:
        return None
    lat = ctx.config["lattice"]
    cells = lat["nx"] * lat["ny"]
    bound = peaks.bound_s(BYTES_PER_CELL * cells,
                          OPS_PER_CELL_STEP * cells * lat["steps_per_frame"])
    return 100.0 * bound / (sum(times) / calls / 1e6)
