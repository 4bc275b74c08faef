"""95th percentile of the ``/lbm/frame`` round trip over every frame of the
window, in milliseconds: the viewer's tail. A closed loop runs at its
capacity, so the tail follows the host's speed from run to run; the cell's
end-to-end metric is the rate, and the tail is read beside it."""

from portbench.stats import percentile


def read(ctx):
    times = [r.seconds for r in ctx.requests if r.route == "/lbm/frame"]
    return 1e3 * percentile(times, 95) if times else None
