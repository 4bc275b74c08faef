"""Lattice-site updates answered over the window, in millions a second: the
grid's cells times the steps that each session's replies' ``step`` counter
advanced (from the step before its first frame in the window to its last),
over the window's length."""


def read(ctx):
    lat = ctx.config["lattice"]
    steps: dict = {}
    for r in ctx.requests:
        if r.route == "/lbm/frame" and r.reply is not None:
            steps.setdefault(r.client, []).append(r.reply["step"])
    if not steps:
        return None
    advanced = sum(s[-1] - s[0] + lat["steps_per_frame"]
                   for s in steps.values())
    return lat["nx"] * lat["ny"] * advanced / ctx.window_s / 1e6
