"""Share of the traced slice of the viewer's window in which no kernel,
copy or fill ran on the card, in percent."""


def read(ctx):
    return ctx.trace.idle_pct() if ctx.trace is not None else None
