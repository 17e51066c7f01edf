"""Share of the traced window in which no operation ran on the device,
in %."""


def read(ctx):
    if ctx.kind != "sim" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
