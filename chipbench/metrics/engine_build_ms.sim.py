"""Mean host time of ``RoundEngine(cfg)`` over the window's simulations
(the constellation, visibility and delay grids, the partition, the
trainer; the digits handed in), in ms."""


def read(ctx):
    if ctx.kind != "sim" or not ctx.build_s:
        return None
    return 1e3 * sum(ctx.build_s) / len(ctx.build_s)
