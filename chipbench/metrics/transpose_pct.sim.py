"""Share of the device's time that the simulation spends in layout
transposes and copies (the grouped convolutions' NCHW/NHWC changes, the
replica-stacked flattens), by kernel name, in %."""
from chipbench.metrics import _names as names


def read(ctx):
    if ctx.kind != "sim":
        return None
    total = ctx.trace.device_s()
    if total <= 0:
        return None
    return 100.0 * ctx.trace.device_s(
        lambda n: names.has(n, names.TRANSPOSE)) / total
