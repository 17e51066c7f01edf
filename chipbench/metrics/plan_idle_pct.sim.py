"""Share of the traced window in which the device sat idle while the
host was inside the engine's build or the plan (the program's
``sim.build`` and ``sim.plan`` spans), in %."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "sim":
        return None
    return _spans.idle_in_pct(ctx.trace, ("sim.build", "sim.plan"))
