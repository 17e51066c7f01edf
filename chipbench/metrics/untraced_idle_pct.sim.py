"""Share of the traced window in which the device sat idle while the
host was in none of the program's ``sim.build``, ``sim.plan`` and
``sim.block`` spans (``device_idle_pct.sim`` less the two that read
them), in %."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "sim":
        return None
    return _spans.untraced_pct(ctx.trace,
                               ("sim.build", "sim.plan", "sim.block"))
