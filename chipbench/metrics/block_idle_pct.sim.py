"""Share of the traced window in which the device sat idle while the
host was inside the block driver (the program's ``sim.block`` span:
``FusedExecutor.run_block``, its one readback included), in %."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "sim":
        return None
    return _spans.idle_in_pct(ctx.trace, ("sim.block",))
