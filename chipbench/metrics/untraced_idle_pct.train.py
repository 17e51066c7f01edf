"""Share of the traced window in which the device sat idle while the
host was in no ``fed.round`` span of the program
(``device_idle_pct.train`` less the three that read the round's spans),
in %."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return _spans.untraced_pct(ctx.trace, ("fed.round",))
