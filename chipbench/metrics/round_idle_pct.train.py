"""Share of the traced window in which the device sat idle while the
host was inside a round (the program's ``fed.round`` span) but in no
forward or backward: the update, μ, the fold and the copy into the
rows, in %."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return _spans.idle_in_pct(ctx.trace, ("fed.round",),
                              outside=("fed.forward", "fed.backward"))
