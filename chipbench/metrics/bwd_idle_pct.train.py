"""Share of the traced window in which the device sat idle while the
host was inside a satellite step's backward (the program's
``fed.backward`` span around ``torch.autograd.grad``), in %."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return _spans.idle_in_pct(ctx.trace, ("fed.backward",))
