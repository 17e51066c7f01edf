"""Host time of the plan a planned round: the program's ``sim.plan``
spans in the traced window (the plan-ahead loop, the sample indices and
the schedule arrays of a block) summed, over the rounds they planned
(their ``rounds``), in ms."""
from chipbench.metrics import _spans


def read(ctx):
    if ctx.kind != "sim":
        return None
    spans = _spans.program_spans(ctx.trace, ("sim.plan",))
    if spans is None:
        return None
    rounds = sum(s.attrs.get("rounds", 0) for s in spans)
    if not rounds:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / rounds
