"""The whole step's share of the card's peak: the model FLOP the
window's units did (the benchmark's own count, ``costs``), over the
window's time, against the peak of the arithmetic the step runs in
(bf16 for the LM rounds; f32 outside the tensor cores for the
simulation, whose executor turns TF32 off), in %."""
from chipbench import costs


def read(ctx):
    if ctx.kind != "sim" or ctx.elapsed <= 0:
        return None
    return costs.pct(ctx.model_flop / ctx.elapsed / ctx.peak_flop_per_s)
