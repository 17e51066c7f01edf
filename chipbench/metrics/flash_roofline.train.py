"""The flash attention pair's share of its roofline in the traced
rounds: Σ each call's bound over Σ the pair's device time, in %. A call's
bound is the larger of its FLOP at the bf16 peak and its bytes at HBM's
rate (``costs.flash_fwd_cost`` / ``flash_bwd_cost`` at the round's
shape); forward calls are counted by ``flash_fwd`` kernels (remat's
recomputed forwards included: they are calls the round makes), backward
calls by their ``flash_bwd_dq`` kernel."""
from chipbench import costs


def read(ctx):
    if ctx.kind != "train":
        return None
    tr, f = ctx.trace, ctx.flash
    fwd = tr.count(lambda n: "flash_fwd" in n)
    bwd = tr.count(lambda n: "flash_bwd_dq" in n)
    spent = tr.device_s(lambda n: "flash_fwd" in n or "flash_bwd" in n)
    if spent <= 0 or not (fwd or bwd):
        return None
    shape = (f["b"], f["h"], f["s"], f["d"], f["dv"], f["itemsize"])
    bound = (fwd * costs.bound_s(*costs.flash_fwd_cost(*shape),
                                 costs.BF16_FLOP_PER_S)
             + bwd * costs.bound_s(*costs.flash_bwd_cost(*shape),
                                   costs.BF16_FLOP_PER_S))
    return costs.pct(bound / spent)
