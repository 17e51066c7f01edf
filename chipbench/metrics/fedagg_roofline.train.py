"""The fold kernel's (``fedagg``) share of its roofline in the traced
window: launches times one fold's bound (its bytes at HBM's rate, or its
f32 FLOP outside the tensor cores, the larger; ``costs.fold_cost`` at
the cell's satellites and parameters) over the kernel's device time, in
%."""
from chipbench import costs


def read(ctx):
    if ctx.kind != "train":
        return None
    tr, f = ctx.trace, ctx.fold
    launches = tr.count(lambda n: "fedagg" in n)
    spent = tr.device_s(lambda n: "fedagg" in n)
    if not launches or spent <= 0:
        return None
    one = costs.bound_s(*costs.fold_cost(f["s"], f["p"], f["itemsize"]),
                        costs.F32_FLOP_PER_S)
    return costs.pct(launches * one / spent)
