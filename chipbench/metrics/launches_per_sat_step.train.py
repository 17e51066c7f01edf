"""Device operations (kernels, copies, fills) launched per satellite
step in the traced rounds: the round driver's and the model step's
launch count, whose host cost paces a round where the device waits."""


def read(ctx):
    if ctx.kind != "train" or not ctx.sat_steps:
        return None
    return len(ctx.trace.device_ops) / ctx.sat_steps
