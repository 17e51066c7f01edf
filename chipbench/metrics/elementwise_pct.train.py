"""Share of the device's time in a federated LM round spent in
elementwise, fill, copy and cast kernels (PyTorch's elementwise kernels
and copies, by name), in %."""
from chipbench.metrics import _names as names


def read(ctx):
    if ctx.kind != "train":
        return None
    total = ctx.trace.device_s()
    if total <= 0:
        return None
    return 100.0 * ctx.trace.device_s(
        lambda n: names.has(n, names.ELEMENTWISE)) / total
