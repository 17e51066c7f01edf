"""Kernel-name classes the per-layer readers share (the benchmark's own,
matched on the names the profiler gives the device's operations)."""

TRANSPOSE = ("transpose", "Transpose", "nchwTo", "nhwcTo", "ToNchw",
             "ToNhwc", "permute", "copy", "Copy")
ELEMENTWISE = ("elementwise_kernel", "Fill", "fill", "copy", "Copy", "cast",
               "Cast")


def has(name: str, marks: tuple) -> bool:
    return any(m in name for m in marks)
