"""Runtime debugging/sanitizing utilities (see
:mod:`repro_torch.debug.sanitize`)."""
from repro_torch.debug.sanitize import (
    DtypePromotionError,
    ImplicitTransferError,
    RankPromotionError,
    RetraceDetector,
    RetraceError,
    compile_counts,
    explicit_transfer,
    sanitized,
    sanitized_run,
    to_device,
    to_host,
)

__all__ = [
    "DtypePromotionError",
    "ImplicitTransferError",
    "RankPromotionError",
    "RetraceDetector",
    "RetraceError",
    "compile_counts",
    "explicit_transfer",
    "sanitized",
    "sanitized_run",
    "to_device",
    "to_host",
]
