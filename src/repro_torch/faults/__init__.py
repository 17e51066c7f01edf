"""Seeded, fully deterministic fault-injection plane (see plane.py)."""
from repro_torch.faults.plane import (
    MAX_UPLOAD_RETRIES,
    FaultPlane,
    FaultSpec,
    parse_faults,
)

__all__ = ["FaultPlane", "FaultSpec", "parse_faults",
           "MAX_UPLOAD_RETRIES"]
