"""Timeline strategy registry of the port.

Importing this package registers the ported FL-Satcom methods: so far
``fedhap``. The JAX package's other strategies raise
``NotImplementedError`` naming the ROADMAP item that ports them
(:data:`repro_torch.sim.strategies.base.NOT_PORTED`).
"""
from repro_torch.sim.strategies.base import (
    NOT_PORTED,
    RoundStrategy,
    RunState,
    Strategy,
    available_strategies,
    get_strategy,
    register_strategy,
)
# Built-in strategies self-register on import.
from repro_torch.sim.strategies.fedhap import FedHap, RoundPlan

STRATEGIES = ("fedhap",)

__all__ = [
    "NOT_PORTED", "RoundStrategy", "RunState", "Strategy",
    "available_strategies", "get_strategy", "register_strategy",
    "STRATEGIES", "FedHap", "RoundPlan",
]
