"""Timeline strategy registry of the port.

Importing this package registers the ported FL-Satcom methods: the round
family (fedhap | fedisl | fedisl_ideal | fedsink) and the routed cycle
family built on the ISL contact-graph router (fedhap_async |
fedhap_buffered), which shares the :class:`CycleStrategy` event
machinery from ``base``. The JAX package's other strategies raise
``NotImplementedError`` naming the ROADMAP item that ports them
(:data:`repro_torch.sim.strategies.base.NOT_PORTED`).
"""
from repro_torch.sim.strategies.base import (
    NOT_PORTED,
    AsyncFoldPlan,
    CycleStrategy,
    RoundStrategy,
    RunState,
    Strategy,
    available_strategies,
    get_strategy,
    register_strategy,
)
# Built-in strategies self-register on import.
from repro_torch.sim.strategies.fedhap import FedHap, RoundPlan
from repro_torch.sim.strategies.fedhap_async import FedHapAsync
from repro_torch.sim.strategies.fedhap_buffered import FedHapBuffered
from repro_torch.sim.strategies.fedisl import FedIsl
from repro_torch.sim.strategies.fedsink import FedSink, SinkRoundPlan

# The JAX package's order, without the strategies not ported yet.
STRATEGIES = ("fedhap", "fedisl", "fedisl_ideal", "fedsink", "fedhap_async",
              "fedhap_buffered")

__all__ = [
    "NOT_PORTED", "AsyncFoldPlan", "CycleStrategy", "RoundStrategy",
    "RunState", "Strategy", "available_strategies", "get_strategy",
    "register_strategy", "STRATEGIES",
    "FedHap", "RoundPlan", "FedHapAsync", "FedHapBuffered", "FedIsl",
    "FedSink", "SinkRoundPlan",
]
