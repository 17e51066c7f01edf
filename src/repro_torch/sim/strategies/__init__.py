"""Timeline strategy registry of the port.

Importing this package registers the FL-Satcom methods: the round family
(fedhap | fedisl | fedisl_ideal | fedsink), the tick baselines (fedsat |
fedspace) and the routed cycle family built on the ISL contact-graph
router (fedhap_async | fedhap_buffered), which shares the
:class:`CycleStrategy` event machinery from ``base``.
"""
from repro_torch.sim.strategies.base import (
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
from repro_torch.sim.strategies.fedsat import FedSat
from repro_torch.sim.strategies.fedsink import FedSink, SinkRoundPlan
from repro_torch.sim.strategies.fedspace import FedSpace

STRATEGIES = ("fedhap", "fedisl", "fedisl_ideal", "fedsat", "fedspace",
              "fedsink", "fedhap_async", "fedhap_buffered")

__all__ = [
    "AsyncFoldPlan", "CycleStrategy", "RoundStrategy", "RunState",
    "Strategy", "available_strategies", "get_strategy",
    "register_strategy", "STRATEGIES",
    "FedHap", "RoundPlan", "FedHapAsync", "FedHapBuffered", "FedIsl",
    "FedSat", "FedSink", "SinkRoundPlan", "FedSpace",
]
