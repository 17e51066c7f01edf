"""FL-Satcom timeline simulator on PyTorch (port of ``repro.sim``)."""
from repro_torch.sim.engine import (
    RoundEngine,
    SatcomSimulator,
    SimConfig,
    SimResult,
)
from repro_torch.sim.executor import FusedExecutor
from repro_torch.sim.strategies import (
    STRATEGIES,
    Strategy,
    available_strategies,
    get_strategy,
    register_strategy,
)
from repro_torch.sim.trainer import LocalTrainer

__all__ = [
    "FusedExecutor", "LocalTrainer", "RoundEngine", "SatcomSimulator",
    "SimConfig", "SimResult", "STRATEGIES", "Strategy",
    "available_strategies", "get_strategy", "register_strategy",
]
