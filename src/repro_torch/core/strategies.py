"""Timeline-level FL strategies (paper baselines) — stable import
surface (port of ``repro.core.strategies``).

The simulator is a strategy registry on a shared engine:

- ``repro_torch.core.weights`` is the single source of truth for the
  Eq. 14-16 closed-form aggregation weights (numpy, the plan phase).
- ``repro_torch.sim.engine.RoundEngine`` owns the physical world, the
  round loop, the next-contact tables, the fold (the ``fedagg`` kernel
  on the card) and the route/sink caches of the ISL routing substrate
  (``repro_torch.orbits.routing``).
- Each method below is a small class registered in
  ``repro_torch.sim.strategies`` supplying only its scheduling and
  weighting rules; ``SimConfig.strategy`` resolves through
  :func:`get_strategy`.

Mapping to the paper's Table II rows:

| strategy        | paper row            | PS setup                  |
|-----------------|----------------------|---------------------------|
| fedhap          | FedHAP-oneHAP/twoHAP | HAP(s), arbitrary location|
| fedhap + gs     | FedHAP-GS            | GS, arbitrary location    |
| fedisl          | FedISL               | GS, arbitrary location    |
| fedisl_ideal    | FedISL (ideal)       | MEO PS above the equator  |
| fedsat          | FedSat (ideal)       | GS at the North Pole      |
| fedspace        | FedSpace             | GS, arbitrary location    |

Beyond the paper's rows, the routed sink-scheduling family (successor
work, Elmahallawy & Luo arXiv:2302.13447) rides the same registry:
``fedsink``, ``fedhap_async`` and ``fedhap_buffered``.

The setups below are ``SimConfig``s with the default device
(``"cuda"``): building one touches no device; a ``RoundEngine`` built
from one needs the card (``dataclasses.replace(cfg, device="cpu")``
otherwise).
"""
from repro_torch.sim.engine import (
    RoundEngine, SatcomSimulator, SimConfig, SimResult)
from repro_torch.sim.strategies import (
    STRATEGIES,
    Strategy,
    available_strategies,
    get_strategy,
    register_strategy,
)

# Station setups used by the paper's experiments.
TABLE2_SETUPS: dict[str, SimConfig] = {
    "FedISL": SimConfig(strategy="fedisl", stations="gs"),
    "FedISL (ideal)": SimConfig(strategy="fedisl_ideal", stations="meo"),
    "FedSat (ideal)": SimConfig(strategy="fedsat", stations="gs_np"),
    "FedSpace": SimConfig(strategy="fedspace", stations="gs"),
    "FedHAP-GS": SimConfig(strategy="fedhap", stations="gs"),
    "FedHAP-oneHAP": SimConfig(strategy="fedhap", stations="one_hap"),
    "FedHAP-twoHAP": SimConfig(strategy="fedhap", stations="two_hap"),
}

__all__ = [
    "RoundEngine", "SatcomSimulator", "SimConfig", "SimResult",
    "Strategy", "STRATEGIES", "TABLE2_SETUPS",
    "available_strategies", "get_strategy", "register_strategy",
]
