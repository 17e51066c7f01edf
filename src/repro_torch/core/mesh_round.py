"""FedHAP's hierarchical round as mesh collectives (port of
``repro.core.mesh_round``): the round's configuration only.

The reference's rounds (``fedhap_round``, ``fedhap_round_fused``,
``fedavg_round``, built by ``build_round``) and ``sharded_fold`` run
under ``shard_map`` on a device mesh; their port to
``torch.distributed`` is ROADMAP Queue A item 12, and both entry points
raise until then. On one device the port's trainer folds the replicas
with the same closed-form weights (``repro_torch.launch.train``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.dissemination import ConstellationMeshMap

_MESH = ("the mesh rounds are not ported yet (ROADMAP Queue A item 12); "
         "on one device use repro_torch.launch.train.single_device_round")


@dataclasses.dataclass(frozen=True)
class FedRoundConfig:
    cmap: ConstellationMeshMap = ConstellationMeshMap()
    partial_mode: str = "paper"        # paper | exact   (Eq. 14 gamma)
    orbit_weighting: str = "paper"     # paper | global  (Eq. 16)
    hap_ring: bool = True              # faithful pod chain vs pod psum
    ship_global_echo: bool = True      # ring hops carry w^beta too (§III-B2)


def build_round(*args: Any, **kwargs: Any):
    """Raises: :data:`_MESH`."""
    raise NotImplementedError(f"build_round: {_MESH}")


def sharded_fold(*args: Any, **kwargs: Any):
    """Raises: :data:`_MESH`."""
    raise NotImplementedError(f"sharded_fold: {_MESH}")
