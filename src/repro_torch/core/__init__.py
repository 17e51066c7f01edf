"""FedHAP core of the port: the Eq. 14-16 weights engine (numpy), the
Eq. 14-16 aggregation API on param trees, and the tensor tree
arithmetic of the execute phase.

- `weights`: the closed-form Eq. 14-16 weights engine (batched numpy) —
  the single source of truth for every aggregation path.
- `aggregation`: Eq. 14 partial aggregation (paper recursion + exact
  running-mean correction), Eq. 15 dedup set cover, Eq. 16 full
  aggregation; per-orbit weight API wrapping `weights`.
- `treeops`: tensor-dict arithmetic (scale/add/sub/combine).
- `strategies`: the paper's Table II setups over `repro_torch.sim`.
- `dissemination`: `ConstellationMeshMap` (orbit-major satellite layout,
  ring permutations) and the HAP chains.
- `mesh_round`: `FedRoundConfig`; the mesh rounds (`build_round`,
  `sharded_fold`) raise until the multi-device port (ROADMAP Queue A
  item 12).
- `fed_step`: `FedTrainConfig`, `satellite_loss`, `stack_params` /
  `unstack_params`; the mesh train step waits on item 12, and
  `repro_torch.launch.train.single_device_round` is the one-device step.

`fed_step` imports the model stack, so it is imported by path, not
from this package (the kernels import `core.treeops`).
"""
from repro_torch.core.aggregation import (
    chain_weights,
    dedup_set_cover,
    full_aggregate,
    partial_aggregate,
    segment_upload_weights,
)
from repro_torch.core.weights import (
    chain_stats,
    mu_from_chain,
    mu_weights,
    segment_ends,
)

__all__ = [
    "chain_weights", "dedup_set_cover", "full_aggregate",
    "partial_aggregate", "segment_upload_weights",
    "chain_stats", "mu_from_chain", "mu_weights", "segment_ends",
]
