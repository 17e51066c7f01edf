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

The JAX package's `mesh_round` and `dissemination` wait on the
multi-device port (ROADMAP Queue A item 12).
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
