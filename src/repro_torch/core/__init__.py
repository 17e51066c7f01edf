"""FedHAP core of the port: the Eq. 14-16 weights engine (numpy) and the
tensor tree arithmetic of the execute phase."""
from repro_torch.core.weights import (
    chain_stats,
    mu_from_chain,
    mu_weights,
    segment_ends,
)

__all__ = ["chain_stats", "mu_from_chain", "mu_weights", "segment_ends"]
