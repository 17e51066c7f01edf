"""Data pipeline: procedural digits, federated partitioning, loaders."""
from repro_torch.data.digits import make_digits_dataset, render_digit
from repro_torch.data.partition import partition_iid, partition_noniid_by_orbit
from repro_torch.data.loader import BatchIterator, FederatedData

__all__ = [
    "make_digits_dataset", "render_digit",
    "partition_iid", "partition_noniid_by_orbit",
    "BatchIterator", "FederatedData",
]
