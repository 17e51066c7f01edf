"""Data pipeline: procedural digits, federated partitioning, loaders,
and the synthetic token streams of the LM zoo (``tokens``)."""
from repro_torch.data.digits import make_digits_dataset, render_digit
from repro_torch.data.partition import partition_iid, partition_noniid_by_orbit
from repro_torch.data.loader import BatchIterator, FederatedData
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset

__all__ = [
    "make_digits_dataset", "render_digit",
    "partition_iid", "partition_noniid_by_orbit",
    "BatchIterator", "FederatedData",
    "TokenTaskConfig", "make_token_dataset",
]
