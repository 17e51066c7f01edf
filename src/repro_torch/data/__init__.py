"""Data pipeline: procedural datasets, federated partitioning, loaders."""
from repro_torch.data.digits import make_digits_dataset, render_digit
from repro_torch.data.eo import make_eo_dataset, make_eo_dataset_with_latitude
from repro_torch.data.partition import partition_iid, partition_noniid_by_orbit
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset
from repro_torch.data.loader import BatchIterator, FederatedData

__all__ = [
    "make_digits_dataset", "render_digit",
    "make_eo_dataset", "make_eo_dataset_with_latitude",
    "partition_iid", "partition_noniid_by_orbit",
    "TokenTaskConfig", "make_token_dataset",
    "BatchIterator", "FederatedData",
]
