"""Client plane: datasets (``digits``, ``tokens``, ``synthetic_eo``),
partitioners, virtual clients (numpy copies of ``repro.clients``)."""
from repro_torch.clients.registry import (available_datasets, get_dataset,
                                          load_dataset, register_dataset)
from repro_torch.clients.partitioners import (available_partitioners,
                                              get_partitioner,
                                              label_histograms, partition,
                                              register_partitioner)
from repro_torch.clients.plane import (ClientPlane, GeoPlane, SampledPlane,
                                       StaticPlane, VirtualClients,
                                       build_plane, first_crossing_table,
                                       region_grid)

__all__ = [
    "available_datasets", "get_dataset", "load_dataset",
    "register_dataset",
    "available_partitioners", "get_partitioner", "label_histograms",
    "partition", "register_partitioner",
    "ClientPlane", "GeoPlane", "SampledPlane", "StaticPlane",
    "VirtualClients", "build_plane", "first_crossing_table",
    "region_grid",
]
