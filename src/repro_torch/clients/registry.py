"""Dataset registry: one entry point over the procedural datasets.

Copy of ``repro.clients.registry`` with only ``digits`` registered (the
``tokens`` and ``synthetic_eo`` loaders come with the slices that need
them, ROADMAP Queue A item 1):

    x, y = load_dataset("digits", num_samples=70_000, seed=0)

Every registered loader returns ``(x, y)`` with ``x`` a float32/int32
array whose leading dim is the sample axis and ``y`` int32 class
labels — the shape the partitioner registry and ``FederatedData``
consume.  Specs may carry inline overrides, ``"name:num_samples"``
(e.g. ``"digits:4000"``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.data.digits import make_digits_dataset

DatasetFn = Callable[..., tuple[np.ndarray, np.ndarray]]

_DATASETS: dict[str, DatasetFn] = {}


def register_dataset(name: str) -> Callable[[DatasetFn], DatasetFn]:
    """Decorator registering ``fn(num_samples, seed, **kw) -> (x, y)``."""
    def deco(fn: DatasetFn) -> DatasetFn:
        if name in _DATASETS:
            raise ValueError(f"dataset {name!r} already registered")
        _DATASETS[name] = fn
        return fn
    return deco


def available_datasets() -> list[str]:
    return sorted(_DATASETS)


def get_dataset(name: str) -> DatasetFn:
    try:
        return _DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; available: {available_datasets()}"
        ) from None


def load_dataset(
    spec: str, *, num_samples: int | None = None, seed: int = 0, **kw
) -> tuple[np.ndarray, np.ndarray]:
    """Resolve ``"name"`` or ``"name:num_samples"`` and build the arrays."""
    name, _, inline = spec.partition(":")
    if inline:
        num_samples = int(inline)
    fn = get_dataset(name)
    if num_samples is not None:
        kw["num_samples"] = num_samples
    return fn(seed=seed, **kw)


@register_dataset("digits")
def _digits(num_samples: int = 70_000, seed: int = 0,
            **kw) -> tuple[np.ndarray, np.ndarray]:
    return make_digits_dataset(num_samples=num_samples, seed=seed, **kw)
