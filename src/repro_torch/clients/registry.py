"""Dataset registry: one entry point over the procedural datasets.

Absorbs the ad-hoc ``data/digits.py`` / ``data/tokens.py`` /
``data/eo.py`` constructors behind ``register_dataset(name)`` so the
engine, benches, and client planes load supervised arrays through one
interface:

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
from repro_torch.data.eo import make_eo_dataset
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset

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


@register_dataset("tokens")
def _tokens(num_samples: int = 20_000, seed: int = 0, seq_len: int = 32,
            vocab_size: int = 4096,
            num_classes: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Next-token windows as a supervised task.

    ``x`` is ``(N, seq_len)`` int32 context windows over one generated
    stream; ``y`` is the following token bucketed into ``num_classes``
    (vocab-sized label spaces would starve the per-client histograms).
    """
    cfg = TokenTaskConfig(vocab_size=vocab_size, seed=seed)
    stream = make_token_dataset(num_samples + seq_len, cfg)
    windows = np.lib.stride_tricks.sliding_window_view(
        stream[:-1], seq_len)[:num_samples]
    nxt = stream[seq_len:seq_len + num_samples]
    y = (nxt.astype(np.int64) * num_classes // vocab_size).astype(np.int32)
    return np.ascontiguousarray(windows), y


@register_dataset("synthetic_eo")
def _synthetic_eo(num_samples: int = 20_000, seed: int = 0,
                  **kw) -> tuple[np.ndarray, np.ndarray]:
    return make_eo_dataset(num_samples=num_samples, seed=seed, **kw)
