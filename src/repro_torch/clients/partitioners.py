"""Partitioner registry: dataset -> per-client index sets.

Puts the paper's IID / orbit-keyed splits and the standard FL non-IID
families behind one interface:

    parts = partition("dirichlet:0.3", labels, num_clients=1000, seed=0)

Registered partitioners (specs parse ``name[:param]``):

- ``iid``            — equal random split (``partition_iid``).
- ``orbit``          — the paper's orbit-keyed class-group split
  (``partition_noniid_by_orbit``; needs ``num_orbits``/
  ``sats_per_orbit`` kwargs, optional ``orbit_shells``).
- ``dirichlet[:a]``  — per-class proportions drawn from Dirichlet(a)
  over clients (default a=0.5).  a -> inf approaches IID; a -> 0
  concentrates each class on a single client.
- ``shards[:k]``     — sort-by-label, cut into ``k * num_clients``
  equal shards, deal ``k`` random shards per client (default k=2, the
  classic FedAvg MNIST split).

Every partitioner returns ``list[np.ndarray]`` of sorted global sample
indices, one per client (possibly empty for extreme Dirichlet draws),
and is deterministic given ``seed``.  ``label_histograms`` gives the
per-client class counts used for introspection and tests.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.data.partition import partition_iid, partition_noniid_by_orbit

PartitionFn = Callable[..., "list[np.ndarray]"]

_PARTITIONERS: dict[str, PartitionFn] = {}

# Per-registered-name parser for the inline ``name:param`` argument.
_INLINE_KW: dict[str, tuple[str, Callable[[str], object]]] = {}


def register_partitioner(
    name: str, inline: tuple[str, Callable[[str], object]] | None = None
) -> Callable[[PartitionFn], PartitionFn]:
    """Decorator registering ``fn(labels, num_clients, seed, **kw)``.

    ``inline=("alpha", float)`` maps the optional ``name:param`` spec
    suffix onto a keyword argument.
    """
    def deco(fn: PartitionFn) -> PartitionFn:
        if name in _PARTITIONERS:
            raise ValueError(f"partitioner {name!r} already registered")
        _PARTITIONERS[name] = fn
        if inline is not None:
            _INLINE_KW[name] = inline
        return fn
    return deco


def available_partitioners() -> list[str]:
    return sorted(_PARTITIONERS)


def get_partitioner(spec: str) -> tuple[PartitionFn, dict]:
    """``"dirichlet:0.3"`` -> (fn, {"alpha": 0.3})."""
    name, _, inline = spec.partition(":")
    try:
        fn = _PARTITIONERS[name]
    except KeyError:
        raise KeyError(
            f"unknown partitioner {name!r}; "
            f"available: {available_partitioners()}") from None
    kw: dict = {}
    if inline:
        if name not in _INLINE_KW:
            raise ValueError(
                f"partitioner {name!r} takes no inline argument "
                f"(got spec {spec!r})")
        key, conv = _INLINE_KW[name]
        kw[key] = conv(inline)
    return fn, kw


def partition(
    spec: str, labels: np.ndarray, num_clients: int, seed: int = 0, **kw
) -> list[np.ndarray]:
    """Resolve ``spec`` and partition ``labels`` into client index sets."""
    fn, inline_kw = get_partitioner(spec)
    return fn(labels, num_clients, seed=seed, **{**inline_kw, **kw})


def label_histograms(
    labels: np.ndarray,
    parts: list[np.ndarray],
    num_classes: int | None = None,
) -> np.ndarray:
    """Per-client class counts, ``(num_clients, num_classes)`` int64.

    Rows sum to the client shard sizes; the column sums over all rows
    recover the global class counts when the partition is exhaustive.
    """
    labels = np.asarray(labels)
    if num_classes is None:
        num_classes = int(labels.max()) + 1 if len(labels) else 1
    out = np.zeros((len(parts), num_classes), dtype=np.int64)
    for c, ix in enumerate(parts):
        if len(ix):
            out[c] = np.bincount(labels[ix], minlength=num_classes)
    return out


@register_partitioner("iid")
def _iid(labels: np.ndarray, num_clients: int,
         seed: int = 0) -> list[np.ndarray]:
    return partition_iid(labels, num_clients, seed=seed)


@register_partitioner("orbit")
def _orbit(labels: np.ndarray, num_clients: int, seed: int = 0, *,
           num_orbits: int, sats_per_orbit: int,
           orbit_shells: np.ndarray | None = None,
           **kw) -> list[np.ndarray]:
    if num_clients != num_orbits * sats_per_orbit:
        raise ValueError(
            f"orbit partitioner needs num_clients == num_orbits * "
            f"sats_per_orbit ({num_orbits}x{sats_per_orbit} != "
            f"{num_clients})")
    return partition_noniid_by_orbit(
        labels, num_orbits, sats_per_orbit, seed=seed,
        orbit_shells=orbit_shells, **kw)


@register_partitioner("dirichlet", inline=("alpha", float))
def _dirichlet(labels: np.ndarray, num_clients: int, seed: int = 0, *,
               alpha: float = 0.5) -> list[np.ndarray]:
    if alpha <= 0:
        raise ValueError(f"alpha must be positive, got {alpha}")
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    buckets: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
    for cls in np.unique(labels):
        idx = np.nonzero(labels == cls)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = np.floor(np.cumsum(props)[:-1] * len(idx)).astype(np.int64)
        for c, piece in enumerate(np.split(idx, cuts)):
            buckets[c].append(piece)
    return [
        np.sort(np.concatenate(b)) if b else np.empty(0, dtype=np.int64)
        for b in buckets
    ]


@register_partitioner("shards", inline=("shards_per_client", int))
def _shards(labels: np.ndarray, num_clients: int, seed: int = 0, *,
            shards_per_client: int = 2) -> list[np.ndarray]:
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    # Sort by label with a random tiebreak so equal labels shuffle.
    order = np.lexsort((rng.permutation(len(labels)), labels))
    n_shards = num_clients * shards_per_client
    if n_shards > len(labels):
        raise ValueError(
            f"{n_shards} shards requested from {len(labels)} samples")
    shards = np.array_split(order, n_shards)
    deal = rng.permutation(n_shards)
    return [
        np.sort(np.concatenate(
            [shards[s] for s in deal[c::num_clients]]))
        for c in range(num_clients)
    ]
