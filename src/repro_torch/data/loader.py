"""Batching and federated data containers."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


class BatchIterator:
    """Deterministic infinite shuffled mini-batch iterator over arrays.

    Mirrors the paper's per-satellite mini-batch SGD stream (batch 32).
    Reshuffles each epoch with a per-epoch PRNG stream.

    Shards smaller than one batch (common for virtual-client splits)
    are padded per epoch by sampling with replacement so every epoch
    still yields one full batch; only an empty dataset is an error.
    """

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        seed: int = 0,
        drop_remainder: bool = True,
    ) -> None:
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("arrays must share their leading dimension")
        if n == 0:
            raise ValueError("cannot batch an empty dataset")
        self._arrays = [np.asarray(a) for a in arrays]
        self._n = n
        self._bs = batch_size
        self._seed = seed
        self._drop = drop_remainder
        self._epoch = 0
        self._order = self._reshuffle()
        self._pos = 0

    def _reshuffle(self) -> np.ndarray:
        rng = np.random.default_rng((self._seed, self._epoch))
        order = rng.permutation(self._n)
        if self._drop and self._n < self._bs:
            pad = rng.integers(0, self._n, size=self._bs - self._n)
            order = np.concatenate([order, pad])
        return order

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        return self

    def __next__(self) -> tuple[np.ndarray, ...]:
        if self._pos + self._bs > len(self._order):
            self._epoch += 1
            self._order = self._reshuffle()
            self._pos = 0
        idx = self._order[self._pos : self._pos + self._bs]
        self._pos += self._bs
        return tuple(a[idx] for a in self._arrays)

    @property
    def epoch(self) -> int:
        return self._epoch

    def epoch_batches(self) -> int:
        if self._drop and self._n < self._bs:
            return 1
        return self._n // self._bs


@dataclasses.dataclass
class FederatedData:
    """Per-satellite views over a global dataset."""
    images: np.ndarray
    labels: np.ndarray
    client_indices: list[np.ndarray]
    _padded: np.ndarray | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _sizes: np.ndarray | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def client_sizes(self) -> np.ndarray:
        """n_k of Eq. 1 / m_k of Eq. 14, per satellite."""
        return np.array([len(ix) for ix in self.client_indices])

    def padded_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """Rectangular index view for batched sampling.

        Returns ``(padded, sizes)``: ``padded`` is ``(n_clients,
        max_shard)`` int64 with row c holding client c's global sample
        indices, tail padded with the row's first index (samplers must
        bound their draws by ``sizes`` — the padding is a harmless
        repeat for non-empty shards, and empty shards must be rejected
        before sampling). Built once and cached; lets one fancy-index
        gather sample mini-batch streams for every participating client
        at once.
        """
        if self._padded is None:
            sizes = self.client_sizes()
            padded = np.empty((len(self.client_indices), int(sizes.max())),
                              dtype=np.int64)
            for c, ix in enumerate(self.client_indices):
                padded[c, :len(ix)] = ix
                padded[c, len(ix):] = ix[0] if len(ix) else 0
            self._padded, self._sizes = padded, sizes
        return self._padded, self._sizes

    def client_iterator(
        self, client: int, batch_size: int, seed: int = 0
    ) -> BatchIterator:
        ix = self.client_indices[client]
        return BatchIterator(
            [self.images[ix], self.labels[ix]],
            batch_size=batch_size,
            seed=seed * 1_000_003 + client,
        )

    def client_arrays(self, client: int) -> tuple[np.ndarray, np.ndarray]:
        ix = self.client_indices[client]
        return self.images[ix], self.labels[ix]
