"""The one generator of federated LM rounds: each round's token batches and
the satellites' visibility, from a cell's traffic parameters and the
seed. Every seed gives the same sizes; only the values differ."""
from __future__ import annotations

import numpy as np
import torch

from chipbench.inputs.weights import stream_seed


def lm_tokens(wl: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """``(sets, sats, batch, seq + 1)`` int64 token ids, uniform over the
    vocabulary, drawn on the device: a round's inputs are ``[..., :-1]``
    and its next-token labels ``[..., 1:]``. Every satellite's rows
    differ."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    shape = (wl["sets"], wl["sats"], wl["batch_per_sat"], wl["seq"] + 1)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def visibility(wl: dict, seed: int) -> np.ndarray:
    """``(sets, sats)`` bool: each satellite sees its HAP with probability
    ``visibility``, and every orbit has at least one that does (so every
    round folds)."""
    rng = np.random.default_rng(stream_seed(seed, 2))
    k = wl["sats"] // wl["orbits"]
    out = rng.random((wl["sets"], wl["sats"])) < wl["visibility"]
    for r in range(wl["sets"]):
        for orbit in range(wl["orbits"]):
            if not out[r, orbit * k:(orbit + 1) * k].any():
                out[r, orbit * k + rng.integers(k)] = True
    return out
