"""Procedural synthetic Earth-observation dataset.

Multispectral patches for the geo-keyed client plane: each sample is a
small ``(patch, patch, bands)`` chip whose class is a land-cover-like
prototype (distinct per-band spectral signature plus a class-scaled
spatial texture).  Classes are drawn with latitude-correlated mixture
weights so that, when the virtual-client plane bins clients into
lat/lon regions, nearby regions share correlated label distributions —
the drift the geo-streaming acquisition is meant to exercise.

Fully procedural and deterministic given ``seed`` (the container is
offline, as with ``digits``/``tokens``).
"""
from __future__ import annotations

import numpy as np

PATCH = 16
BANDS = 4


def make_eo_dataset(
    num_samples: int = 20_000,
    seed: int = 0,
    num_classes: int = 8,
    noise: float = 0.05,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate ``(chips (N, 16, 16, 4) float32 in [0,1], labels (N,) int32)``.

    Each sample carries a latent latitude in [-60, 60] deg; class mixture
    weights vary smoothly with it (softmax over per-class latitude
    preferences), so sorting samples by their latent latitude yields a
    spatially coherent label field.  The latitudes themselves are
    returned by :func:`make_eo_dataset_with_latitude` for geo planes.
    """
    chips, labels, _ = make_eo_dataset_with_latitude(
        num_samples, seed=seed, num_classes=num_classes, noise=noise)
    return chips, labels


def make_eo_dataset_with_latitude(
    num_samples: int = 20_000,
    seed: int = 0,
    num_classes: int = 8,
    noise: float = 0.05,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like :func:`make_eo_dataset` but also returns per-sample latitudes."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60.0, 60.0, size=num_samples)
    # Class c prefers latitudes near its anchor; softmax of negative
    # squared distance gives smooth latitude-conditioned class weights.
    anchors = np.linspace(-55.0, 55.0, num_classes)
    logits = -((lat[:, None] - anchors[None, :]) / 25.0) ** 2
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    u = rng.random(num_samples)
    labels = (u[:, None] > np.cumsum(probs, axis=1)).sum(axis=1)
    labels = np.minimum(labels, num_classes - 1).astype(np.int32)

    # Per-class spectral prototype and texture scale (fixed by seed).
    proto = rng.uniform(0.15, 0.85, size=(num_classes, BANDS))
    tex_scale = rng.uniform(0.05, 0.25, size=num_classes)

    # Low-resolution correlated texture upsampled 4x, plus pixel noise.
    low = rng.normal(0.0, 1.0, size=(num_samples, PATCH // 4, PATCH // 4,
                                     BANDS)).astype(np.float32)
    tex = np.repeat(np.repeat(low, 4, axis=1), 4, axis=2)
    chips = proto[labels][:, None, None, :].astype(np.float32)
    chips = chips + tex * tex_scale[labels][:, None, None, None].astype(
        np.float32)
    if noise > 0:
        chips += rng.normal(0.0, noise, size=chips.shape).astype(np.float32)
    np.clip(chips, 0.0, 1.0, out=chips)
    return chips, labels, lat
