"""The digits the benchmark trains on: a frozen copy of the port's
procedural MNIST stand-in (``repro_torch/data/digits.py``), so that the
inputs stay the same whatever a later change does to the program's
renderer.

28x28 grayscale images of the ten digits rendered from stroke skeletons
with random affine jitter (rotation/scale/shift), stroke thickness
variation, and pixel noise; the paper's cardinality (70k) and class
structure.
"""
from __future__ import annotations

import numpy as np

IMG = 28

# Stroke skeletons per digit on a [0,1]^2 canvas (x right, y down).
# Each stroke is a polyline; digits follow seven-segment-like shapes with
# a few diagonals so all ten classes are geometrically distinct.
_L, _R, _T, _B, _M = 0.25, 0.75, 0.15, 0.85, 0.5
_STROKES: dict[int, list[list[tuple[float, float]]]] = {
    0: [[(_L, _T), (_R, _T), (_R, _B), (_L, _B), (_L, _T)]],
    1: [[(0.5, _T), (0.5, _B)], [(0.35, 0.3), (0.5, _T)]],
    2: [[(_L, _T), (_R, _T), (_R, _M), (_L, _B), (_R, _B)]],
    3: [[(_L, _T), (_R, _T), (_R, _M), (_L, _M)],
        [(_R, _M), (_R, _B), (_L, _B)]],
    4: [[(_L, _T), (_L, _M), (_R, _M)], [(_R, _T), (_R, _B)]],
    5: [[(_R, _T), (_L, _T), (_L, _M), (_R, _M), (_R, _B), (_L, _B)]],
    6: [[(_R, _T), (_L, _T), (_L, _B), (_R, _B), (_R, _M), (_L, _M)]],
    7: [[(_L, _T), (_R, _T), (0.4, _B)]],
    8: [[(_L, _T), (_R, _T), (_R, _B), (_L, _B), (_L, _T)],
        [(_L, _M), (_R, _M)]],
    9: [[(_R, _M), (_L, _M), (_L, _T), (_R, _T), (_R, _B), (_L, _B)]],
}

_POINTS_PER_UNIT = 60  # raster density along strokes


def _skeleton_points(digit: int) -> np.ndarray:
    """Dense (N, 2) point cloud along the digit's strokes, in [0,1]^2."""
    pts = []
    for stroke in _STROKES[digit]:
        for (x0, y0), (x1, y1) in zip(stroke, stroke[1:]):
            seg_len = float(np.hypot(x1 - x0, y1 - y0))
            n = max(2, int(seg_len * _POINTS_PER_UNIT))
            t = np.linspace(0.0, 1.0, n)
            pts.append(np.stack([x0 + (x1 - x0) * t, y0 + (y1 - y0) * t], -1))
    return np.concatenate(pts, axis=0)


_TEMPLATES = {d: _skeleton_points(d) for d in range(10)}


def _render_batch(
    digits: np.ndarray,
    rng: np.random.Generator,
    rot_deg: float = 12.0,
    scale_jitter: float = 0.12,
    shift_px: float = 2.0,
    noise: float = 0.08,
) -> np.ndarray:
    """Vectorized renderer for a batch of digit labels. (B, 28, 28)."""
    b = len(digits)
    imgs = np.zeros((b, IMG, IMG), dtype=np.float32)
    theta = np.radians(rng.uniform(-rot_deg, rot_deg, size=b))
    scale = 1.0 + rng.uniform(-scale_jitter, scale_jitter, size=b)
    shift = rng.uniform(-shift_px, shift_px, size=(b, 2))
    thick = rng.uniform(0.6, 1.3, size=b)
    for d in range(10):
        idx = np.nonzero(digits == d)[0]
        if idx.size == 0:
            continue
        pts = _TEMPLATES[d]  # (N, 2)
        # Center, rotate, scale, shift -> pixel coords.  (K, N, 2)
        centered = (pts - 0.5)[None, :, :] * scale[idx, None, None]
        c, s = np.cos(theta[idx]), np.sin(theta[idx])
        x = centered[..., 0] * c[:, None] - centered[..., 1] * s[:, None]
        y = centered[..., 0] * s[:, None] + centered[..., 1] * c[:, None]
        px = (x + 0.5) * (IMG - 1) + shift[idx, 0:1]
        py = (y + 0.5) * (IMG - 1) + shift[idx, 1:2]
        # Splat with stroke-thickness jitter: 4-neighbour bilinear deposit.
        jx = px + rng.normal(0.0, thick[idx][:, None], size=px.shape) * 0.45
        jy = py + rng.normal(0.0, thick[idx][:, None], size=py.shape) * 0.45
        x0 = np.floor(jx).astype(np.int64)
        y0 = np.floor(jy).astype(np.int64)
        fx = jx - x0
        fy = jy - y0
        kk = np.repeat(idx, pts.shape[0]).reshape(len(idx), pts.shape[0])
        for dx, dy, w in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            xi = np.clip(x0 + dx, 0, IMG - 1)
            yi = np.clip(y0 + dy, 0, IMG - 1)
            np.add.at(imgs, (kk.ravel(), yi.ravel(), xi.ravel()),
                      w.ravel().astype(np.float32))
    np.clip(imgs * 0.9, 0.0, 1.0, out=imgs)
    if noise > 0:
        imgs += rng.normal(0.0, noise, size=imgs.shape).astype(np.float32)
        np.clip(imgs, 0.0, 1.0, out=imgs)
    return imgs


def make_digits_dataset(
    num_samples: int = 70_000,
    seed: int = 0,
    noise: float = 0.08,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate the full dataset: (images (N,28,28) float32, labels (N,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=num_samples).astype(np.int32)
    images = np.zeros((num_samples, IMG, IMG), dtype=np.float32)
    chunk = 8192
    for i in range(0, num_samples, chunk):
        sl = slice(i, min(i + chunk, num_samples))
        images[sl] = _render_batch(labels[sl], rng, noise=noise)
    return images, labels
