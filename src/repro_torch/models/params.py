"""Parameter-definition trees (port of ``repro.models.params``).

A model describes its parameters once as a flat dict of `ParamDef`s
(shape + initializer); `init_params` materializes a ``dict[str, Tensor]``
on an explicit device from an explicit ``torch.Generator``. Keys, shapes
and layouts match the JAX package leaf for leaf (conv weights stay HWIO),
so folds and parity tests line up. Where the JAX package nests its tree
(the LM's ``{"layers": {"b0": {"mixer": {"wq": ...}}}}``), the port's key
is the ``/``-joined path, as the checkpoint format writes it
(``repro/checkpoint/ckpt.py``): ``layers/b0/mixer/wq``.

The port's initializer cannot reproduce ``jax.random`` draws, so runs
that must start where the JAX package starts carry its params over as
numpy arrays: :func:`params_from_numpy` / :func:`params_to_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter tensor: shape, init scheme and the mesh axis each dim
    is partitioned over (``None``: replicated), as the JAX package's
    ``ParamDef.axes``."""
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | constant | s4d_a_log
    scale: float | None = None  # stddev for normal; fan-in default if None
    axes: tuple[str | None, ...] | None = None  # partition axis per dim

    def pspec(self) -> tuple:
        """The partition spec as a tuple of axis names (``None`` for a
        replicated dim): torch has no ``PartitionSpec``, a tuple stands in
        for it."""
        if self.axes is None:
            return (None,) * len(self.shape)
        assert len(self.axes) == len(self.shape), (self.axes, self.shape)
        return tuple(self.axes)


#: The largest f32 draw of a leaf made in one piece (bytes).
DRAW_BYTES = 1 << 26


def _row_blocks(shape: tuple[int, ...]) -> list[slice]:
    """Blocks of rows along the first axis of a leaf of two or more dims
    whose f32 draw exceeds :data:`DRAW_BYTES`, each drawn in one piece: as
    many rows as fit (at least one), rounded up to a multiple of 16
    elements, the last block taking any remainder under 16 elements. The
    CPU generator fills normals 16 at a time, so on the CPU such blocks
    draw what one call over the leaf draws: a seed gives the same
    weights."""
    n, row = shape[0], math.prod(shape[1:])
    unit = 16 // math.gcd(row, 16)
    step = -(-max(1, DRAW_BYTES // (4 * row)) // unit) * unit
    starts = list(range(0, n, step))
    if len(starts) > 1 and (n - starts[-1]) * row < 16:
        starts.pop()
    return [slice(i, j) for i, j in zip(starts, starts[1:] + [n])]


def _init_leaf(d: ParamDef, gen: torch.Generator, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        scale = d.scale
        if scale is None:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        # Draw on the generator's device, then move: the same seed gives
        # the same weights on every device. A leaf over DRAW_BYTES of f32
        # is drawn in blocks of rows along its first axis, each cast as it
        # goes, so its f32 draw never exists whole (a stacked leaf of
        # deepseek-coder-33b is 34 GB in f32).
        if len(d.shape) < 2 or 4 * math.prod(d.shape) <= DRAW_BYTES:
            x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=gen.device)
            return (scale * x).to(device=device, dtype=dtype)
        out = torch.empty(d.shape, dtype=dtype, device=device)
        for rows in _row_blocks(d.shape):
            x = torch.randn((rows.stop - rows.start,) + d.shape[1:],
                            generator=gen, dtype=torch.float32,
                            device=gen.device)
            out[rows] = (scale * x).to(device=device, dtype=dtype)
        return out
    if d.init == "constant":
        return torch.full(d.shape, d.scale or 0.0, dtype=dtype,
                          device=device)
    if d.init == "s4d_a_log":
        # S4D-real: A_log[c, n] = log(n + 1); broadcast over channels.
        n = d.shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(d.shape).to(dtype).contiguous()
    raise ValueError(f"unknown init {d.init}")


def init_params(defs: Mapping[str, ParamDef], gen: torch.Generator,
                device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> dict:
    """Materialize a ParamDef dict, drawing leaves in key order."""
    device = torch.device(device)
    return {k: _init_leaf(d, gen, device, dtype) for k, d in defs.items()}


def param_count(tree: Mapping[str, Any]) -> int:
    """Total element count of a ParamDef or tensor dict."""
    return sum(int(np.prod(v.shape)) if len(v.shape) else 1
               for v in tree.values())


def flatten_defs(tree: Mapping[str, Any], prefix: str = "") -> dict:
    """A nested dict (of ParamDefs, arrays or tensors) as a flat dict with
    ``/``-joined keys, in the dicts' own order (a JAX param tree comes
    with its keys sorted at every level, as ``jax.tree.flatten`` visits
    them). A flat dict comes back unchanged."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_defs(v, key + "/"))
        else:
            out[key] = v
    return out


def param_specs(defs: Mapping[str, ParamDef],
                prefix: tuple = ()) -> dict:
    """Per leaf, its partition spec as a tuple (:meth:`ParamDef.pspec`)
    with ``prefix`` prepended (e.g. the satellite replica dim sharded over
    ``"data"``); keys as ``defs``'."""
    return {k: (*prefix, *d.pspec()) for k, d in flatten_defs(defs).items()}


def add_leading_axis(tree: Mapping[str, Any], n: int) -> dict:
    """Prepend a dimension of size ``n`` (e.g. layers) to every ParamDef of
    a (nested or flat) dict; returned flat. The new dim is unsharded."""
    return {k: ParamDef((n,) + d.shape, d.init, d.scale,
                        (None,) + tuple(d.axes or [None] * len(d.shape)))
            for k, d in flatten_defs(tree).items()}


def _leaf_to_tensor(v: Any) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from ml_dtypes (what np.asarray of a JAX
        # bf16 array yields); torch.from_numpy refuses it. The 16 bits
        # cross over as int16 and are reinterpreted, bit for bit.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: Mapping[str, Any],
                      device: torch.device | str) -> dict:
    """The weight carry-over: a param tree of numpy arrays (e.g. the JAX
    package's params, flat or nested, exported leaf by leaf) as the
    port's flat ``dict[str, Tensor]`` on ``device``. Dtypes (bfloat16
    included, bit for bit) and layouts are kept; nested keys are joined
    with ``/`` (:func:`flatten_defs`)."""
    return {k: _leaf_to_tensor(v).to(device)
            for k, v in flatten_defs(tree).items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_numpy`: host numpy copies, flat; a
    bfloat16 tensor comes back as numpy's ``bfloat16`` (ml_dtypes), bit
    for bit."""
    out = {}
    for k, v in params.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            import ml_dtypes
            out[k] = v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = v.numpy()
    return out
