"""Checkpointing: flat-key npz arrays + a json manifest (port of
``repro.checkpoint.ckpt``, the same on-disk format).

A tree is a tensor or a (nested) dict of tensors. Keys are
the ``/``-joined dict paths, as the reference writes them: the port's
param keys are flat (``conv1_w``; an LM's ``layers/b0/mixer/wq``), so
``{"params": {"conv1_w": ...}}`` writes ``params/conv1_w`` on both
sides, and a checkpoint written by either package loads into the other
leaf for leaf. npz has no bfloat16: bf16 leaves are stored as their raw
``uint16`` bits and the manifest records the true dtype. The manifest's
``treedef`` is a description for readers; neither package's loader
reads it.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.debug.sanitize import explicit_transfer


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{"/"-joined path: leaf}`` of a nested dict tree."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    """The tensor's dtype as numpy names it (``float32``, ``bfloat16``)."""
    return str(t.dtype).removeprefix("torch.")


def _to_storable(t: torch.Tensor) -> np.ndarray:
    """Host numpy array of a tensor; bf16 as its ``uint16`` bits (an
    explicit download)."""
    with explicit_transfer():
        t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory: str | pathlib.Path, tree: Any, step: int,
                    metadata: Optional[dict] = None) -> pathlib.Path:
    """Write ``ckpt_{step:08d}.npz`` and its ``.json`` manifest under
    ``directory`` and point ``latest.json`` at them."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    path = d / f"ckpt_{step:08d}.npz"
    np.savez(path, **{k: _to_storable(v) for k, v in flat.items()})
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "treedef": f"repro_torch dict tree, {len(flat)} leaves",
        "metadata": metadata or {},
    }
    (d / f"ckpt_{step:08d}.json").write_text(json.dumps(manifest, indent=1))
    (d / "latest.json").write_text(json.dumps({"step": step}))
    return path


def _from_stored(arr: np.ndarray, dtype: Optional[str],
                 device: torch.device) -> torch.Tensor:
    """A stored array as a tensor on ``device`` (an explicit upload),
    bf16 viewed back from its bits through torch."""
    if dtype == "bfloat16":
        t = torch.as_tensor(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.as_tensor(arr)
    with explicit_transfer():
        return t.to(device)


def _rebuild(tree_like: Any, flat: dict, prefix: str = "") -> Any:
    if not isinstance(tree_like, Mapping):
        return flat[prefix]
    return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree_like.items()}


def load_checkpoint(directory: str | pathlib.Path, tree_like: Any,
                    step: Optional[int] = None) -> tuple[Any, dict]:
    """Rebuild a tree shaped like ``tree_like`` from the checkpoint at
    ``step`` (default: the latest). Leaves come back as tensors with the
    stored dtype, on the device of ``tree_like``'s leaf. Raises
    ``ValueError`` on a key or shape mismatch. Returns
    ``(tree, manifest)``."""
    d = pathlib.Path(directory)
    if step is None:
        step = json.loads((d / "latest.json").read_text())["step"]
    manifest = json.loads((d / f"ckpt_{step:08d}.json").read_text())
    flat_like = _flatten(tree_like)
    if sorted(flat_like) != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(flat_like)
        raise ValueError(f"checkpoint/tree key mismatch: {sorted(missing)}")
    flat = {}
    with np.load(d / f"ckpt_{step:08d}.npz") as data:
        for key, leaf in flat_like.items():
            arr = data[key]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(
                    f"{key}: shape {arr.shape} != expected "
                    f"{tuple(leaf.shape)}")
            flat[key] = _from_stored(arr, manifest["dtypes"].get(key),
                                     leaf.device)
    return _rebuild(tree_like, flat), manifest
