"""Runtime sanitizer for the fused plan/execute simulator (port of
``repro.debug.sanitize``).

The static pass (``tools.fedlint``) rejects invariant-breaking *code*;
this module catches the dynamic escapes it cannot see:

* :func:`sanitized` — a context that runs the fused block loop under the
  PyTorch counterparts of the reference's three jax guards:

  - ``transfer="disallow"`` (``jax.transfer_guard``): no implicit
    host<->device transfer. On CUDA, ``torch.cuda.set_sync_debug_mode
    ("error")`` makes every synchronizing CUDA call raise: ``.item()``,
    a blocking copy to or from the card, ``nonzero``. On every device a
    ``TorchDispatchMode`` refuses the ops that read a device value on
    the host (``aten._local_scalar_dense``: ``.item()``, ``float(t)``,
    ``bool(t)``; ``aten.is_nonzero``, ``aten.nonzero``,
    ``masked_select``, ``equal``, and boolean-mask indexing, which runs
    ``nonzero``), so the CPU tests see the faults the card would.
    Deliberate copies go through :func:`to_device` / :func:`to_host`
    (the counterparts of ``jnp.asarray`` / ``np.asarray``), whose
    :func:`explicit_transfer` scope relaxes the sync mode for that one
    copy;
  - ``dtype_promotion="strict"`` (``jax.numpy_dtype_promotion``): no op
    may yield a float64 tensor (the FHL005 invariant; a float64 upload
    raises too), and no pointwise op (``torch.Tag.pointwise``) may mix
    tensor dtypes. Python scalars are weak and allowed; the index
    tensors of gather and index ops are not pointwise and are not
    checked; the mask of ``where`` / ``masked_fill`` is not a value;
  - ``rank_promotion="raise"`` (``jax.numpy_rank_promotion``): a
    pointwise op whose tensor inputs of rank >= 1 differ in rank raises;
    rank-0 tensors are exempt, as in jax.

* :class:`RetraceDetector` and :func:`compile_counts` — the reference's
  compile budget per ``(kind, block-shape)`` entry of the executor's
  ``_jit`` cache. The port's executor runs eagerly and caches no
  compiled program, so today the counts are ``{}`` and the budget holds
  trivially; it gains meaning once a CUDA graph of a block lands
  (ROADMAP Queue B, "Beyond the four kernels").

* :func:`sanitized_run` — the one-call harness: build an engine, run the
  fused driver inside :func:`sanitized` through the engine's
  ``_fused_cm`` hook, and fail on any retrace over budget.

There is no fallback that hides the device: asking for the transfer
guard on CUDA without a card, or on a torch without
``torch.cuda.set_sync_debug_mode``, raises.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

# Ops that read a device value on the host (each waits for the card).
_SYNC_OPS = frozenset({
    _aten._local_scalar_dense.default, _aten.is_nonzero.default,
    _aten.nonzero.default, _aten.masked_select.default,
    _aten.equal.default,
})
# Index ops: a boolean index runs `nonzero` inside them.
_INDEX_OPS = frozenset({
    _aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default,
    _aten._index_put_impl_.default,
})
# Pointwise ops whose boolean argument is a mask, not a value.
_MASKED = frozenset({"where", "masked_fill"})

_KNOBS = {"transfer": "disallow", "dtype_promotion": "strict",
          "rank_promotion": "raise"}


class ImplicitTransferError(RuntimeError):
    """A device value was read on the host inside a sanitized block."""


class DtypePromotionError(ValueError):
    """An implicit dtype promotion (or a float64 result) inside a
    sanitized block (a ValueError, as jax's: torch turns a TypeError
    raised inside a binary operator into ``NotImplemented``)."""


class RankPromotionError(ValueError):
    """A pointwise op broadcast across tensors of different ranks."""


def _tensors(*groups) -> list:
    """The tensors among aten arguments or results: each group is a
    sequence or dict whose items are tensors, scalars or flat lists (aten
    signatures nest no deeper)."""
    out = []
    for group in groups:
        for a in (group.values() if isinstance(group, dict) else group):
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class _Guard(TorchDispatchMode):
    """The dispatch-level half of :func:`sanitized`: sees every aten op
    below autograd (forward and backward) and refuses the implicit ones."""

    def __init__(self, transfer: bool, dtype: bool, rank: bool):
        super().__init__()
        self.transfer, self.dtype, self.rank = transfer, dtype, rank
        self._pointwise: dict = {}     # op -> whether it is pointwise

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.transfer:
            if func in _SYNC_OPS:
                raise ImplicitTransferError(
                    f"implicit device->host transfer: {func} reads a device "
                    f"value on the host inside a sanitized block; keep it "
                    f"on the device, or download explicitly (to_host)")
            if func in _INDEX_OPS and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in args[1]):
                raise ImplicitTransferError(
                    f"implicit device->host transfer: {func} with a boolean "
                    f"mask runs nonzero, which reads the mask on the host")
        pointwise = self._pointwise.get(func)
        if pointwise is None:
            pointwise = self._pointwise[func] = \
                torch.Tag.pointwise in func.tags
        if pointwise and (self.dtype or self.rank):
            self._check_pointwise(func, args, kwargs)
        out = func(*args, **kwargs)
        if self.dtype and any(o.dtype == torch.float64
                              for o in _tensors((out,))):
            raise DtypePromotionError(
                f"{func} yields a float64 tensor inside a sanitized block "
                f"(FHL005: device code stays in float32 or below)")
        return out

    def _check_pointwise(self, func, args, kwargs) -> None:
        ts = _tensors(args, kwargs)
        if func._overloadpacket.__name__ in _MASKED:
            ts = [t for t in ts if t.dtype != torch.bool]
        if self.dtype and len({t.dtype for t in ts}) > 1:
            raise DtypePromotionError(
                f"implicit dtype promotion in {func}: tensor inputs of "
                f"dtypes {[str(t.dtype) for t in ts]}; cast explicitly")
        ranks = {t.dim() for t in ts if t.dim() > 0}
        if self.rank and len(ranks) > 1:
            raise RankPromotionError(
                f"rank_promotion: {func} broadcasts tensor inputs of "
                f"shapes {[tuple(t.shape) for t in ts]}; expand or reshape "
                f"explicitly")


@contextlib.contextmanager
def _sync_errors() -> Iterator[None]:
    """Every synchronizing CUDA call raises within the block."""
    if not torch.cuda.is_available():
        raise RuntimeError("sanitized(transfer='disallow') on CUDA, but "
                           "torch.cuda.is_available() is False")
    if not hasattr(torch.cuda, "set_sync_debug_mode"):
        raise RuntimeError("this torch has no torch.cuda.set_sync_debug_mode"
                           "; the transfer guard cannot run on CUDA")
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def explicit_transfer() -> Iterator[None]:
    """Scope of one deliberate host<->device copy: the CUDA sync-debug
    mode is relaxed inside it (a blocking copy from pageable memory syncs
    by design). The dispatch guard stays on: a float64 upload still
    raises. Where the sync-debug mode is off it does nothing."""
    before = (torch.cuda.get_sync_debug_mode()
              if torch.cuda.is_available() else 0)
    if not before:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def to_device(x: Any, device: torch.device | str,
              dtype: Any = None) -> torch.Tensor:
    """Explicit upload of host data: cast in numpy first (to ``dtype``,
    when given), then one copy to ``device``."""
    t = torch.from_numpy(np.asarray(x, dtype))
    with explicit_transfer():
        return t.to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Explicit download of a tensor as a numpy array (one copy)."""
    with explicit_transfer():
        return t.detach().cpu().numpy()


def _knob(name: str, value: Optional[str]) -> bool:
    if value is None:
        return False
    if value != _KNOBS[name]:
        raise ValueError(f"{name}={value!r}: the sanitizer takes "
                         f"{_KNOBS[name]!r} or None")
    return True


@contextlib.contextmanager
def sanitized(*, transfer: Optional[str] = "disallow",
              dtype_promotion: Optional[str] = "strict",
              rank_promotion: Optional[str] = "raise",
              device: Optional[torch.device | str] = None
              ) -> Iterator[None]:
    """Run the enclosed block under the three guards (see the module
    docstring). Pass ``None`` for any knob to leave it off (e.g.
    ``sanitized(dtype_promotion=None)``). ``device`` is where the block
    runs: the card when it is ``"cuda"`` or, by default, when one is
    available; the CUDA sync-debug mode is set only there."""
    xfer = _knob("transfer", transfer)
    dtype = _knob("dtype_promotion", dtype_promotion)
    rank = _knob("rank_promotion", rank_promotion)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    with contextlib.ExitStack() as stack:
        if xfer and torch.device(device).type == "cuda":
            stack.enter_context(_sync_errors())
        if xfer or dtype or rank:
            stack.enter_context(_Guard(xfer, dtype, rank))
        yield


def compile_counts(executor: Any) -> dict:
    """``{cache key: number of traced programs}`` for every compiled entry
    the executor has cached (its ``_jit`` dict, when it has one; keys the
    executor's own ``(kind, *shape)`` tuples). The port's executor runs
    eagerly and has no such cache yet, so this is ``{}``."""
    out = {}
    for key, fn in getattr(executor, "_jit", {}).items():
        size = getattr(fn, "_cache_size", None)
        out[key] = int(size()) if callable(size) else -1
    return out


class RetraceError(AssertionError):
    """A cached block program was compiled more often than its budget."""


class RetraceDetector:
    """Snapshot an executor's compile counts, then :meth:`check` that no
    ``(kind, block-shape)`` entry compiled more than ``budget`` times
    since. Budget is per entry: distinct block shapes rightly get
    distinct programs; the pathology is one shape compiling twice."""

    def __init__(self, executor: Any, budget: int = 1):
        self.executor = executor
        self.budget = budget
        self._baseline = compile_counts(executor)

    def check(self) -> dict:
        """Return current counts; raise :class:`RetraceError` listing
        every entry over budget."""
        counts = compile_counts(self.executor)
        over = []
        for key, n in counts.items():
            traced = n - self._baseline.get(key, 0)
            if n < 0:
                over.append(f"{key}: compile count unavailable")
            elif traced > self.budget:
                over.append(f"{key}: traced {traced}x "
                            f"(budget {self.budget})")
        if over:
            raise RetraceError(
                "retrace budget exceeded — a block program is being "
                "re-traced instead of reused:\n  " + "\n  ".join(over))
        return counts


def sanitized_run(cfg: Any, *, budget: int = 1,
                  transfer: Optional[str] = "disallow",
                  dtype_promotion: Optional[str] = "strict",
                  rank_promotion: Optional[str] = "raise"):
    """Build a :class:`~repro_torch.sim.engine.RoundEngine` from ``cfg``
    (a ``SimConfig`` or kwargs dict), run the fused driver under
    :func:`sanitized` on the engine's device, and enforce the retrace
    budget.

    Returns ``(result, compile_counts)``.
    """
    from repro_torch.sim import RoundEngine, SimConfig
    if not isinstance(cfg, SimConfig):
        cfg = SimConfig(**cfg)
    eng = RoundEngine(cfg)
    detector = RetraceDetector(eng.executor, budget=budget)
    # Guard the fused block loop only: params init and dataset staging
    # upload host data on purpose; the invariant is about the hot loop.
    eng._fused_cm = lambda: sanitized(
        transfer=transfer, dtype_promotion=dtype_promotion,
        rank_promotion=rank_promotion, device=eng.device)
    result = eng.run(fused=True)
    counts = detector.check()
    return result, counts


__all__ = ["DtypePromotionError", "ImplicitTransferError",
           "RankPromotionError", "RetraceDetector", "RetraceError",
           "compile_counts", "explicit_transfer", "sanitized",
           "sanitized_run", "to_device", "to_host"]
