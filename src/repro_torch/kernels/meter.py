"""What a step costs, as the dry run meters it (``launch/dryrun.py``).

A :class:`Meter` is installed for the span of a trace (:func:`metering`)
and collects two things that no aten op shows:

- the hand-written kernels' work: each wrapper's ``meta`` branch reports
  its kernel's ``(flops, bytes)`` from the kernel module's cost function
  (:func:`report_kernel`), and so does the backward of its autograd
  Function;
- the mesh round's collectives: ``core/mesh_round.py``'s ``psum_``,
  ``all_gather`` and ``ppermute_tree`` report each collective's kind and
  output bytes (:func:`report_collective`), the payload that the JAX
  package's ``parse_collective_bytes`` reads off its HLO.

With no meter installed the reports are dropped: metering changes
nothing of what the wrappers and the collectives compute. The active
meter is a context variable, so two traces in two threads do not mix.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional

#: The collective kinds of the JAX package's ``parse_collective_bytes``,
#: in its order.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Meter:
    """Kernel work and collective payloads reported during one trace.

    ``kernels`` maps a kernel's name to ``{"calls", "flops", "bytes",
    "flops_f32", "flops_tf32x3"}``; ``flops_f32`` is the part run
    outside the tensor cores (at the card's f32 rate), ``flops_tf32x3``
    f32 on them as 3xTF32. ``collectives`` maps each of
    :data:`COLLECTIVES` to ``{"count", "bytes"}``."""
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=lambda: {
        c: {"count": 0, "bytes": 0} for c in COLLECTIVES})

    def kernel_totals(self) -> tuple[int, int, int, int]:
        """(flops, bytes, flops outside the tensor cores, f32 flops on
        them as 3xTF32) of every kernel call reported."""
        rows = self.kernels.values()
        return (sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows),
                sum(r["flops_f32"] for r in rows),
                sum(r["flops_tf32x3"] for r in rows))

    def collective_summary(self) -> dict:
        """The JAX parser's layout: each kind's count and bytes, and
        ``total_bytes``."""
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out


_ACTIVE: contextvars.ContextVar[Optional[Meter]] = contextvars.ContextVar(
    "repro_torch_meter", default=None)


@contextlib.contextmanager
def metering() -> Iterator[Meter]:
    """Install a new meter for the ``with`` block; yields it."""
    meter = Meter()
    token = _ACTIVE.set(meter)
    try:
        yield meter
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Meter]:
    """The installed meter, or None."""
    return _ACTIVE.get()


def report_kernel(name: str, flops: int, nbytes: int,
                  tensor_cores: bool, f32: bool = False) -> None:
    """Add one call of kernel ``name`` to the installed meter: its FLOP
    (on the tensor cores, as 3xTF32 there with ``f32``, or, with
    ``tensor_cores`` False, at the f32 rate) and the bytes it must
    move."""
    meter = _ACTIVE.get()
    if meter is None:
        return
    row = meter.kernels.setdefault(
        name, {"calls": 0, "flops": 0, "bytes": 0, "flops_f32": 0,
               "flops_tf32x3": 0})
    row["calls"] += 1
    row["flops"] += int(flops)
    row["bytes"] += int(nbytes)
    if not tensor_cores:
        row["flops_f32"] += int(flops)
    elif f32:
        row["flops_tf32x3"] += int(flops)


def report_collective(op: str, nbytes: int) -> None:
    """Add one collective of kind ``op`` (one of :data:`COLLECTIVES`)
    whose output holds ``nbytes`` to the installed meter."""
    meter = _ACTIVE.get()
    if meter is None:
        return
    row = meter.collectives[op]
    row["count"] += 1
    row["bytes"] += int(nbytes)
