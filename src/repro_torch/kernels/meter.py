"""What a step costs, as the dry run meters it (``launch/dryrun.py``),
and where the host spends a traced run's time.

A :class:`Meter` is installed for the span of a trace (:func:`metering`)
and collects three things that no aten op shows:

- the hand-written kernels' work: each wrapper's ``meta`` branch reports
  its kernel's ``(flops, bytes)`` from the kernel module's cost function
  (:func:`report_kernel`), and so does the backward of its autograd
  Function;
- the mesh round's collectives: ``core/mesh_round.py``'s ``psum_``,
  ``all_gather`` and ``ppermute_tree`` report each collective's kind and
  output bytes (:func:`report_collective`), the payload that the JAX
  package's ``parse_collective_bytes`` reads off its HLO;
- timed spans at the boundaries of the program's layers
  (:func:`span`): the engine's build, the plan, the block driver, an LM
  round and each satellite step's forward and backward; code inside a
  span adds what it learns as it runs with :func:`note`.

With no meter installed the reports are dropped: metering changes
nothing of what the wrappers and the collectives compute. The active
meter is a context variable, so two traces in two threads do not mix.

Spans are also recorded while a ``torch`` profiler records and no meter
is installed: they go to one process-wide meter (:func:`profiled`), kept
in memory for whoever reads the profiler's trace. Their times are on the
profiler's clock (Unix-epoch nanoseconds, ``time.time_ns()``), so a span
can be laid over the trace's host calls and device operations. With
neither a meter nor the profiler on, a span costs two flag reads.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Iterator, Optional

from torch._C._autograd import _profiler_enabled

#: The collective kinds of the JAX package's ``parse_collective_bytes``,
#: in its order.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: The most spans the process-wide meter keeps (the oldest go first).
PROFILED_SPANS = 1 << 20


@dataclasses.dataclass(eq=False)
class Span:
    """One timed stretch of the host's work: ``name``, its start and end
    in Unix-epoch ns (``end_ns`` None while it is open), the span that
    was open around it (``parent``, None at the top) and its ``attrs``."""
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    parent: Optional["Span"] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    def note(self, **attrs: Any) -> None:
        """Add attributes known only once the span has run a while."""
        self.attrs.update(attrs)


@dataclasses.dataclass
class Meter:
    """Kernel work, collective payloads and spans reported during one
    trace.

    ``kernels`` maps a kernel's name to ``{"calls", "flops", "bytes",
    "flops_f32", "flops_tf32x3"}``; ``flops_f32`` is the part run
    outside the tensor cores (at the card's f32 rate), ``flops_tf32x3``
    f32 on them as 3xTF32. ``collectives`` maps each of
    :data:`COLLECTIVES` to ``{"count", "bytes"}``. ``spans`` holds each
    :class:`Span` in the order the spans opened."""
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=lambda: {
        c: {"count": 0, "bytes": 0} for c in COLLECTIVES})
    spans: Any = dataclasses.field(default_factory=list)

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


_PROFILED = Meter(spans=collections.deque(maxlen=PROFILED_SPANS))
_OPEN: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "repro_torch_open_span", default=None)


def profiled() -> Meter:
    """The process-wide meter that holds the spans recorded while a
    profiler ran with no meter installed (at most
    :data:`PROFILED_SPANS`, from every profiled stretch of the process:
    a reader keeps those inside its own trace's bounds)."""
    return _PROFILED


class _Off:
    """What :func:`span` returns when nothing records: a reusable no-op
    context whose ``note`` drops its attributes."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def note(self, **attrs: Any) -> None:
        return None


_OFF = _Off()


class _Recording:
    """The context of one recorded span."""
    __slots__ = ("meter", "span", "token")

    def __init__(self, meter: Meter, name: str, attrs: dict):
        self.meter = meter
        self.span = Span(name, 0, None, None, attrs)

    def __enter__(self) -> Span:
        sp = self.span
        sp.parent = _OPEN.get()
        self.token = _OPEN.set(sp)
        self.meter.spans.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc: Any) -> None:
        self.span.end_ns = time.time_ns()
        _OPEN.reset(self.token)


def span(name: str, **attrs: Any):
    """A context that records the ``with`` block as a :class:`Span` named
    ``name`` with ``attrs`` (its ``__enter__`` gives the span, whose
    ``note`` adds attributes later): into the installed meter, or, with
    none installed, into :func:`profiled`'s while a profiler records.
    Otherwise nothing is recorded and the block runs as it is."""
    meter = _ACTIVE.get()
    if meter is None:
        if not _profiler_enabled():
            return _OFF
        meter = _PROFILED
    return _Recording(meter, name, attrs)


def note(**attrs: Any) -> None:
    """Add ``attrs`` to the innermost span open in this context (counts
    known only inside the span, such as a forward's); nothing when no
    span records."""
    sp = _OPEN.get()
    if sp is not None:
        sp.attrs.update(attrs)


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
