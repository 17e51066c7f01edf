"""Interval arithmetic the span readers share: the program's spans
(``repro_torch.kernels.meter``, recorded while the profiler ran, on the
trace's clock) laid over the device's idle time in the traced window.

Every interval is ``[start_ns, end_ns)``. A span list is clipped to the
trace's bounds ``[t0_ns, t1_ns]``; the device's idle time is that window
less the union of its operations (``Trace._busy_intervals``). A share is
a percentage of the window's length on the host's clock
(``Trace.window_s``), as ``device_idle_pct`` is.
"""
from __future__ import annotations


def program_spans(trace, names: tuple) -> list | None:
    """The finished spans named in ``names`` that overlap the trace's
    bounds, unclipped; None where the program records no spans (it has
    no process-wide meter) or recorded none of these in the window."""
    from repro_torch.kernels import meter
    profiled = getattr(meter, "profiled", None)
    if profiled is None or trace.window_s <= 0:
        return None
    out = [s for s in list(profiled().spans)
           if s.name in names and s.end_ns is not None
           and s.end_ns > trace.t0_ns and s.start_ns < trace.t1_ns]
    return out or None


def union(intervals) -> list:
    """The sorted, merged union of ``(a, b)`` intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(trace, spans) -> list:
    """The union of ``spans``' intervals clipped to the trace's bounds."""
    return union((max(s.start_ns, trace.t0_ns), min(s.end_ns, trace.t1_ns))
                 for s in spans)


def idle(trace) -> list:
    """The trace's bounds less the union of its device operations."""
    out, prev = [], trace.t0_ns
    for a, b in trace._busy_intervals():
        if a > prev:
            out.append([prev, a])
        prev = max(prev, b)
    if trace.t1_ns > prev:
        out.append([prev, trace.t1_ns])
    return out


def minus(xs: list, ys: list) -> list:
    """Merged ``xs`` less merged ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append([a, ys[k][0]])
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def overlap_ns(xs: list, ys: list) -> int:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def pct(trace, ns: float) -> float:
    """``ns`` as a percentage of the traced window."""
    return 100.0 * ns * 1e-9 / trace.window_s


def idle_pct(trace) -> float:
    """``device_idle_pct``'s reading: the window outside the union of
    device operations, in %."""
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def idle_in_pct(trace, names: tuple, outside: tuple = ()) -> float | None:
    """The device's idle time inside the spans named ``names`` and
    outside those named ``outside``, in % of the window; None where the
    program recorded no span named ``names``."""
    spans = program_spans(trace, names)
    if spans is None:
        return None
    inside = clipped(trace, spans)
    if outside:
        inside = minus(inside, clipped(trace, program_spans(
            trace, outside) or ()))
    return pct(trace, overlap_ns(idle(trace), inside))


def untraced_pct(trace, names: tuple) -> float | None:
    """``device_idle_pct`` less the idle time inside the spans named
    ``names``: the idle time outside them within the trace's bounds, plus
    the window's time before the trace's first event and after its last;
    None where the program recorded none of these spans."""
    inside = idle_in_pct(trace, names)
    if inside is None:
        return None
    return idle_pct(trace) - inside
