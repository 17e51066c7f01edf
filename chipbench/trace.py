"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer readers need: the device's operations as intervals, the
host's events, and the window itself.

The profiler records the card's activity alone (kernels, copies, fills,
and on the host the CUDA runtime and driver calls that issue them): it
costs the host ~1-2 us an operation, where recording every aten op as
well slowed a round of the LM cells by 1.8x. The busy time is the union
of the device operations' intervals; the window runs from the first
event to the last. Idle gaps are the window's time outside that union,
each labelled with the host's innermost recorded call at its middle
(``host`` where it was in none: Python, the plan, or the host's own
numpy).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

_DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


@dataclasses.dataclass
class Trace:
    """The traced window: device operations ``(name, start_ns, end_ns)``
    sorted by start, host calls ``(start_ns, end_ns, name)`` sorted by
    start, the bounds of the recorded events, and the window's length on
    the host's clock."""
    device_ops: list
    host_events: list
    t0_ns: int
    t1_ns: int
    window_s: float

    def _busy_intervals(self) -> list:
        out: list = []
        for _, a, b in self.device_ops:
            a, b = max(a, self.t0_ns), min(b, self.t1_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-9

    def device_s(self, pred=lambda name: True) -> float:
        """Summed device time of the operations whose name passes
        ``pred`` (overlapping operations each count)."""
        return sum(b - a for n, a, b in self.device_ops if pred(n)) * 1e-9

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.device_ops if pred(n))

    def top_ops(self, n: int = 10) -> list:
        tot: dict = defaultdict(int)
        for name, a, b in self.device_ops:
            tot[name] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The window's idle time summed by what the host was doing at
        each gap's middle, the ``n`` largest."""
        busy = self._busy_intervals()
        gaps, prev = [], self.t0_ns
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1_ns > prev:
            gaps.append((prev, self.t1_ns))
        mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
        tot: dict = defaultdict(int)
        stack: list = []
        ev, i = self.host_events, 0
        for q, length in mids:
            while i < len(ev) and ev[i][0] <= q:
                while stack and stack[-1][1] < ev[i][0]:
                    stack.pop()
                stack.append(ev[i])
                i += 1
            while stack and stack[-1][1] < q:
                stack.pop()
            tot[stack[-1][2][:200] if stack else "host"] += length
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[label, ns * 1e-9] for label, ns in top]


def _device_op(e) -> bool:
    """A kernel, copy or fill on the card, not an annotation of the
    card's timeline (older profilers give no activity type)."""
    if hasattr(e, "activity_type"):
        act = str(e.activity_type()).lower()
        return any(a in act for a in _DEVICE_ACTIVITIES)
    return not e.is_user_annotation()


def from_events(events, window_s: float) -> Trace:
    """The :class:`Trace` of a profiler's events over a window of
    ``window_s`` seconds."""
    device, host = [], []
    for e in events:
        if "cuda" in str(e.device_type()).lower():
            if _device_op(e):
                device.append((e.name(), e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            host.append((e.start_ns(), e.end_ns(), e.name()))
    device.sort(key=lambda x: x[1])
    host.sort()
    ends = [x[2] for x in device] + [x[1] for x in host]
    starts = [x[1] for x in device] + [x[0] for x in host]
    if not starts:
        return Trace([], [], 0, 0, window_s)
    return Trace(device, host, min(starts), max(ends), window_s)
