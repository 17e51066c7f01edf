"""The span readers (``metrics/_spans.py`` and the eight metrics on it):
the program's spans recorded while the harness's profiler runs, the
arithmetic on a hand-built trace, the tiny cells' readings, and, on the
card, the spans on the device trace's clock."""
import bisect
import random

import pytest
import torch

import _tiny
from chipbench import harness, trace as trace_mod
from chipbench.metrics import _spans
from repro_torch.kernels import meter

SIM = ("plan_idle_pct.sim", "block_idle_pct.sim", "untraced_idle_pct.sim")
TRAIN = ("fwd_idle_pct.train", "bwd_idle_pct.train", "round_idle_pct.train",
         "untraced_idle_pct.train")


@pytest.fixture
def fresh_profiled(monkeypatch):
    m = meter.Meter(spans=[])
    monkeypatch.setattr(meter, "_PROFILED", m)
    return m


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def _ctx(kind, tr):
    return type("Ctx", (), {"kind": kind, "trace": tr})()


def _span(name, a, b, parent=None, **attrs):
    return meter.Span(name, a, b, parent, attrs)


def test_harness_profiler_turns_recording_on_and_off(fresh_profiled):
    with meter.span("before"):
        pass
    prof = harness._start_profiler(torch.device("cpu"))
    with meter.span("during", k=2):
        torch.ones(4).sum()
    events = harness._stop_profiler()
    with meter.span("after"):
        pass
    assert prof is not None and events
    assert [(s.name, s.attrs) for s in fresh_profiled.spans] == [
        ("during", {"k": 2})]


# A window [50, 1000) ns; the device busy in [100, 300) and [500, 600).
def _trace():
    return trace_mod.Trace(
        device_ops=[("k", 100, 200), ("k", 150, 300), ("k", 500, 600)],
        host_events=[], t0_ns=50, t1_ns=1000, window_s=950e-9)


def test_train_readers_split_the_idle_time(fresh_profiled):
    tr = _trace()
    rnd = _span("fed.round", 0, 700, round=0)     # starts before the window
    fresh_profiled.spans.extend([
        _span("fed.round", -5000, -4000, round=9),     # an earlier trace's
        rnd,
        _span("fed.forward", 120, 400, rnd, sat=0, step=0),
        _span("fed.backward", 450, 650, rnd, sat=0, step=0),
        meter.Span("fed.round", 800, None)])           # never closed
    pct = lambda ns: 100.0 * ns / 950
    # idle: [50, 100) [300, 500) [600, 1000) = 650 ns
    assert _spans.idle(tr) == [[50, 100], [300, 500], [600, 1000]]
    got = {n: _read(n, _ctx("train", tr)) for n in TRAIN}
    assert got["fwd_idle_pct.train"] == pytest.approx(pct(100))  # [300, 400)
    assert got["bwd_idle_pct.train"] == pytest.approx(pct(100))  # 450-500, 600-650
    # [50, 100), [400, 450), [650, 700)
    assert got["round_idle_pct.train"] == pytest.approx(pct(150))
    assert got["untraced_idle_pct.train"] == pytest.approx(pct(300))
    assert sum(got.values()) == pytest.approx(
        _read("device_idle_pct.train", _ctx("train", tr)))
    assert all(_read(n, _ctx("sim", tr)) is None for n in TRAIN)


def test_sim_readers_and_plan_time(fresh_profiled):
    tr = _trace()
    fresh_profiled.spans.extend([
        _span("sim.build", 0, 80),
        _span("sim.plan", 80, 120, rounds=2),
        _span("sim.block", 120, 550),
        _span("sim.plan", 550, 610, rounds=1),
        _span("sim.block", 610, 1200),        # runs past the window
    ])
    pct = lambda ns: 100.0 * ns / 950
    got = {n: _read(n, _ctx("sim", tr)) for n in SIM}
    # build and plan: [50, 100) and [600, 610)
    assert got["plan_idle_pct.sim"] == pytest.approx(pct(60))
    # blocks: [300, 500) and [610, 1000)
    assert got["block_idle_pct.sim"] == pytest.approx(pct(590))
    assert got["untraced_idle_pct.sim"] == pytest.approx(0.0, abs=1e-9)
    assert sum(got.values()) == pytest.approx(
        _read("device_idle_pct.sim", _ctx("sim", tr)))
    # (40 + 60) ns over 3 rounds
    assert _read("plan_ms_per_round.sim", _ctx("sim", tr)) == \
        pytest.approx(1e-6 * 100 / 3)


def test_window_edges_the_trace_did_not_record(fresh_profiled):
    """The host's window may outlast the trace's first and last events:
    that time is idle and outside every span."""
    tr = _trace()
    tr.window_s = 1200e-9
    rnd = _span("fed.round", 0, 2000, round=0)
    fresh_profiled.spans.extend([   # the steps while the device is busy
        rnd, _span("fed.forward", 110, 290, rnd, sat=0, step=0),
        _span("fed.backward", 510, 590, rnd, sat=0, step=0)])
    got = {n: _read(n, _ctx("train", tr)) for n in TRAIN}
    assert got["fwd_idle_pct.train"] == got["bwd_idle_pct.train"] == 0
    assert got["round_idle_pct.train"] == pytest.approx(100 * 650 / 1200)
    assert got["untraced_idle_pct.train"] == pytest.approx(100 * 250 / 1200)
    assert sum(got.values()) == pytest.approx(
        _read("device_idle_pct.train", _ctx("train", tr)))


def test_readers_find_nothing_without_spans(fresh_profiled, monkeypatch):
    tr = _trace()
    names = SIM + TRAIN + ("plan_ms_per_round.sim",)
    for kind in ("sim", "train"):
        assert all(_read(n, _ctx(kind, tr)) is None for n in names)
    # A program whose meter has no spans at all (the commit before them).
    monkeypatch.delattr(meter, "profiled")
    fresh_profiled.spans.append(_span("sim.plan", 60, 70, rounds=1))
    assert all(_read(n, _ctx("sim", tr)) is None for n in names)


@pytest.mark.parametrize("seed", range(4))
def test_interval_arithmetic_against_a_grid(seed):
    rng = random.Random(seed)

    def draw():
        out = []
        for _ in range(rng.randint(0, 8)):
            a = rng.randint(0, 90)
            out.append((a, a + rng.randint(0, 20)))
        return out
    xs, ys = draw(), draw()
    cover = lambda ivs: {t for a, b in ivs for t in range(a, b)}
    ux, uy = _spans.union(xs), _spans.union(ys)
    assert cover(ux) == cover(xs)
    assert all(b1 < a2 for (_, b1), (a2, _) in zip(ux, ux[1:]))
    assert cover(_spans.minus(ux, uy)) == cover(xs) - cover(ys)
    assert _spans.overlap_ns(ux, uy) == len(cover(xs) & cover(ys))


class _Holding:
    """A runner that keeps the state the named one set up."""

    def __init__(self, name):
        self.runner = harness.load_module("runners", name)

    def __getattr__(self, attr):
        return getattr(self.runner, attr)

    def setup(self, cell, log):
        self.st = self.runner.setup(cell, log)
        return self.st


def _tiny_run(cell, runner):
    before = len(meter.profiled().spans)
    out = _tiny.run(cell, runner)
    return out, list(meter.profiled().spans)[before:]


def test_tiny_sim_cell_reports_the_span_metrics():
    runner = _Holding("sim")
    out, spans = _tiny_run(_tiny.sim_cell(trace=True), runner)
    m = {k: v["value"] for k, v in out.metrics.items()}
    assert all(m.get(n) is not None for n in SIM + ("plan_ms_per_round.sim",))
    assert abs(sum(m[n] for n in SIM) - m["device_idle_pct.sim"]) <= 0.1
    assert m["plan_ms_per_round.sim"] > 0
    # Every round is evaluated: a history's last entry counts its rounds.
    ran = sum(hist[-1][1] for hist, *_ in runner.st.runs)
    assert ran == len(runner.st.runs[0][0]) * out.attempted
    assert sum(s.attrs["rounds"] for s in spans if s.name == "sim.plan") \
        == ran


def test_tiny_lm_cell_reports_the_span_metrics():
    cell = _tiny.lm_cell(trace=True)
    out, spans = _tiny_run(cell, harness.load_module("runners", "fedround"))
    m = {k: v["value"] for k, v in out.metrics.items()}
    assert all(m.get(n) is not None for n in TRAIN)
    assert abs(sum(m[n] for n in TRAIN) - m["device_idle_pct.train"]) <= 0.1
    wl = cell.workload
    assert sum(s.name == "fed.round" for s in spans) == out.attempted
    assert sum(s.name == "fed.forward" for s in spans) == \
        out.attempted * wl["sats"] * wl["local_steps"]


@pytest.mark.cuda
def test_lm_round_spans_on_the_device_clock():
    """On the card: no device operation starts before its round's span
    starts or runs past the next round's start (each round ends in the
    loss's readback), and the host's launches between the first and the
    last round's start lie inside a ``fed.round`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device trace and the "
                    "kernels exist there only")
    cell = _tiny.lm_cell()
    cell.device = torch.device("cuda", 0)
    runner = harness.load_module("runners", "fedround")
    st = runner.setup(cell, lambda s: None)
    torch.cuda.synchronize()
    before = len(meter.profiled().spans)
    harness._start_profiler(cell.device)
    for i in range(3):
        runner.unit(st, i)
    torch.cuda.synchronize()
    tr = trace_mod.from_events(harness._stop_profiler(), 1.0)
    rounds = [s for s in list(meter.profiled().spans)[before:]
              if s.name == "fed.round"]
    assert len(rounds) == 3 and tr.device_ops
    starts = [s.start_ns for s in rounds]
    for name, a, b in tr.device_ops:
        k = bisect.bisect_right(starts, a) - 1
        assert k >= 0, (name, a, starts[0])
        if k + 1 < len(starts):
            assert b <= starts[k + 1], (name, b, starts[k + 1])
    launches = [(a, b) for a, b, name in tr.host_events
                if "Launch" in name and starts[0] <= a < starts[-1]]
    inside = sum(any(s.start_ns <= a and b <= s.end_ns for s in rounds)
                 for a, b in launches)
    assert launches and inside >= 0.99 * len(launches), (inside,
                                                         len(launches))
