"""Timed spans of ``repro_torch.kernels.meter``: off by default, on under
``metering()`` and while a profiler records, on the profiler's clock; and
the spans the round and block drivers record (``fed.round``,
``fed.forward``, ``fed.backward``; ``sim.build``, ``sim.plan``,
``sim.block``) with their counts, parents and attributes, the counts a
forward notes on its span (``meter.note``) included."""
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as ap

from repro_torch.configs import get_config
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.fed_step import (FedTrainConfig, local_sgd,
                                       stack_params)
from repro_torch.core.mesh_round import FedRoundConfig
from repro_torch.kernels import meter
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.models.transformer import Transformer
from repro_torch.sim import RoundEngine, SimConfig

N_SATS, LOCAL_STEPS, ROUNDS = 4, 2, 2


@pytest.fixture
def fresh_profiled(monkeypatch):
    """An empty process-wide meter for the test."""
    m = meter.Meter(spans=[])
    monkeypatch.setattr(meter, "_PROFILED", m)
    return m


def _start_profiler():
    """The CPU profiler, started and stopped as the benchmark's harness
    does (``chipbench/harness.py``)."""
    prof = ap.profile(use_device=None, use_kineto=True, use_cpu=True)
    prof._prepare_trace()
    prof._start_trace()
    return prof


def test_nothing_is_recorded_by_default(fresh_profiled):
    assert meter.active() is None
    assert not torch._C._autograd._profiler_enabled()
    first = meter.span("a", x=1)
    assert meter.span("b") is first     # one shared no-op, nothing made
    with meter.span("a", x=1) as sp:
        sp.note(rounds=3)
        with meter.span("b"):
            pass
    assert list(fresh_profiled.spans) == []


def test_spans_under_metering_keep_parents_and_attrs(fresh_profiled):
    with meter.metering() as m:
        with meter.span("outer", round=7) as outer:
            with meter.span("inner", sat=1, step=0) as inner:
                pass
            outer.note(rounds=2)
        with meter.span("next"):
            pass
    assert [s.name for s in m.spans] == ["outer", "inner", "next"]
    assert inner.parent is outer and outer.parent is None
    assert m.spans[2].parent is None
    assert outer.attrs == {"round": 7, "rounds": 2}
    assert inner.attrs == {"sat": 1, "step": 0}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert list(fresh_profiled.spans) == []
    with meter.span("after"):
        pass
    assert len(m.spans) == 3


def test_a_span_open_in_one_thread_is_no_parent_in_another():
    seen = {}

    def other():
        with meter.span("theirs") as sp:
            seen["sp"] = sp

    with meter.metering() as m:
        with meter.span("mine"):
            # A new thread starts from an empty context: no meter, no
            # open span.
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert [s.name for s in m.spans] == ["mine"]
    assert not hasattr(seen["sp"], "parent")    # the no-op


def test_spans_recorded_while_the_profiler_records(fresh_profiled):
    prof = _start_profiler()
    try:
        assert torch._C._autograd._profiler_enabled()
        with meter.span("profiled", k=1) as sp:
            pass
    finally:
        ap._disable_profiler()
    assert prof is not None and not torch._C._autograd._profiler_enabled()
    with meter.span("after"):
        pass
    assert list(fresh_profiled.spans) == [sp]
    assert sp.attrs == {"k": 1} and sp.end_ns >= sp.start_ns


def test_public_profiler_records_spans_too(fresh_profiled):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with meter.span("inside"):
            torch.ones(3).sum()
    assert [s.name for s in fresh_profiled.spans] == ["inside"]


def test_span_clock_is_the_profilers(fresh_profiled):
    """A span's interval holds the profiler's interval of the op it
    wraps: both are Unix-epoch ns."""
    a = torch.randn(192, 192)
    _start_profiler()
    try:
        for i in range(4):
            with meter.span("mm", i=i):
                a @ a
    finally:
        events = ap._disable_profiler().events()
    mms = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.name() == "aten::mm")
    spans = list(fresh_profiled.spans)
    assert len(mms) == len(spans) == 4
    for (a0, a1), sp in zip(mms, spans):
        assert sp.start_ns <= a0 <= a1 <= sp.end_ns, (sp, a0, a1)


def test_profiled_meter_is_bounded():
    spans = meter.profiled().spans
    assert spans.maxlen == meter.PROFILED_SPANS


def _tiny_lm():
    cfg = get_config("qwen3-0.6b").reduced()
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    fed = FedTrainConfig(
        round_cfg=FedRoundConfig(cmap=ConstellationMeshMap(
            n_orbits=2, sats_per_orbit=N_SATS // 2, n_pods=1)),
        local_steps=LOCAL_STEPS, learning_rate=0.01)
    return model, params, fed


def test_lm_round_spans_count_nest_and_carry_attrs():
    model, params, fed = _tiny_lm()
    step = train.single_device_round(model, fed)
    params_S = stack_params(params, N_SATS)
    sizes = np.ones(N_SATS, np.float32)
    visible = np.ones(N_SATS, bool)
    with meter.metering() as m:
        for r in range(ROUNDS):
            batch = train.make_batches(model.cfg, N_SATS, 1, 8, r,
                                       model.cfg.vocab_size)
            params_S, _ = step(params_S, batch, sizes, visible)
    rounds = [s for s in m.spans if s.name == "fed.round"]
    fwd = [s for s in m.spans if s.name == "fed.forward"]
    bwd = [s for s in m.spans if s.name == "fed.backward"]
    assert len(m.spans) == len(rounds) + len(fwd) + len(bwd)
    assert [s.attrs for s in rounds] == [{"round": r} for r in range(ROUNDS)]
    assert len(fwd) == len(bwd) == ROUNDS * N_SATS * LOCAL_STEPS
    want = [{"sat": s, "step": i} for i in range(LOCAL_STEPS)
            for s in range(N_SATS)] * ROUNDS
    split = sum(k.startswith("layers/") for k in params)
    assert [s.attrs for s in fwd] == [
        {**w, "stacked_split": split, "stacked_indexed": 0} for w in want]
    assert [s.attrs for s in bwd] == want
    for f, b in zip(fwd, bwd):
        assert f.parent is b.parent and f.parent.name == "fed.round"
        assert f.parent.start_ns <= f.start_ns <= f.end_ns <= b.start_ns \
            <= b.end_ns <= f.parent.end_ns


def test_note_adds_to_the_innermost_recording_span(fresh_profiled):
    meter.note(lost=1)                  # nothing records: dropped
    with meter.span("off") as off:
        meter.note(lost=2)
    assert list(fresh_profiled.spans) == [] and off is meter.span("x")
    with meter.metering() as m:
        meter.note(lost=3)              # no span open: dropped
        with meter.span("outer", round=1):
            with meter.span("inner"):
                meter.note(n=4)
            meter.note(k=5)
    assert [(s.name, s.attrs) for s in m.spans] == [
        ("outer", {"round": 1, "k": 5}), ("inner", {"n": 4})]


def test_forward_notes_its_stacked_split(fresh_profiled, monkeypatch):
    """One ``local_sgd`` step of the reduced minicpm3-4b: each forward
    splits the 14 stacked leaves of ``layers/`` once and takes no layer's
    view by indexing a stacked leaf (the per-layer index path would take
    14 a layer); with nothing recording, the forward notes nothing."""
    cfg = get_config("minicpm3-4b").reduced()
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    stacked = [k for k in params if k.startswith("layers/")]
    assert len(stacked) == 14
    params_S = stack_params(params, 2)
    batch = train.make_batches(cfg, 2, 1, 8, 0, cfg.vocab_size)
    with meter.metering() as m:
        local_sgd(model, params_S, batch, 0.01, 1)
    fwd = [s for s in m.spans if s.name == "fed.forward"]
    assert [s.attrs for s in fwd] == [
        {"sat": s, "step": 0, "stacked_split": 14, "stacked_indexed": 0}
        for s in range(2)]
    assert all(s.attrs.keys() == {"sat", "step"}
               for s in m.spans if s.name == "fed.backward")
    local_sgd(model, params_S, batch, 0.01, 1)
    assert list(fresh_profiled.spans) == []
    monkeypatch.setattr(transformer, "_split", lambda p, *pre: {
        k: v for k, v in p.items() if k.startswith(pre)})
    with meter.metering() as m:
        local_sgd(model, params_S, batch, 0.01, 1)
    assert [s.attrs for s in m.spans if s.name == "fed.forward"] == [
        {"sat": s, "step": 0, "stacked_split": 0,
         "stacked_indexed": 14 * cfg.num_layers} for s in range(2)]


def test_sim_spans_count_the_planned_rounds():
    cfg = SimConfig(device="cpu", model_kind="mlp", num_orbits=2,
                    sats_per_orbit=4, num_samples=1500, eval_samples=300,
                    local_steps=2, batch_size=8, plan_block=2, max_rounds=5)
    with meter.metering() as m:
        eng = RoundEngine(cfg)
        res = eng.run(fused=True)
    names = [s.name for s in m.spans]
    assert names[0] == "sim.build" and names.count("sim.build") == 2
    plans = [s for s in m.spans if s.name == "sim.plan"]
    blocks = [s for s in m.spans if s.name == "sim.block"]
    assert sum(s.attrs["rounds"] for s in plans) == res.rounds == 5
    assert len(blocks) == 3     # blocks of 2, 2 and 1 rounds
    assert all(s.parent is None for s in m.spans)
    # Plan and block take turns: each block follows its plan.
    order = [n for n in names if n != "sim.build"]
    assert order == ["sim.plan", "sim.block"] * 3
