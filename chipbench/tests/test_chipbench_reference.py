"""The plain references against the port's CPU path at reduced sizes,
through the harness's own set-up, window and check."""
import numpy as np
import pytest
import torch

import _tiny
from chipbench.reference import fedhap_plan, mla_lm


def test_sim_cell_runs_and_agrees():
    out = _tiny.run(_tiny.sim_cell())
    assert out.correct, out.checks
    assert out.checks["rounds"]["value"] == 0
    assert out.checks["hours"]["value"] == 0
    # the CPU's grouped convolutions and the reference's differ in the
    # order of their sums
    assert out.checks["final_gap"]["value"] < 1e-3


def test_plan_matches_the_engine():
    from repro_torch.sim.engine import RoundEngine, SimConfig
    from repro_torch.sim.strategies import get_strategy
    cell = _tiny.sim_cell()
    sim = dict(cell.config["sim"], seed=5)
    eng = RoundEngine(SimConfig(**dict(sim, device="cpu")))
    labels = np.concatenate([eng.eval_labels, eng.fd.labels])
    plan = fedhap_plan.Plan(sim, labels, 1_663_370)
    strat = get_strategy("fedhap")()
    t = 0.0
    while True:
        want, got = strat.plan_round(eng, t), plan.round(t)
        if want is None:
            assert got is None
            break
        mu, t_next = got
        np.testing.assert_array_equal(np.float32(mu), np.float32(want.mu))
        assert t_next == want.t_next
        t = t_next
    need = sim["local_steps"] * sim["batch_size"]
    np.testing.assert_array_equal(
        fedhap_plan.sample_indices(plan.pad, plan.int_sizes, need, plan.rng),
        eng.sample_indices(np.arange(eng.n_sats), 0.0))


@pytest.mark.parametrize("name", _tiny.LM_CELLS)
def test_lm_cell_agrees_in_f32(name):
    out = _tiny.run(_tiny.lm_cell(name, dtype="float32"))
    assert out.correct, out.checks
    for name in ("loss_gap", "step1_gap", "last_gap"):
        assert out.checks[name]["value"] < 1e-4, out.checks


@pytest.mark.parametrize("name", _tiny.LM_CELLS)
def test_lm_cell_runs_in_bf16(name):
    out = _tiny.run(_tiny.lm_cell(name))
    # At this size a leaf's change norm sums a few thousand bf16
    # roundings, so only the loss is held to the full-size limit here.
    assert out.checks["loss_gap"]["value"] <= out.checks["loss_gap"][
        "limit"], out.checks
    assert out.metrics["train_tokens_per_s"]["value"] > 0
    assert out.metrics["peak_mem_gib"]["value"] == 0


def test_attention_matches_softmax_and_its_gradient():
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(1, 2, 2500, 6, generator=gen, dtype=torch.float64)
            for _ in range(2))
    v = torch.randn(1, 2, 2500, 4, generator=gen, dtype=torch.float64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    prec = mla_lm.Precision(False)
    o = mla_lm._CausalAttention.apply(q, k, v, prec)
    s = (q @ k.transpose(-1, -2)) / 6 ** 0.5
    mask = torch.ones(2500, 2500, dtype=torch.bool).triu(1)
    want = torch.softmax(s.masked_fill(mask, float("-inf")), -1) @ v
    torch.testing.assert_close(o, want)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = torch.autograd.grad(want, (q, k, v), do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b)


def test_traced_run_reports_its_layers():
    out = _tiny.run(_tiny.lm_cell(trace=True))
    assert "mfu.train" in out.metrics and out.breakdown is not None
    assert list(out.device)[-2:] == ["busy_s", "window_s"]
