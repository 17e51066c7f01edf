"""The slice end to end: the port's RoundEngine against the JAX package's
on one small CNN config, from the same JAX init.

- History times and round counts are bit-equal (the plan half is numpy
  in both).
- Accuracies agree within one flipped prediction of the eval set.
- Params after one ``run_block`` agree within f32 reduction-order
  tolerance (``atol=1e-5, rtol=1e-4``; measured max |diff| 6.0e-8 on
  this config, CPU).
- Within the port, the fused path equals the per-round loop.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro.sim.strategies import FedHap as JaxFedHap
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.sim import RoundEngine, SimConfig
from repro_torch.sim.strategies import FedHap

torch.set_num_threads(2)

# Small enough for the JAX package's CPU CNN (its vmapped convolutions
# take seconds per round on the CPU): batch 8, two blocks of two rounds.
CFG = dict(model_kind="cnn", num_orbits=2, sats_per_orbit=4,
           num_samples=1500, eval_samples=300, local_steps=2, batch_size=8,
           plan_block=2, max_rounds=4)
F32 = dict(atol=1e-5, rtol=1e-4)


@functools.cache
def _jax_engine_run(model_kind, fused):
    """A JAX-package engine after its run, and the run's result; the
    engine's executor keeps its compiled block program for reuse."""
    eng = JaxEngine(JaxConfig(**dict(CFG, model_kind=model_kind)))
    init = {k: np.asarray(v) for k, v in eng.trainer.init(0).items()}
    return eng, init, eng.run(fused=fused)


def _jax_init(model_kind):
    return _jax_engine_run(model_kind, True)[1]


def _jax_run(model_kind, fused):
    return _jax_engine_run(model_kind, fused)[2]


def _port_run(model_kind, fused, **kw):
    eng = RoundEngine(SimConfig(device="cpu",
                                **dict(CFG, model_kind=model_kind, **kw)))
    return eng.run(fused=fused, init_params=_jax_init(model_kind))


def _assert_histories(got, want, n_eval):
    assert got.rounds == want.rounds
    assert got.sim_hours == want.sim_hours
    for (t_g, e_g, a_g), (t_w, e_w, a_w) in zip(got.history, want.history):
        assert t_g == t_w and e_g == e_w
        assert abs(a_g - a_w) <= 1.0 / n_eval + 1e-7


@pytest.mark.parametrize("model_kind", ["cnn", "mlp"])
def test_fused_history_matches_jax(model_kind):
    want = _jax_run(model_kind, True)
    got = _port_run(model_kind, True)
    assert got.rounds == CFG["max_rounds"]
    _assert_histories(got, want, CFG["eval_samples"])


def test_per_round_history_matches_jax():
    _assert_histories(_port_run("mlp", False), _jax_run("mlp", False),
                      CFG["eval_samples"])


def test_fused_equals_per_round_within_port():
    fus, ref = _port_run("cnn", True), _port_run("cnn", False)
    assert fus.rounds == ref.rounds and fus.sim_hours == ref.sim_hours
    for (t_f, e_f, a_f), (t_r, e_r, a_r) in zip(fus.history, ref.history):
        assert t_f == t_r and e_f == e_r
        np.testing.assert_allclose(a_f, a_r, rtol=1e-4, atol=1e-5)


def test_run_block_params_match_jax():
    """One block of planned rounds through both executors from the same
    params, plan tensors and index tables (the JAX engine of the fused
    run, whose block program is already compiled)."""
    jeng, init, _ = _jax_engine_run("cnn", True)
    peng = RoundEngine(SimConfig(device="cpu", **CFG))
    K = CFG["plan_block"]
    plans, t = [], 0.0
    for _ in range(K):
        plans.append(JaxFedHap().plan_round(jeng, t))
        t = plans[-1].t_next
    pplan = FedHap().plan_round(peng, 0.0)
    np.testing.assert_array_equal(pplan.mu, plans[0].mu)
    sats = np.arange(jeng.n_sats)
    idx = np.stack([jeng.sample_indices(sats, p.orbit_t.min())
                    for p in plans])
    mu = np.stack([p.mu for p in plans]).astype(np.float32)
    flags = np.ones(K, bool)
    jparams, jaccs = jeng.executor.run_block(
        {k: jax.numpy.asarray(v) for k, v in init.items()}, idx, mu, flags,
        flags)
    pparams, paccs = peng.executor.run_block(
        params_from_numpy(init, "cpu"), idx, mu, flags, flags)
    got = params_to_numpy(pparams)
    for k in init:
        np.testing.assert_allclose(got[k], np.asarray(jparams[k]), **F32,
                                   err_msg=k)
    assert np.all(np.abs(paccs - jaccs) <= 1.0 / CFG["eval_samples"] + 1e-7)


def test_invalid_round_carries_params_through():
    eng = RoundEngine(SimConfig(device="cpu", **CFG))
    init = params_from_numpy(_jax_init("cnn"), "cpu")
    need = CFG["local_steps"] * eng.trainer.batch_size
    idx = np.zeros((2, eng.n_sats, need), np.int64)
    mu = np.full((2, eng.n_sats), 1.0 / eng.n_sats, np.float32)
    params, accs = eng.executor.run_block(
        init, idx, mu, np.array([True, True]), np.array([False, False]))
    assert all(torch.equal(params[k], init[k]) for k in init)
    assert np.isnan(accs).all()


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        RoundEngine(SimConfig(**CFG))


@pytest.mark.parametrize("kw", [dict(data_shards=2)], ids=["data_shards"])
def test_features_outside_the_slice_raise(kw):
    """``data_shards=2`` shards over a process group of 2 ranks
    (``tests/test_torch_sim_sharded.py``); without one it raises, naming
    the world size it needs."""
    with pytest.raises(ValueError, match="world size 2"):
        RoundEngine(SimConfig(device="cpu", **dict(CFG, **kw)))
