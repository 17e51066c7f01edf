"""One ``FusedExecutor.cycle_block`` of planned ``fedhap_buffered`` events
on the paper CNN: the port against the JAX package, from the same params,
event tensors and index tables (planned by the port, whose plans are
bit-equal to the JAX package's: ``test_torch_strategies.py``).

The block holds buffered, unflushed events and flushes (a 2-slot buffer
on 2 planes, ``buffer_fraction=1.0``); after it the global params, the
per-orbit cycle bases and the staleness buffer agree within f32
reduction-order tolerance (``atol=1e-5, rtol=1e-4``), and the flush
events' accuracies within one eval sample. On the card (``cuda``
marker) the same block matches the CPU executor's with one ``fedagg``
launch per valid event.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.sim import RoundEngine, SimConfig
from repro_torch.sim.strategies import FedHapBuffered

torch.set_num_threads(2)

# The slice test's CNN config (batch 8, two local steps), on the routed
# 2x8 shell with two buffer slots.
CFG = dict(model_kind="cnn", num_orbits=2, sats_per_orbit=8,
           stations="haps:2", strategy="fedhap_buffered",
           buffer_fraction=1.0, num_samples=1500, eval_samples=300,
           local_steps=2, batch_size=8, horizon_h=36.0, time_step_s=120.0)
F32 = dict(atol=1e-5, rtol=1e-4)
K = 4


def planned_tensors(eng, K):
    """K planned events, laid out by ``CycleStrategy.event_tensors`` as
    ``run_fused`` lays them out, each flush evaluated."""
    strat = FedHapBuffered()
    events = strat.plan_events(eng, strat.init_plan_state(eng, 0.0), K)
    for e in events:
        e["do_eval"] = bool(e["folds"])
    return strat.event_tensors(eng, events, K)


def test_cycle_block_params_match_jax():
    jeng = JaxEngine(JaxConfig(**CFG))
    peng = RoundEngine(SimConfig(device="cpu", **CFG))
    ev = planned_tensors(peng, K)
    assert ev["valid"].all()
    assert ev["flush"].any() and (~ev["flush"]).any()
    init = {k: np.asarray(v) for k, v in jeng.trainer.init(0).items()}
    L, B = CFG["num_orbits"], ev["rhos"].shape[1]

    jex = jeng.executor
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jg, jbases, jbuf, jaccs = jex.cycle_block(
        jp, jex.broadcast_rows(jp, L), jex.zero_rows(jp, B), ev)

    pex = peng.executor
    pp = params_from_numpy(init, "cpu")
    pg, pbases, pbuf, paccs = pex.cycle_block(
        pp, pex.broadcast_rows(pp, L), pex.zero_rows(pp, B), ev)

    for name, got, want in (("params", pg, jg), ("bases", pbases, jbases),
                            ("buffer", pbuf, jbuf)):
        got = params_to_numpy(got)
        for k in init:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **F32,
                                       err_msg=f"{name} {k}")
    jaccs = np.asarray(jaccs)
    assert np.array_equal(np.isnan(paccs), np.isnan(jaccs))
    assert np.isfinite(paccs[ev["do_eval"]]).all()
    done = ~np.isnan(jaccs)
    assert np.all(np.abs(paccs[done] - jaccs[done])
                  <= 1.0 / CFG["eval_samples"] + 1e-7)


@pytest.mark.cuda
def test_cycle_block_on_card_matches_cpu_one_launch_per_event():
    """On the card each valid event's member fold is one ``fedagg``
    launch, and the block agrees with the CPU executor's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fedagg kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")
    from repro_torch.kernels import fedagg as fedagg_mod
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ceng = RoundEngine(SimConfig(device="cpu", **CFG))
    geng = RoundEngine(SimConfig(device="cuda", **CFG))
    ev = planned_tensors(ceng, K)
    init = params_to_numpy(ceng.trainer.init(0))
    L, B = CFG["num_orbits"], ev["rhos"].shape[1]
    outs = []
    for eng, dev in ((ceng, "cpu"), (geng, "cuda")):
        p = params_from_numpy(init, dev)
        ex = eng.executor
        before = fedagg_mod.fedagg.launches
        g, bases, buf, accs = ex.cycle_block(
            p, ex.broadcast_rows(p, L), ex.zero_rows(p, B), ev)
        launches = fedagg_mod.fedagg.launches - before
        assert launches == (int(ev["valid"].sum()) if dev == "cuda" else 0)
        outs.append((params_to_numpy(g), params_to_numpy(bases),
                     params_to_numpy(buf), accs))
    for want, got in zip(outs[0][:3], outs[1][:3]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **F32, err_msg=k)
    done = ~np.isnan(outs[0][3])
    assert np.all(np.abs(outs[1][3][done] - outs[0][3][done])
                  <= 2.0 / CFG["eval_samples"] + 1e-7)
