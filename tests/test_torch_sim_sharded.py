"""The satellite-sharded simulator of the port over ``torch.distributed``
(gloo, on the CPU): the counterpart of ``tests/test_sim_sharded.py`` /
``tests/helpers/check_sim_sharded.py``, on the quick MLP config.

A module fixture spawns 4 gloo ranks (``tests/_torch_dist.py``) that run
``tests/_torch_sim_mesh.py``: fedhap and fedhap_async with
``data_shards=4``, and ``run_block`` (S = 40 and S = 5, padded) and
``cycle_block`` (k = 5, padded, and k = 8) on the sharded executor; rank
0 then runs the single-rank programs on the same inputs. Held as the
reference holds them: times and rounds exact, accuracy within one eval
count (the all-reduce's sum order against one fold, quantised by
1/eval_n), every rank's history identical, params within atol 1e-6 and
rtol 1e-5 (measured: within 6e-8, accuracies equal). A 1-rank mesh runs
in this process and is held bit for bit against the unsharded program.
The 8-strategy sweep is ``-m slow``, as the JAX package's.
"""
import numpy as np
import pytest
import torch

import _torch_sim_mesh as sm
from _torch_dist import one_rank_group, spawn
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sim import RoundEngine, SimConfig
from repro_torch.sim.executor import FusedExecutor

TOL = dict(atol=1e-6, rtol=1e-5)
ACC_ATOL = 1.0 / sm.QUICK["eval_samples"] + 1e-9
BLOCKS = ["run_block/S40", "run_block/S5", "cycle_block/k5",
          "cycle_block/k8"]


def _hold_histories(ranks, scenarios):
    ref = ranks[0]["ref"]["hist"]
    for s in scenarios:
        want = ref[s]
        assert want, f"{s}: empty history"
        for r in ranks:
            got = r["hist"][s]
            assert got == ranks[0]["hist"][s], f"{s}: ranks disagree"
            assert len(got) == len(want), (s, len(got), len(want))
            for (t1, e1, a1), (t2, e2, a2) in zip(want, got):
                assert t1 == t2 and e1 == e2, (s, t1, t2, e1, e2)
                assert abs(a1 - a2) <= ACC_ATOL, (s, a1, a2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_sim_mesh:sim_ranks", 4,
                 tmp_path_factory.mktemp("sim_sharded"))


@pytest.mark.parametrize("strategy", sm.QUICK_SET)
def test_four_ranks_reproduce_the_single_rank_history(strategy, ranks):
    _hold_histories(ranks, [strategy])


@pytest.mark.parametrize("block", BLOCKS)
def test_sharded_blocks_match_single_rank(block, ranks):
    want = ranks[0]["ref"]["blocks"][block]
    for r in ranks:
        got = r["blocks"][block]
        for g, w in zip(got[:-1], want[:-1]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=block, **TOL)
        np.testing.assert_allclose(got[-1], want[-1], atol=ACC_ATOL,
                                   err_msg=block)


@pytest.mark.slow
def test_four_ranks_reproduce_all_eight_strategies(tmp_path):
    scenarios = [s for s, _ in sm.SCENARIOS]
    _hold_histories(spawn("_torch_sim_mesh:sim_ranks_all", 4, tmp_path,
                          deadline=900), scenarios)


# ------------------------------------------------------ one rank, here
def test_one_rank_mesh_is_bitwise_the_unsharded_program(tmp_path):
    """Histories of both families, every block's params and accuracies,
    and the fused loop under the sanitizer: all equal bit for bit."""
    from repro_torch.debug import sanitized_run
    with one_rank_group(tmp_path):
        mesh = mesh_lib.make_sim_mesh(1)
        for scenarios in sm.QUICK_SET:
            assert sm.histories([scenarios]) == \
                sm.histories([scenarios], mesh=mesh)
        eng = RoundEngine(SimConfig(mesh=mesh, **sm.QUICK))
        assert eng.executor.mesh is mesh
        plain = FusedExecutor(eng.trainer, eng.fd, eng.eval_images,
                              eng.eval_labels)
        got, want = sm.blocks(eng, eng.executor), sm.blocks(eng, plain)
        for block in BLOCKS:
            for g, w in zip(got[block], want[block]):
                if isinstance(w, dict):
                    for k in w:
                        np.testing.assert_array_equal(g[k], w[k])
                else:
                    np.testing.assert_array_equal(g, w)
        res, _ = sanitized_run(dict(mesh=mesh, **sm.QUICK))
        assert res.history == sm.histories(["fedhap"])["fedhap"]


def test_sim_mesh_needs_its_world(tmp_path):
    with pytest.raises(ValueError, match="at least one"):
        mesh_lib.make_sim_mesh(0)
    with pytest.raises(ValueError, match="world size 2"):
        mesh_lib.make_sim_mesh(2)
    with one_rank_group(tmp_path):
        with pytest.raises(ValueError, match="world size 2, not 1"):
            RoundEngine(SimConfig(data_shards=2, **sm.QUICK))
        with pytest.raises(ValueError, match="world size 4, not 1"):
            mesh_lib.make_debug_mesh(2, 2)


def test_executor_rejects_a_mesh_without_a_data_axis():
    class FakeMesh:
        mesh_dim_names = ("model",)
        shape = (1,)

    eng = RoundEngine(SimConfig(**dict(sm.QUICK, num_samples=300,
                                       eval_samples=50, horizon_h=1.0)))
    with pytest.raises(ValueError, match="data"):
        FusedExecutor(eng.trainer, eng.fd, eng.eval_images,
                      eng.eval_labels, mesh=FakeMesh())


def test_launch_helpers_outside_torchrun(monkeypatch):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert mesh_lib.init_ranks("cpu") is None
    assert mesh_lib.backend_for("cuda") == "nccl"
    assert mesh_lib.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.backend_for("meta")
    cmap = mesh_lib.make_constellation_map(multi_pod=True)
    assert (cmap.n_orbits, cmap.sats_per_orbit, cmap.n_pods) == (4, 4, 2)
    with pytest.raises(ValueError, match="world size 256"):
        mesh_lib.make_production_mesh()
    assert torch.distributed.is_available()
