"""The port's mesh rounds over ``torch.distributed`` (gloo, on the CPU)
against the JAX package's ``build_round`` on 8 forced host devices.

One module fixture starts the JAX side in a subprocess
(``tests/_torch_mesh.py jax``: 8 forced devices must be set before jax
starts, as ``tests/test_fedhap_mesh.py`` does) and meanwhile spawns 8
gloo ranks (``tests/_torch_dist.py``) that run every case of
``_torch_mesh.cases()`` on their own satellite: the single-pod map
``ConstellationMeshMap(2, 4, 1)`` on a ``(data=8, model=1)`` mesh (all
three kinds x paper / exact x echo on / off, and exact + global
weighting), the Eq.-15 gate closed, and two pods ``(1, 2, 2)`` on
``(pod=2, data=2, model=2)`` (the HAP ring on and off; ``model``
replicates). Each case is its own test: every rank's params within atol
1e-5 of the JAX row of its satellite, ``gate`` and ``covered`` equal,
``upload_mass`` within f32 rounding (measured here: params within
1.2e-7). A second fixture spawns 4 ranks for the one-rank-per-satellite
LM step (``launch.train`` on the mesh path, reduced qwen3-0.6b, 2
orbits x 2, the ``fedhap_fused`` round) against ``single_device_round``
on rank 0 at 4 satellites, at ``tests/test_torch_train.py``'s
tolerance (measured: losses within 8.7e-8 relative, leaves 7.2e-7).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh as tm
from _torch_dist import one_rank_group, spawn
from repro_torch.core import mesh_round as mr
from repro_torch.core.dissemination import ConstellationMeshMap
from repro_torch.core.weights import chain_stats

HERE = pathlib.Path(__file__).resolve().parent
CASES = {c["name"]: c for c in tm.cases()}
PARAM_ATOL = 1e-5
LOSS_TOL = dict(rtol=1e-6, atol=0)
LEAF_TOL = dict(atol=5e-6, rtol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX outputs, the 8 ranks' results)."""
    work = tmp_path_factory.mktemp("mesh_round")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE.parent / "src"), str(HERE),
                os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    npz = work / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_mesh.py"), "jax", str(npz)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
    try:
        ranks = spawn("_torch_mesh:round_ranks", 8, work / "ranks")
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log.decode(errors="replace")[-4000:]
    with np.load(npz) as f:
        return dict(f), ranks


@pytest.mark.parametrize("case", list(CASES))
def test_round_matches_jax(case, runs):
    want, ranks = runs
    seen = set()
    for r in ranks:
        sat, params, stats = r[case]
        seen.add(sat)
        for k, v in params.items():
            assert v.shape == (1,) + want[f"{case}/{k}"].shape[1:]
            np.testing.assert_allclose(v[0], want[f"{case}/{k}"][sat],
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{case} {k} sat {sat}")
        for k in ("gate", "covered"):
            assert stats[k] == float(want[f"{case}/stat/{k}"]), (case, k)
        np.testing.assert_allclose(stats["upload_mass"],
                                   want[f"{case}/stat/upload_mass"],
                                   rtol=1e-6)
    assert seen == set(range(len(CASES[case]["sizes"])))


@pytest.mark.parametrize("case", [n for n in CASES if "/gate/" in n])
def test_closed_gate_keeps_the_replicas_bitwise(case, runs):
    _, ranks = runs
    params = CASES[case]["params"]
    for r in ranks:
        sat, got, stats = r[case]
        assert stats["gate"] == 0.0
        for k, v in got.items():
            np.testing.assert_array_equal(v[0], params[k][sat])


@pytest.mark.parametrize("case", [n for n in CASES
                                  if "/fedhap/" in n and "echo1" in n])
def test_global_echo_changes_nothing_bitwise(case, runs):
    """The echo's sends run; the reference's ``0.0 * echo_probe`` term
    is left out, and the round equals the round without the echo."""
    _, ranks = runs
    for r in ranks:
        on, off = r[case][1], r[case.replace("echo1", "echo0")][1]
        for k in on:
            np.testing.assert_array_equal(on[k], off[k])


def test_sharded_fold_pads_with_exact_zeros(runs):
    """S=5 rows over data=4 (replicated over model=2): padded to 8, two
    rows a rank; the last rank's rows are both dead and its part is
    exactly zero, the third's equals the fold of row 4 alone, and the
    all-reduced fold equals one fold of the 5 rows."""
    _, ranks = runs
    f = tm.fold_inputs()
    want = {k: np.einsum("s,s...->...", f["w"], v)
            for k, v in f["rows"].items()}
    for r in ranks:
        fold = r["fold"]
        for k in want:
            np.testing.assert_allclose(fold["got"][k], want[k], atol=1e-6,
                                       rtol=1e-5, err_msg=k)
            if fold["data"] == 3:
                np.testing.assert_array_equal(fold["part"][k], 0.0)
            if fold["data"] == 2:
                np.testing.assert_array_equal(
                    fold["part"][k], f["w"][4] * f["rows"][k][4])


@pytest.mark.parametrize("mode", ["paper", "exact"])
@pytest.mark.parametrize("k", [*range(1, 9), 13, 24])
def test_chain_twin_matches_numpy_chain_stats(k, mode):
    """The torch twin of the ring walk, bit for bit (its orbit mass is
    summed in numpy's order)."""
    rng = np.random.default_rng(100 + k)
    vis = rng.random((16, k)) < 0.4
    vis[0] = False                       # a ring with no visible satellite
    vis[1] = True
    sizes = rng.uniform(0.5, 20, size=(16, k)).astype(np.float32)
    sizes[2] = 0.0                       # a ring with no mass
    lam, seg = chain_stats(vis, sizes, mode)
    tlam, tseg = mr.chain_stats_torch(torch.from_numpy(vis),
                                      torch.from_numpy(sizes), mode)
    assert tlam.dtype == torch.float32 and lam.dtype == np.float32
    np.testing.assert_array_equal(tlam.numpy(), lam)
    np.testing.assert_array_equal(tseg.numpy(), seg)


# ------------------------------------------------------------- LM step
@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    return spawn("_torch_mesh:lm_ranks", 4,
                 tmp_path_factory.mktemp("mesh_lm"))


def test_lm_step_over_four_ranks_matches_single_device_round(lm):
    ref = lm[0]["ref"]
    assert ref["path"] == "single_device"
    for sat, r in enumerate(lm):
        assert r["path"] == "mesh"
        np.testing.assert_allclose(r["losses"], ref["losses"], **LOSS_TOL)
        assert set(r["params"]) == set(ref["params"])
        for k, v in r["params"].items():
            assert v.shape == (1,) + ref["params"][k].shape[1:]
            np.testing.assert_allclose(v[0], ref["params"][k][sat],
                                       **LEAF_TOL, err_msg=k)


# ------------------------------------------------------ one rank, here
def test_round_runs_on_one_rank(tmp_path):
    """Every kind on a 1-rank group: one satellite's round is itself."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = mr.FedRoundConfig(cmap=ConstellationMeshMap(1, 1, 1))
    p = {"w": torch.randn(1, 3, 2), "b": torch.randn(1, 4)}
    with one_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for kind in tm.KINDS:
            new, stats = mr.build_round(mesh, cfg, None, kind=kind)(
                p, torch.tensor([3.0]), torch.tensor([True]))
            for k in p:
                assert torch.equal(new[k], p[k]), (kind, k)
            assert {k: float(v) for k, v in stats.items()} == {
                "gate": 1.0, "covered": 1.0, "upload_mass": 3.0}


def test_mesh_errors(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    with one_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="cannot tile"):
            mr.build_round(mesh, mr.FedRoundConfig(), None)
        one = mr.FedRoundConfig(cmap=ConstellationMeshMap(1, 1, 1))
        with pytest.raises(NotImplementedError, match="Queue A item 19"):
            mr.build_round(mesh, one, None, model_specs={"w": (None,)})
        with pytest.raises(ValueError, match="kind"):
            mr.build_round(mesh, one, None, kind="kind")
        # a tensor of another device never goes to the gloo group
        with pytest.raises(ValueError, match="meta tensor offered to a gloo"):
            mr.psum(torch.zeros(1, device="meta"), mesh, ("data",))
        with pytest.raises(ValueError, match="DeviceMesh"):
            mr.sharded_fold({"w": torch.ones(1, 2)}, [1.0], object())
