"""The federated train step tensor-parallel over ``model``
(``core/fed_step.build_fed_train_step`` with the sanitized specs) on a
``(data=2, model=2)`` gloo mesh against the JAX package's
``build_fed_train_step(..., model_specs=sanitized)`` on 4 forced host
devices, and the training CLI under 4 gloo ranks with ``--sats 2``.

One module fixture writes the initial params (the port's seeded init of
the reduced qwen3-0.6b and rwkv6-3b) to an npz, runs the JAX side in a
subprocess (``tests/_torch_tp_train.py jax``) and meanwhile spawns the 4
ranks (``tests/_torch_dist.py``). One orbit of 2 satellites, the
``fedhap_fused`` round, one local SGD step at lr 0.1 a round, two
rounds, the second satellite visible every other round. Every rank's
``local_loss`` within ``LOSS_REL`` of the JAX step's, and its params,
gathered over ``model``, within ``LEAF_REL`` of each leaf's largest
magnitude in the JAX row of its satellite after each round (measured:
losses within 7.5e-8 relative; leaves 4.7e-7 for qwen3-0.6b and 6.3e-6
for rwkv6-3b, whose mixer is the JAX package's chunked form against the
port's recurrence, as in ``tests/test_torch_train.py``).

The CLI: 4 ranks of ``launch.train --sats 2`` (the mesh ``(data=2,
model=2)``), each rank's losses against rank 0's ``--single-device`` run
of the same flags within ``tests/test_torch_train.py``'s tolerances, and
the sharded run's checkpoint (gathered over ``model``, written by the
lead rank) against the single-device run's.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_tp_train as tt
from _torch_dist import spawn

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
LOSS_REL = 1e-5
LEAF_REL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_train")
    inp = work / "init.npz"
    np.savez(inp, **{f"{a}:{k}": v for a in tt.ARCHS
                     for k, v in tt.init_params(a).items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE.parent / "src"), str(HERE),
                os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    out = work / "jax.npz"
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_tp_train.py"), "jax", str(inp),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env)
    try:
        ranks = spawn("_torch_tp_train:step_ranks", 4, work / "ranks")
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    with np.load(out) as f:
        return dict(f), ranks


@pytest.mark.parametrize("step", range(tt.STEPS))
@pytest.mark.parametrize("arch", tt.ARCHS)
def test_sharded_step_matches_jax(runs, arch, step):
    want, ranks = runs
    for r in ranks:
        got = r[arch]
        np.testing.assert_allclose(got["losses"][step],
                                   want[f"{arch}:loss{step}"],
                                   rtol=LOSS_REL, atol=0)
        for k, v in got["params"][step].items():
            ref = want[f"{arch}:step{step}:{k}"][got["sat"]]
            assert v.shape == ref.shape, k
            err = float(np.max(np.abs(v - ref)))
            assert err <= LEAF_REL * float(np.max(np.abs(ref))), (k, err)


@pytest.mark.parametrize("arch", tt.ARCHS)
def test_step_shards_over_model(runs, arch):
    """The step's specs shard the projections over ``model`` (the
    sanitized ``model.specs()``: nothing replicates by default)."""
    specs = runs[1][0][arch]["specs"]
    sharded = [k for k, s in specs.items() if "model" in s]
    assert "embed/table" in sharded and len(sharded) > len(specs) // 3


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_cli")
    os.environ["TP_CLI_DIR"] = str(work)
    try:
        return spawn("_torch_tp_train:cli_ranks", 4, work / "ranks")
    finally:
        del os.environ["TP_CLI_DIR"]


def test_cli_shards_over_model_and_matches_single_device(cli):
    ref = cli[0]["ref"]
    assert ref["path"] == "single_device"
    for r in cli:
        assert r["path"] == "mesh"
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-6,
                                   atol=0)
    # rank 0 holds half of the table's rows (the vocab over model=2)
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-0.6b").reduced()
    assert cli[0]["shapes"]["embed/table"] == (1, cfg.vocab_size // 2,
                                               cfg.d_model)
    got, want = cli[0]["ckpt"]["mesh"], cli[0]["ckpt"]["single"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=5e-6, rtol=0,
                                   err_msg=k)
