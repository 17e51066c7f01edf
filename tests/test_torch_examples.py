"""The port's constellation examples against the JAX package's:
``examples/train_constellation_torch.py`` (the same ``ArchConfig``; three
rounds from the JAX example's init within ``tests/test_torch_train.py``'s
f32 tolerance; a checkpoint the JAX package loads) and the three
``*_torch.py`` CLIs' ``main`` on the CPU at a tiny size.

Tiny width for the rounds: d_model 64, 2 layers, vocab 256, sequence
32, the example's other defaults (4 satellites over 2 orbits, batch 2,
lr 0.02, ``partial_mode="exact"``, visibility 0.5). Both sides are f32
and differ only in the order of their sums (the port's attention on the
CPU is the dense plain version, the JAX package's the blockwise jnp
loop), so the tolerance is ``test_torch_train.py``'s: losses
``rtol=1e-6``, leaves ``atol=5e-6``.
"""
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.core.dissemination import ConstellationMeshMap as JaxCmap
from repro.core.fed_step import FedTrainConfig as JaxFedTrainConfig
from repro.core.fed_step import stack_params as jax_stack_params
from repro.core.mesh_round import FedRoundConfig as JaxFedRoundConfig
from repro.launch import train as jax_train
from repro_torch.models import params_from_numpy

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(d_model=64, layers=2, vocab=256)
TINY_ARGS = ["--d-model", "64", "--layers", "2", "--vocab", "256",
             "--seq", "32"]
SATS, SEQ, BATCH, LR, VIS = 4, 32, 2, 0.02, 0.5
LOSS_TOL = dict(rtol=1e-6, atol=0)
LEAF_TOL = dict(atol=5e-6, rtol=0)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _example("train_constellation_torch")


@pytest.fixture(scope="module")
def ref():
    return _example("train_constellation")


@pytest.mark.parametrize("dims", [(512, 8, 8192), (768, 8, 8192),
                                  (64, 2, 256)],
                         ids=["default", "d768", "tiny"])
def test_build_model_config_equals_reference(port, ref, dims):
    got, want = port.build_model(*dims), ref.build_model(*dims)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.count_params() == want.count_params()


def _jax_rounds(ref, rounds: int):
    """The JAX example's loop at ``TINY``: its model and init, its round
    (``_single_device_round``), batches and visibility draws."""
    model = ref.build_model(**TINY)
    cmap = JaxCmap(n_orbits=2, sats_per_orbit=SATS // 2, n_pods=1)
    fed = JaxFedTrainConfig(
        round_cfg=JaxFedRoundConfig(cmap=cmap, partial_mode="exact",
                                    ship_global_echo=False),
        round_kind="fedhap", local_steps=1, learning_rate=LR)
    params = model.init(jax.random.key(0))
    params_S = jax_stack_params(params, SATS)
    sizes = jnp.ones((SATS,), jnp.float32)
    rng = np.random.default_rng(0)
    step = jax.jit(jax_train._single_device_round(model, fed))
    losses = []
    for rnd in range(rounds):
        batch = jax_train.make_batches(model.cfg, SATS, BATCH, SEQ, rnd,
                                       TINY["vocab"])
        visible = jnp.asarray(jax_train._ensure_coverage(rng, cmap, VIS))
        params_S, metrics = step(params_S, batch, sizes, visible)
        losses.append(float(metrics["local_loss"]))
    return params, params_S, losses


@pytest.fixture(scope="module")
def jax_run(ref):
    return _jax_rounds(ref, 3)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree), "cpu").items()}


def test_three_rounds_match_the_jax_example(port, jax_run):
    init, want_S, want = jax_run
    out = port.train(port.build_model(**TINY), rounds=3, sats=SATS,
                     seq=SEQ, batch_per_sat=BATCH, lr=LR,
                     partial_mode="exact", visibility=VIS,
                     device=torch.device("cpu"),
                     init_params=jax.tree.map(np.asarray, init))
    np.testing.assert_allclose(out["losses"], want, **LOSS_TOL)
    flat = _flat(want_S)
    assert set(out["params_S"]) == set(flat)
    for k, leaf in out["params_S"].items():
        assert leaf.shape == flat[k].shape, k
        np.testing.assert_allclose(leaf.numpy(), flat[k], **LEAF_TOL,
                                   err_msg=k)
    assert out["tokens_per_s"] > 0


def test_cli_checkpoint_loads_in_the_jax_package(port, jax_run, tmp_path,
                                                 capsys):
    out = port.main(["--cpu", "--rounds", "3", *TINY_ARGS,
                     "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "device cpu" in text and "checkpoint in" in text
    losses = out["losses"]
    assert len(losses) == 3 and losses[-1] < losses[0]
    tree, manifest = jax_load_checkpoint(tmp_path, jax_run[0])
    assert manifest["step"] == 3
    assert manifest["metadata"] == {"arch": "qwen3-64d2L",
                                    "losses": losses}
    got = _flat(tree)
    for k, leaf in out["params_S"].items():
        np.testing.assert_array_equal(got[k], leaf[0].numpy(), err_msg=k)


def test_paper_reproduction_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = _example("paper_reproduction_torch").main(
        ["--cpu", "--methods", "FedHAP-oneHAP,FedSat (ideal)", "--out",
         str(out)], num_orbits=2, sats_per_orbit=8, num_samples=1200,
        eval_samples=240, local_steps=2, max_rounds=2)
    text = capsys.readouterr().out
    # in the table's order, not the flag's
    assert [r["method"] for r in rows] == ["FedSat (ideal)", "FedHAP-oneHAP"]
    assert "=== Table II reproduction ===" in text and "\nbest: " in text
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    assert all(0.0 <= r["final_acc"] <= 1.0 for r in rows)


def test_serve_cli_on_the_cpu(capsys):
    """The reference's defaults (reduced rwkv6-3b, batch 4, prompt 12,
    20 generated), ``--device cpu`` read after them."""
    toks = _example("serve_constellation_torch").main(["--device", "cpu"])
    assert toks.shape == (4, 32) and toks.dtype == np.int32
    assert "rwkv6-3b-reduced on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("name, argv", [
    ("paper_reproduction_torch", ["--methods", "FedHAP-oneHAP"]),
    ("train_constellation_torch", ["--rounds", "1", *TINY_ARGS]),
    ("serve_constellation_torch", []),
], ids=["paper", "train", "serve"])
def test_default_device_is_the_card(name, argv, tmp_path):
    """Without ``--cpu`` (``--device cpu``) each example asks for the
    card: here, where there is none, it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    if name == "paper_reproduction_torch":
        argv = argv + ["--out", str(tmp_path / "rows.json")]
    with pytest.raises(RuntimeError, match="is_available"):
        _example(name).main(argv)
