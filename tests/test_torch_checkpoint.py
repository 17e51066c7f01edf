"""Checkpoint and resume of the port (``repro_torch.checkpoint`` and
``RoundEngine.run(checkpoint_dir=, resume=)``), on the CPU.

- The npz + json format round-trips dict-of-tensor trees, bf16 bit for
  bit; the latest pointer, key and shape mismatches behave as in the
  JAX package (a mirror of ``tests/test_checkpoint.py``).
- The format is the JAX package's: a checkpoint that
  ``repro.checkpoint.save_checkpoint`` wrote loads into the port leaf
  for leaf, the reverse too, and the port resumes a run that the JAX
  package cut.
- A run cut at 2 events and resumed reproduces the uninterrupted
  history exactly (``==``) on all 8 strategies fused, with the fault
  plane of ``tests/test_faults.py``, and on fedhap per round (a mirror
  of ``tests/test_faults.py::TestCheckpointResume``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.sim import RoundEngine as JaxEngine, SimConfig as JaxConfig
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.sim import RoundEngine, SimConfig
from test_torch_sim import _assert_histories

torch.set_num_threads(2)

QUICK = dict(model_kind="mlp", num_samples=1500, eval_samples=300,
             local_steps=2, horizon_h=36.0, time_step_s=120.0,
             max_rounds=4)
FAULTS = ("sat_outage=0.05,isl_drop=0.1,upload_loss=0.15,"
          "hap_outage=0.05,mtbf_h=2,mttr_h=1")
# The scenarios of tests/test_faults.py, in the registry's order.
SCENARIOS = [
    ("fedhap", "one_hap"),
    ("fedisl", "gs"),
    ("fedisl_ideal", "meo"),
    ("fedsat", "gs_np"),
    ("fedspace", "gs"),
    ("fedsink", "haps:2"),
    ("fedhap_async", "haps:2"),
    ("fedhap_buffered", "haps:2"),
]


def _resumed_run(cfg, tmp_path, fused):
    """A run resumed from ``tmp_path``, checked to have loaded the
    snapshot (a fresh start would reproduce the history too)."""
    eng = RoundEngine(SimConfig(**cfg))
    real, loaded = eng.ckpt_resume, []

    def spy(s, tree):
        out = real(s, tree)
        loaded.append(out is not None)
        return out
    eng.ckpt_resume = spy
    res = eng.run(fused=fused, checkpoint_dir=tmp_path, resume=True,
                  checkpoint_every=1)
    assert loaded == [True]
    return res


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "layers": {"w": torch.randn(4, 8, generator=g),
                   "b": torch.zeros(8)},
        "embed": torch.randn(16, 4, generator=g).to(torch.bfloat16),
        "step_scalar": torch.tensor(3.5),
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, t, step=7, metadata={"arch": "test"})
    loaded, manifest = load_checkpoint(tmp_path, _zeros_like(t))
    assert manifest["step"] == 7
    assert manifest["metadata"]["arch"] == "test"
    want = _leaves(t)
    for k, a in _leaves(loaded).items():
        assert torch.equal(a.float(), want[k].float()), k


def test_mixed_dtype_bit_exact_roundtrip(tmp_path):
    """Save->load restores every leaf's dtype AND bytes exactly: bf16
    has no npz representation (stored as its uint16 bits) and int16 must
    not promote."""
    rng = np.random.default_rng(3)
    t = {
        "bf16": torch.as_tensor(rng.normal(size=(7, 5))).to(torch.bfloat16),
        "f32": torch.as_tensor(rng.normal(size=(4,)), dtype=torch.float32),
        "i16": torch.as_tensor(rng.integers(-500, 500, size=(3, 2)),
                               dtype=torch.int16),
        "scalar": torch.tensor(1.0 / 3.0).to(torch.bfloat16),
    }
    save_checkpoint(tmp_path, t, step=1)
    loaded, _ = load_checkpoint(tmp_path, _zeros_like(t))
    for k, b in t.items():
        a = loaded[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b), k


def test_latest_pointer(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, t, step=1)
    save_checkpoint(tmp_path, {"layers": {k: v + 1 for k, v in
                                          t["layers"].items()},
                               "embed": t["embed"] + 1,
                               "step_scalar": t["step_scalar"] + 1}, step=2)
    loaded, manifest = load_checkpoint(tmp_path, _zeros_like(t))
    assert manifest["step"] == 2
    assert torch.equal(loaded["layers"]["b"], torch.ones(8))


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, _tree(), step=1)
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(tmp_path, {"other": torch.zeros(3)}, step=1)


def test_shape_mismatch_raises(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, t, step=1)
    t["layers"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, t, step=1)


def _jax_tree():
    k = jax.random.split(jax.random.key(0), 3)
    return {
        "params": {"conv1_w": jax.random.normal(k[0], (3, 3, 1, 4)),
                   "fc1_b": jnp.zeros(8)},
        "bases": {"conv1_w": jax.random.normal(k[1], (2, 3, 3, 1, 4)),
                  "fc1_b": jnp.ones((2, 8))},
        "embed": jax.random.normal(k[2], (6, 4)).astype(jnp.bfloat16),
    }


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    t = _jax_tree()
    jax_save(tmp_path, t, step=3, metadata={"from": "jax"})
    like = jax.tree.map(lambda x: torch.zeros(x.shape, dtype=torch.float32),
                        t)
    loaded, manifest = load_checkpoint(tmp_path, like)
    assert manifest["metadata"] == {"from": "jax"}
    assert "params/conv1_w" in manifest["keys"]
    got = _leaves(loaded)
    want, _ = jax.tree_util.tree_flatten_with_path(t)
    assert len(got) == len(want)
    for path, leaf in want:
        key = "/".join(p.key for p in path)
        a, b = got[key], np.asarray(leaf)
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name, key
        assert a.float().numpy().tobytes() == \
            b.astype(np.float32).tobytes(), key


def test_port_checkpoint_loads_into_jax(tmp_path):
    t = _tree(5)
    t = {"params": t["layers"], "embed": t["embed"]}
    save_checkpoint(tmp_path, t, step=2)
    like = {"params": {"w": jnp.zeros((4, 8)), "b": jnp.zeros(8)},
            "embed": jnp.zeros((16, 4), jnp.bfloat16)}
    loaded, manifest = jax_load(tmp_path, like)
    assert manifest["keys"] == sorted(["params/w", "params/b", "embed"])
    for key, a in _leaves(t).items():
        b = _leaves(loaded)[key]
        assert np.asarray(b).dtype.name == \
            str(a.dtype).removeprefix("torch."), key
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      a.float().numpy(), err_msg=key)


# On the 5x8 shell fedsat's first tick visits all five orbits (five
# events, past max_rounds): the 2x4 shell cuts it between ticks.
RESUME_CASES = [(s, st, {}) for s, st in SCENARIOS] + [
    ("fedsat", "gs_np", dict(num_orbits=2, sats_per_orbit=4))]


@pytest.mark.parametrize(
    "strategy,stations,shell", RESUME_CASES,
    ids=[s for s, _ in SCENARIOS] + ["fedsat_2x4"])
def test_resume_bit_identical_fused(strategy, stations, shell, tmp_path):
    cfg = dict(strategy=strategy, stations=stations, faults=FAULTS,
               device="cpu", **QUICK, **shell)
    full = RoundEngine(SimConfig(**cfg)).run(fused=True)
    half = dict(cfg, max_rounds=2)
    RoundEngine(SimConfig(**half)).run(
        fused=True, checkpoint_dir=tmp_path, checkpoint_every=1)
    res = _resumed_run(cfg, tmp_path, fused=True)
    assert res.history == full.history
    assert res.sim_hours == full.sim_hours


def test_resume_bit_identical_per_round(tmp_path):
    cfg = dict(strategy="fedhap", stations="one_hap", faults=FAULTS,
               device="cpu", **QUICK)
    full = RoundEngine(SimConfig(**cfg)).run(fused=False)
    half = dict(cfg, max_rounds=2)
    RoundEngine(SimConfig(**half)).run(
        fused=False, checkpoint_dir=tmp_path, checkpoint_every=1)
    res = _resumed_run(cfg, tmp_path, fused=False)
    assert res.history == full.history


def test_resume_without_snapshot_is_fresh_start(tmp_path):
    cfg = dict(strategy="fedhap", stations="one_hap", device="cpu", **QUICK)
    plain = RoundEngine(SimConfig(**cfg)).run(fused=True)
    res = RoundEngine(SimConfig(**cfg)).run(
        fused=True, checkpoint_dir=tmp_path / "empty", resume=True)
    assert res.history == plain.history


@pytest.mark.parametrize("strategy,stations", [
    ("fedhap_async", "haps:2"), ("fedsat", "gs_np"), ("fedspace", "gs")])
def test_per_round_event_strategy_rejected(strategy, stations, tmp_path):
    eng = RoundEngine(SimConfig(strategy=strategy, stations=stations,
                                device="cpu", **QUICK))
    with pytest.raises(ValueError, match="fused"):
        eng.run(fused=False, checkpoint_dir=tmp_path)


def test_port_resumes_a_run_the_jax_package_cut(tmp_path):
    """The JAX package runs 2 of 4 rounds with checkpoints; the port
    resumes from its snapshot (params, rng state, history) and ends
    where the JAX package's uninterrupted run ends: equal times and
    rounds, accuracy within one eval sample."""
    cfg = dict(strategy="fedhap", stations="one_hap", **QUICK)
    full = JaxEngine(JaxConfig(**cfg)).run(fused=True)
    JaxEngine(JaxConfig(**dict(cfg, max_rounds=2))).run(
        fused=True, checkpoint_dir=tmp_path, checkpoint_every=1)
    res = _resumed_run(dict(cfg, device="cpu"), tmp_path, fused=True)
    assert res.history[:2] == full.history[:2]
    _assert_histories(res, full, QUICK["eval_samples"])
