"""On the card, outside any test-side cuDNN setting: a fused run resumed
from a checkpoint equals an uninterrupted one bit for bit (the executor
restricts cuDNN to its deterministic algorithms), and the sanitizer's
fused runs equal plain ones exactly while the card's sync-debug mode
refuses an implicit copy. All skip without a card."""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.debug import sanitized, sanitized_run, to_host
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.sim import RoundEngine, SimConfig

# The paper CNN (the replica-grouped convolutions whose default cuDNN
# algorithms differ from run to run) on the 5x8 shell, few samples.
CNN = dict(model_kind="cnn", num_samples=3000, eval_samples=500,
           local_steps=2, device="cuda")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fedagg kernel is CUDA C++ "
                    "and has no CPU or interpreter mode")


def _latest(directory: pathlib.Path) -> dict:
    step = json.loads((directory / "latest.json").read_text())["step"]
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        return {k: data[k] for k in data.files}


@pytest.mark.cuda
def test_fedspace_resume_bit_identical_on_card(tmp_path):
    _need_card()
    torch.backends.cudnn.deterministic = False   # the executor sets it
    cfg = dict(strategy="fedspace", stations="gs", max_rounds=3, **CNN)
    full = RoundEngine(SimConfig(**cfg))
    full.executor
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    want = full.run(checkpoint_dir=tmp_path / "full", checkpoint_every=1)
    RoundEngine(SimConfig(**dict(cfg, max_rounds=2))).run(
        checkpoint_dir=tmp_path / "cut", checkpoint_every=1)
    eng = RoundEngine(SimConfig(**cfg))
    real, loaded = eng.ckpt_resume, []

    def spy(s, tree):
        out = real(s, tree)
        loaded.append(out is not None)
        return out
    eng.ckpt_resume = spy
    got = eng.run(checkpoint_dir=tmp_path / "cut", resume=True,
                  checkpoint_every=1)
    assert loaded == [True]
    assert got.history == want.history
    assert got.sim_hours == want.sim_hours
    a, b = _latest(tmp_path / "full"), _latest(tmp_path / "cut")
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,stations,max_rounds", [
    ("fedhap", "one_hap", 3), ("fedhap_async", "haps:2", 4)])
def test_sanitized_run_matches_plain_on_card(strategy, stations,
                                             max_rounds):
    _need_card()
    cfg = dict(strategy=strategy, stations=stations, max_rounds=max_rounds,
               **CNN)
    before = fedagg_mod.fedagg.launches
    res, counts = sanitized_run(cfg)
    sanitized_launches = fedagg_mod.fedagg.launches - before
    assert counts == {}
    assert torch.cuda.get_sync_debug_mode() == 0
    before = fedagg_mod.fedagg.launches
    plain = RoundEngine(SimConfig(**cfg)).run()
    assert fedagg_mod.fedagg.launches - before == sanitized_launches >= 1
    assert res.history and res.history == plain.history
    assert res.sim_hours == plain.sim_hours


@pytest.mark.cuda
def test_sync_mode_refuses_an_implicit_copy_on_card():
    _need_card()
    t = torch.arange(4.0, device="cuda")
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sanitized(device="cuda"):
            t.cpu()
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sanitized(device="cuda"):
            torch.ones(3).to("cuda")
    with sanitized(device="cuda"):
        out = to_host(t * 2)
    assert out.tolist() == [0.0, 2.0, 4.0, 6.0]
    assert torch.cuda.get_sync_debug_mode() == 0
