"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, each fault the cell can have planted in the program.
The limits are the cells' own; the LM cells run in f32 here, where the
sound program meets the reference to ~1e-6 (``test_chipbench_reference``)
and a fault's failure is its own."""
import contextlib
import json

import pytest
import torch

import _tiny
from chipbench import calibrate, harness


@contextlib.contextmanager
def patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def unchanged_step(model, fed):
    """A round that returns its state as it came."""
    def step(params, batch, sizes, visible):
        return params, {"local_loss": torch.tensor(0.0)}
    return step


@pytest.mark.parametrize("name", _tiny.LM_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "token_altered"])
def test_lm_fault_is_caught(name, fault):
    from repro_torch.launch import train
    from repro_torch.core import fed_step
    cell = _tiny.lm_cell(name, dtype="float32")
    if fault == "unchanged":
        ctx = patched(train, "single_device_round", unchanged_step)
    elif fault == "half_batch":
        ctx = calibrate.half_batch("fedround")
    else:
        real = fed_step.satellite_loss

        def altered(model, params, batch, axis=None):
            tokens = batch["tokens"].clone()
            tokens[..., 0] = (tokens[..., 0] + 1) % model.cfg.vocab_size
            return real(model, params, dict(batch, tokens=tokens), axis)
        ctx = patched(fed_step, "satellite_loss", altered)
    with ctx:
        out = _tiny.run(cell)
    assert not out.correct, out.checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "answer_altered"])
def test_sim_fault_is_caught(fault):
    from repro_torch.sim import executor, trainer
    if fault == "unchanged":
        def step(self, stacked, images, labels):
            return stacked, torch.zeros(images.shape[:2])
        ctx = patched(trainer.LocalTrainer, "multi_step", step)
    elif fault == "half_batch":
        ctx = calibrate.half_batch("sim")
    else:
        real = executor.FusedExecutor._device_acc

        def altered(self, params):
            return real(self, params) + 1.0 / self._eval_n
        ctx = patched(executor.FusedExecutor, "_device_acc", altered)
    with ctx:
        out = _tiny.run(_tiny.sim_cell())
    assert not out.correct, out.checks


def test_result_line_schema():
    out = _tiny.run(_tiny.sim_cell())
    line = json.loads(out.line())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    e2e, _ = harness.cell_metrics(harness.manifest(), "cnn.fedhap-onehap")
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
