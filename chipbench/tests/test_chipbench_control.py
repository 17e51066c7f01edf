"""The control, the reference put in the program's place in the precision
below the configuration's, comes out not correct at a size a test run
holds: float8 products for the bf16 LM rounds (on the CPU), TF32 for the
f32 simulation (on the card only: the CPU has no TF32)."""
import pytest
import torch

import _tiny
from chipbench import harness


@pytest.mark.parametrize("name", _tiny.LM_CELLS)
def test_lm_control_fails_a_limit(name):
    cell = _tiny.lm_cell(name, dtype="float32")
    runner = harness.load_module("runners", "fedround")
    st = runner.setup(cell, lambda m: None)
    runner.release(st)
    ref = runner.reference(st)
    losses, _, changes = runner.reference(st, control=True)
    found = runner.compare(losses, changes, ref)
    limits = cell.workload["limits"]
    assert any(found[k] > limits[k] for k in found), found


@pytest.mark.cuda
def test_sim_control_fails_a_limit():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    cell = _tiny.sim_cell()
    cell.device = torch.device("cuda", 0)
    runner = harness.load_module("runners", "sim")
    st = runner.setup(cell, lambda m: None)
    runner.release(st)
    ref = runner.reference(st)
    found, _ = runner.compare([runner.reference(st, tf32=True)], *ref,
                              cell.workload["limits"])
    limits = cell.workload["limits"]
    assert any(found[k] > limits[k] for k in found), found
