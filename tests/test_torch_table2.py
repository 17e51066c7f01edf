"""The paper's Table II on the port (``repro_torch.launch.table2``)
against the JAX package's ``benchmarks.bench_table2.run``.

- Both tiers' seven row configs equal the reference's field for field
  (the reference's configs captured with its ``SatcomSimulator``
  stubbed, so nothing runs).
- Each row at a tiny size (the MLP on a 2x8 shell: a 2x4 plane has no
  intra-plane line of sight) from the same JAX init: rounds, sim hours
  and the (hours, round) columns equal (the plan half is numpy in both),
  every accuracy within one eval sample (``tests/test_torch_sim.py``'s
  tolerance).
- The rows carry the reference's keys and rounding; the default device
  is the card.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmarks import bench_table2
from repro.sim import SatcomSimulator as JaxSimulator, SimResult
from repro_torch.core.strategies import TABLE2_SETUPS
from repro_torch.launch import table2

torch.set_num_threads(2)

ROWS = list(TABLE2_SETUPS)
# Every row's config cut to a few seconds on the CPU in both packages.
TINY = dict(num_orbits=2, sats_per_orbit=8, num_samples=1500,
            eval_samples=300, local_steps=4, max_rounds=4,
            learning_rate=0.1)
# A target the tiny runs reach, so hours_to_<target> is compared too.
TARGET = 0.3
HOURS = f"hours_to_{int(TARGET * 100)}pct"


class _Recorder:
    """Stands in for the reference's ``SatcomSimulator``: records the
    config and returns a one-entry result without running."""
    seen: list = []

    def __init__(self, cfg):
        self.seen.append(cfg)

    def run(self):
        return SimResult([(1.0, 1, 0.5)], 0.5, 1, 1.0)


def _reference_configs(monkeypatch, quick: bool) -> dict:
    _Recorder.seen = []
    monkeypatch.setattr(bench_table2, "SatcomSimulator", _Recorder)
    rows = bench_table2.run(quick=quick)
    return {r["method"]: cfg for r, cfg in zip(rows, _Recorder.seen)}


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_tier_settings_equal_the_reference(monkeypatch, quick, row):
    want = _reference_configs(monkeypatch, quick)
    assert list(want) == ROWS
    got = table2.configs(quick=quick)
    assert list(got) == ROWS
    jf = {f.name for f in dataclasses.fields(want[row])}
    assert {f.name for f in dataclasses.fields(got[row])} - jf == {"device"}
    assert got[row].device == "cuda"
    for name in sorted(jf):
        assert getattr(got[row], name) == getattr(want[row], name), name
    assert table2.configs(quick, methods=[row]) == {row: got[row]}


@pytest.fixture(scope="module")
def runs():
    """Both packages' rows and raw results at ``TINY``, every row from
    the JAX package's init (shared: the rows run one model and seed)."""
    jax_results, port_results = [], []

    def jax_sim(cfg):
        eng = JaxSimulator(dataclasses.replace(cfg, **TINY))
        run = eng.run
        eng.run = lambda: jax_results.append(run()) or jax_results[-1]
        return eng

    class PortSim(table2.SatcomSimulator):
        def run(self, *args, **kw):
            port_results.append(super().run(*args, **kw))
            return port_results[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_table2, "SatcomSimulator", jax_sim)
        jax_rows = bench_table2.run(quick=True, target=TARGET)
        init = {k: np.asarray(v) for k, v in JaxSimulator(
            dataclasses.replace(bench_table2.TABLE2_SETUPS["FedHAP-GS"],
                                **{**table2.QUICK, **TINY})
        ).trainer.init(0).items()}
        mp.setattr(table2, "SatcomSimulator", PortSim)
        port_rows = table2.run(quick=True, target=TARGET, device="cpu",
                               init_params=init, **TINY)
    return dict(zip(ROWS, zip(jax_rows, port_rows, jax_results,
                              port_results)))


@pytest.mark.parametrize("row", ROWS)
def test_row_matches_jax_at_tiny_size(runs, row):
    want, got, want_res, got_res = runs[row]
    assert got["method"] == want["method"] == row
    assert got["rounds"] == want["rounds"] and got["rounds"] >= 2
    assert got["sim_hours"] == want["sim_hours"]
    assert got_res.sim_hours == want_res.sim_hours
    assert [(t, r) for t, r, _ in got_res.history] == \
        [(t, r) for t, r, _ in want_res.history]
    tol = 1.0 / TINY["eval_samples"] + 1e-7
    for (_, _, a_g), (_, _, a_w) in zip(got_res.history, want_res.history):
        assert abs(a_g - a_w) <= tol
    assert abs(got["final_acc"] - want["final_acc"]) <= tol + 1e-4
    # Hours to the target agree unless an accuracy lies within one eval
    # sample of it.
    if all(abs(a - TARGET) > tol for _, _, a in want_res.history):
        assert got[HOURS] == want[HOURS]


def test_tiny_rows_train_and_reach_the_target(runs):
    """The tiny size is not all chance: some rows reach ``TARGET``."""
    reached = [row for row, (_, got, _, _) in runs.items()
               if got[HOURS] is not None]
    assert reached, {row: got["final_acc"] for row, (_, got, _, _)
                     in runs.items()}


@pytest.mark.parametrize("row", ROWS)
def test_rows_keep_the_reference_keys_and_rounding(runs, row):
    want, got, _, res = runs[row]
    assert list(got) == list(want)
    assert got["final_acc"] == round(res.final_accuracy, 4)
    assert got["sim_hours"] == round(res.sim_hours, 2)
    tta = res.time_to_accuracy(TARGET)
    assert got[HOURS] == (round(tta, 2) if tta else None)
    assert got["history"] == [(round(t, 2), round(a, 4))
                              for t, _, a in res.history]
    assert isinstance(got["wall_s"], float) \
        and got["wall_s"] == round(got["wall_s"], 1)


def test_default_device_is_the_card():
    """Without a device the rows ask for the card: here, where there is
    none, the engine raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    assert table2.configs(methods=["FedHAP-oneHAP"])[
        "FedHAP-oneHAP"].device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        table2.run(methods=["FedHAP-oneHAP"], **TINY)
