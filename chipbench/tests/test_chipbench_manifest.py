"""BENCHMARK.json against the contract it is written to, and every cell's
files found by name."""
import json
import re

import pytest

from chipbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert BENCH["paths"] == ["chipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24        # the most cells a later benchmark may hold
    need = ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200)
    assert need <= 43200


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chipbench/")
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "name"] == c["name"]
        assert set(c["reduced"]) <= set(json.loads(
            (harness.ROOT / c["file"]).read_text())["reduced"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    wl = harness.load_json("workloads", cell)
    assert wl["config"] == entry["config"]
    harness.load_json("configs", wl["config"])
    runner = harness.load_module("runners", wl["runner"])
    for fn in ("setup", "unit", "window_metrics", "context", "release",
               "check"):
        assert callable(getattr(runner, fn))
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
