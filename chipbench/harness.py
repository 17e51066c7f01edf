"""One run of one cell: set-up, the measured window, the reading of the
trace, the check of what the window produced, and the result's line.

Everything that belongs to one cell is found by name:

- ``chipbench/workloads/<cell>.json`` is the cell's traffic: the runner
  that runs it (``"runner"``), the configuration (``"config"``) and the
  traffic's parameters;
- ``chipbench/configs/<config>.json`` is the configuration as it is run;
- ``chipbench/runners/<runner>.py`` is the general code of one kind of
  traffic: its set-up, its timed unit, its end-to-end readings and its
  check against the plain reference (``chipbench/reference/``);
- ``chipbench/metrics/<metric>.py`` reads one per-layer metric from the
  traced window (``read(ctx)``, None where it finds nothing).

``BENCHMARK.json`` says which end-to-end and per-layer metrics the cell
reports, and their units.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Callable, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = pathlib.Path(__file__).resolve().parent
#: Top-level module names that no run may hold once its window has closed:
#: the JAX stack and the JAX package the port was made from. Compared
#: whole: the port, ``repro_torch``, is another name.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: The traced run's window closes at the first unit boundary after this
#: many seconds (or ``--seconds``, if shorter): reading the card's
#: activity over a 45 s window of the simulation (2.1M device operations)
#: took 150 s.
TRACE_WINDOW_S = 24.0


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"chipbench: no {kind[:-1]} named {name!r} "
                         f"({path.relative_to(ROOT)} is missing)")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``chipbench/<kind>/<name>.py`` as a module, loaded once a process
    (names may hold dots and dashes, so they are loaded by path)."""
    key = f"chipbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"chipbench: {path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries that ``cell`` reports:
    those whose ``workloads`` list it, or that have no such list."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


@dataclasses.dataclass
class Cell:
    """What a runner is given: the cell's name, traffic and configuration,
    the seed, the window's length, whether it is traced, and the
    device."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any


@dataclasses.dataclass
class Outcome:
    """One run's result, before it is printed."""
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: Optional[dict] = None

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return json.dumps(out)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated(device))


def _reset_peak(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)


def _start_profiler(device):
    """Start recording the card's activity alone (on the CPU, for the
    tests, the CPU's), through the autograd profiler's own start and stop:
    ``torch.profiler.profile`` parses every event into Python objects on
    exit, which took minutes for a window of the LM cells."""
    from torch.autograd import profiler as ap
    cuda = device.type == "cuda"
    prof = ap.profile(use_device="cuda" if cuda else None, use_kineto=True,
                      use_cpu=not cuda)
    prof._prepare_trace()
    prof._start_trace()
    return prof


def _stop_profiler() -> list:
    from torch.autograd import profiler as ap
    return ap._disable_profiler().events()


def run_cell(cell: Cell, t_start: float, bench: dict,
             runner: Any = None,
             log: Callable[[str], None] = lambda s: None) -> Outcome:
    """Set up, measure and check one cell. ``t_start`` is the process's
    start on the host clock; ``runner`` defaults to the one the workload
    names."""
    import torch

    runner = runner or load_module("runners", cell.workload["runner"])
    e2e, per_layer = cell_metrics(bench, cell.name)
    state = runner.setup(cell, log)
    _sync(cell.device)
    setup_peak = _peak(cell.device)
    _reset_peak(cell.device)
    prof = _start_profiler(cell.device) if cell.trace else None
    seconds = min(cell.seconds, TRACE_WINDOW_S) if cell.trace else \
        cell.seconds
    setup_s = time.perf_counter() - t_start
    units = 0
    t0 = time.perf_counter()
    while True:
        runner.unit(state, units)
        _sync(cell.device)
        units += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    trace = None
    if prof is not None:
        from chipbench import trace as trace_mod
        t = time.perf_counter()
        events = _stop_profiler()
        log(f"profiler stopped in {time.perf_counter() - t:.2f} s")
        trace = trace_mod.from_events(events, elapsed)
        del events
        log(f"trace read in {time.perf_counter() - t:.2f} s: "
            f"{len(trace.device_ops)} device operations, "
            f"{len(trace.host_events)} host calls")
    window_peak = _peak(cell.device)
    found = runner.window_metrics(state, units, elapsed, window_peak)
    found["setup_s"] = setup_s
    metrics = {}
    if cell.trace:
        ctx = runner.context(state, units, elapsed)
        ctx.trace = trace
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] not in found:
                raise RuntimeError(f"{cell.name}: the runner reads no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": found[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": int(cell.workload.get("chips", 1)),
              "memory_peak_bytes": max(setup_peak, window_peak)}
    breakdown = None
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps()}
    runner.release(state)
    checks, failed = runner.check(state, log)
    correct = (failed == 0 and all(c["value"] <= c["limit"]
                                   and math.isfinite(c["value"])
                                   for c in checks.values()))
    return Outcome(correct, units, failed, metrics, device, checks,
                   breakdown)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv: Optional[list] = None, t_start: Optional[float] = None
         ) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"[chipbench {time.perf_counter() - t_start:8.2f}s] {msg}",
              file=sys.stderr, flush=True)

    bench = manifest()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        raise SystemExit(f"chipbench: BENCHMARK.json has no workload "
                         f"{args.workload!r}")
    workload = dict(load_json("workloads", args.workload), chips=entry["chips"])
    config = load_json("configs", workload["config"])

    import torch
    if not torch.cuda.is_available():
        print("chipbench: torch.cuda.is_available() is False; the benchmark "
              "measures the card and has no CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"chipbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace} on {_card_line()}; torch {torch.__version__}")
    cell = Cell(args.workload, workload, config, args.seed, args.seconds,
                bool(args.trace), torch.device("cuda", 0))
    out = run_cell(cell, t_start, bench, log=log)
    bad = forbidden_loaded()
    if bad:
        print(f"chipbench: the process holds {bad} after the window; the "
              f"benchmark measures the port alone", file=sys.stderr)
        return 3
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out.correct}", file=sys.stderr, flush=True)
    print(out.line(), flush=True)
    return 0


def setup_environment() -> None:
    """Fixed cache directories inside the checkout (the port's kernels
    build into ``build/repro_torch/`` by themselves), and the port on the
    import path."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
