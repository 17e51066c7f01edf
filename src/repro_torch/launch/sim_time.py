"""Time the simulator's main paths on the card, as ``chip_smoke.py``'s
phases 5 and 21 run them: the default FedHAP run
(``SimConfig(max_rounds=16)``: 40 satellites, the paper CNN, 15 rounds in
two fused blocks), fedsat/gs_np for 16 orbit-events and fedspace/gs for 4
flushes. Each run is timed on the host's clock, bracketed by
``torch.cuda.synchronize``, the engine's build excluded and its first
block included, after one untimed warm-up run of two FedHAP rounds (the
process's first convolutions pay cuDNN's and the allocator's set-up).
Each repeat runs every config twice, in alternating order: once with
cuDNN as the executor leaves it ("executor") and once with
``torch.backends.cudnn.deterministic`` cleared after the executor is
built ("cleared": cuDNN's default algorithms), so that one process
measures what the deterministic algorithms cost.

Prints one JSON line: s/round, s/orbit-event and s/flush of both kinds
with their counts and final accuracies, whether the executor left
``cudnn.deterministic`` on, and the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.launch.sim_time [--repeats 1]

It uses only what earlier versions of the port also have
(``repro_torch.sim.RoundEngine`` and ``SimConfig``), so a copy of this
file in an older checkout's ``src/repro_torch/launch/`` times that
checkout's simulator; run both in one session on one card to compare
them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

# (strategy, stations, max_rounds, unit): phase 5's run, then phase 21's.
RUNS = (("fedhap", "one_hap", 16, "round"),
        ("fedsat", "gs_np", 16, "orbit-event"),
        ("fedspace", "gs", 4, "flush"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=1,
                    help="pairs of runs of each config, each run on a "
                         "fresh engine")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sim_time: needs an NVIDIA card")
    from repro_torch.sim import RoundEngine, SimConfig

    RoundEngine(SimConfig(max_rounds=2)).run()
    out = {"runs": {}}
    for strategy, stations, max_rounds, unit in RUNS:
        times = {"executor": [], "cleared": []}
        accs = {}
        for i in range(args.repeats):
            order = ("executor", "cleared")[::1 if i % 2 == 0 else -1]
            for kind in order:
                eng = RoundEngine(SimConfig(strategy=strategy,
                                            stations=stations,
                                            max_rounds=max_rounds))
                eng.executor
                out["cudnn_deterministic"] = \
                    torch.backends.cudnn.deterministic
                before = torch.backends.cudnn.deterministic
                if kind == "cleared":
                    torch.backends.cudnn.deterministic = False
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = eng.run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    torch.backends.cudnn.deterministic = before
                # fedhap evaluates every round; fedsat's and fedspace's
                # last history row carries their orbit-event or flush
                # count.
                n = res.rounds if strategy == "fedhap" \
                    else res.history[-1][1]
                times[kind].append(wall / n)
                accs[kind] = res.history[-1][2]
                del eng
                torch.cuda.empty_cache()
        out["runs"][strategy] = {f"s_per_{unit}": times, "count": n,
                                 "final_acc": accs}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
