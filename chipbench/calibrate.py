"""Readings that the limits of a cell's check are set from: on each seed
the program's numbers against the plain reference (sound runs), the
control's (the reference in the precision below the configuration's,
put in the program's place), and a planted fault's (half of each batch
left out of the program's step, the mean taken over the rest).

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

Runs the cell's set-up (no measured window) once a seed, in one process,
and prints one JSON line a reading. The benchmark's own runs never run
it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chipbench import harness  # noqa: E402


@contextlib.contextmanager
def half_batch(runner_name: str):
    """Plant the fault in the program: every local step sees the first
    half of its batch (the first half of the sequence where the batch is
    one row), the mean loss taken over it."""
    if runner_name == "fedround":
        from repro_torch.launch import train
        real = train.single_device_round

        def planted(model, fed):
            step = real(model, fed)

            def broken(params, batch, sizes, visible):
                b, s = batch["tokens"].shape[1:]
                cut = ((slice(None), slice(0, b // 2)) if b > 1
                       else (slice(None), slice(None), slice(0, s // 2)))
                return step(params, {k: v[cut] for k, v in batch.items()},
                            sizes, visible)
            return broken
        train.single_device_round = planted
        try:
            yield
        finally:
            train.single_device_round = real
    elif runner_name == "sim":
        from repro_torch.sim.trainer import LocalTrainer
        real = LocalTrainer.multi_step

        def broken(self, stacked, images, labels):
            half = images.shape[2] // 2
            return real(self, stacked, images[:, :, :half],
                        labels[:, :, :half])
        LocalTrainer.multi_step = broken
        try:
            yield
        finally:
            LocalTrainer.multi_step = real
    else:
        raise ValueError(runner_name)


def program_numbers(runner, cell, log, ref_cache: dict) -> dict:
    """The program's numbers on ``cell.seed`` against the reference (and
    the reference's answer, kept in ``ref_cache`` for the control)."""
    import torch
    st = runner.setup(cell, log)
    if cell.workload["runner"] == "sim":
        st.runs.append(st.warm)
    runner.release(st)
    if cell.workload["runner"] == "sim":
        ref = runner.reference(st)
        found, _ = runner.compare(st.runs, *ref, cell.workload["limits"])
    else:
        ref = runner.reference(st)
        found = runner.compare(st.losses, st.changes, ref)
    ref_cache[cell.seed] = (st, ref)
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return found


def control_numbers(runner, st, ref, cell) -> dict:
    if cell.workload["runner"] == "sim":
        found, _ = runner.compare([runner.reference(st, tf32=True)], *ref,
                                  cell.workload["limits"])
        return found
    losses, _, changes = runner.reference(st, control=True)
    return runner.compare(losses, changes, ref)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    harness.setup_environment()
    import torch

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    def log(msg):
        print(f"[calibrate {time.perf_counter() - T_START:8.1f}s] {msg}",
              file=sys.stderr, flush=True)

    bench = harness.manifest()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    workload = dict(harness.load_json("workloads", args.workload),
                    chips=entry["chips"])
    config = harness.load_json("configs", workload["config"])
    runner = harness.load_module("runners", workload["runner"])
    device = torch.device("cuda", 0)

    def emit(kind, seed, found):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, **found}), flush=True)

    def cell(seed):
        return harness.Cell(args.workload, workload, config, seed, 0.0,
                            False, device)
    controls = set(seeds(args.control_seeds))
    cache: dict = {}
    for seed in seeds(args.seeds):
        emit("sound", seed, program_numbers(runner, cell(seed), log, cache))
        if seed in controls:
            st, ref = cache[seed]
            emit("control", seed, control_numbers(runner, st, ref,
                                                  cell(seed)))
        cache.clear()
        torch.cuda.empty_cache()
    for seed in seeds(args.fault_seeds):
        with half_batch(workload["runner"]):
            emit("half_batch", seed,
                 program_numbers(runner, cell(seed), log, cache))
        cache.clear()
        torch.cuda.empty_cache()
    print(f"calibrate: {args.workload} done in "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
