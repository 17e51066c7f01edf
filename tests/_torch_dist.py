"""Spawn gloo ranks for the port's mesh tests (``torch.distributed`` on
the CPU).

:func:`spawn` starts ``world`` processes of this file, each one rank of a
gloo process group made from a ``file://`` store under the caller's
directory (no network), with one thread each. Every rank calls the same
function, ``module:function`` importable from ``tests/`` (``fn(rank,
world)``), and its result (a picklable value: numpy arrays, not tensors)
comes back in rank order. Collectives time out after 60 s, the whole
spawn after ``deadline`` seconds; on a rank's failure or the deadline the
other ranks are killed at once and the error names each rank's last
output, so a hang fails within a minute instead of eating the test run.

:func:`one_rank_group` is the in-process 1-rank group, for cases that
hold a sharded program bit for bit against the unsharded one in the same
process (same threads, same allocator).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pathlib
import pickle
import subprocess
import sys
import time
from typing import Any, Iterator

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = datetime.timedelta(seconds=60)


def spawn(target: str, world: int, workdir: pathlib.Path, *,
          deadline: float = 240.0) -> list:
    """Run ``target`` on ``world`` gloo ranks; returns their results."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")])}
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, target, str(rank), str(world),
             str(store), str(workdir / f"rank{rank}.pkl")],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    end = time.monotonic() + deadline
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > end:
                failed = f"deadline of {deadline:.0f} s passed"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        tails = "\n".join(
            f"--- rank {r} ---\n"
            + (workdir / f"rank{r}.log").read_text(errors="replace")[-3000:]
            for r in range(world))
        raise AssertionError(f"{target} over {world} ranks: {failed}\n"
                             f"{tails}")
    out = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@contextlib.contextmanager
def one_rank_group(workdir: pathlib.Path) -> Iterator[None]:
    """A 1-rank gloo group in this process, destroyed on exit."""
    import torch.distributed as dist
    dist.init_process_group("gloo",
                            init_method=f"file://{workdir}/store1",
                            rank=0, world_size=1, timeout=TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(target: str, rank: int, world: int, store: str,
               out: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        result: Any = fn(rank, world)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4], sys.argv[5])
