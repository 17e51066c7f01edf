"""Time the FedHAP fold on the card: the paper CNN's 8 leaves stacked over
S replicas in f32 (S=40 in the default simulation), folded by
``ops.fedagg_tree`` as a round folds them, timed two ways:

- back to back: ``reps`` calls between two CUDA events, each call's host
  cost (ctypes, allocation) included, as ``chip_smoke.py`` times the
  kernels line's ``ms``;
- device time: the same with the stream held busy by a sleep kernel while
  the host enqueues the calls, so that the host's cost is hidden, as
  ``chip_smoke.py`` times ``device_ms``.

Prints one JSON line: both times, the ``fedagg`` launches per fold, and
the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.launch.fold_time [--replicas 40]

It uses only what earlier versions of the port also have
(``ops.fedagg_tree``, ``fedagg.fedagg.launches``, ``models.cnn``), so a
copy of this file in an older checkout's ``src/repro_torch/launch/``
times that checkout's fold; run both in one session on one card to
compare them.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch


def _timed(fn, reps: int, busy: bool) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after 3 warm-ups;
    with ``busy`` the stream first runs a ~25 ms sleep kernel, so that
    the calls are enqueued before the device reaches them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if busy:
        torch.cuda._sleep(int(5e7))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicas", type=int, default=40)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fold_time: needs an NVIDIA card")

    from repro_torch.configs.paper_cnn import PaperCnnConfig
    from repro_torch.kernels import fedagg, ops
    from repro_torch.models.cnn import CNN

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    s = args.replicas
    tree = {k: torch.randn((s, *d.shape), generator=gen, device="cuda")
            for k, d in CNN(PaperCnnConfig()).defs().items()}
    w = torch.rand(s, generator=gen, device="cuda")
    fold = lambda: ops.fedagg_tree(tree, w)                    # noqa: E731
    fold()
    torch.cuda.synchronize()
    before = fedagg.fedagg.launches
    fold()
    launches = fedagg.fedagg.launches - before
    nbytes = sum((x.numel() + x[0].numel()) * 4 for x in tree.values()) \
        + 4 * s
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        leaves=len(tree), replicas=s, bytes=nbytes, launches=launches,
        back_to_back_ms=_timed(fold, args.reps, busy=False),
        device_ms=_timed(fold, args.reps, busy=True), card=card)),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
