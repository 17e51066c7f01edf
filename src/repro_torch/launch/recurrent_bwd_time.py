"""Time the backward kernels of the two recurrences on the card, as
device time (the stream held busy by a sleep kernel while the host
enqueues the calls, as ``chip_smoke.py`` times ``device_ms``), with each
call's split by kernel (torch.profiler over 5 calls) and the forward
kernel beside it:

- ``rwkv6_wkv_bwd`` at rwkv6-3b's training slice's shape (B=2, H=40,
  S=1024, N=64) and the serve prefill's (B=4, S=4096), bf16 r, k, v, dy
  and f32 w on the model's (B, S, H, N) views, given the checkpoints of
  the forward kernel (as training runs it; ``device_ms``), and beside it
  the forward with those checkpoint stores (``fwd_ckpt_device_ms``), the
  serving forward (``fwd_device_ms``) and the backward that makes its
  own checkpoints (``standalone_device_ms``);
- ``selective_scan_bwd`` at jamba's training shape (B=2, S=1024, D=8192,
  N=16) and the serve prefill's (B=4, S=4096), abar f32 and bx, c, dy
  bf16, c a strided view as the model's, with the same split: given the
  forward kernel's checkpoints, the checkpointing and the serving
  forward, and the backward making its own checkpoints.

At the training shapes it also holds each kernel to its plain version
(the largest difference over the gradients, relative to the largest
gradient) and times the plain version once. Prints one JSON line with
the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.launch.recurrent_bwd_time
"""
from __future__ import annotations

import functools
import json
import subprocess
import time

import torch

from repro_torch.launch.flash_bwd_time import by_kernel_us, device_ms

WKV = {"train": dict(b=2, h=40, s=1024, n=64),
       "serve": dict(b=4, h=40, s=4096, n=64)}
SCAN = {"train": dict(b=2, s=1024, d=8192, n=16),
        "serve": dict(b=4, s=4096, d=8192, n=16)}


def wkv_inputs(gen, b, h, s, n):
    """r, k, v, w, u, dy as the model passes them: bf16 (B, S, H, N)
    storage viewed as (B, H, S, N), w f32 at decays in [0.7, 0.999]."""
    bf16 = torch.bfloat16
    r, k, v, dy = (torch.randn((b, s, h, n), generator=gen, device="cuda")
                   .to(bf16).transpose(1, 2) for _ in range(4))
    w = (0.7 + 0.299 * torch.rand((b, s, h, n), generator=gen,
                                  device="cuda")).transpose(1, 2)
    u = torch.randn((h, n), generator=gen, device="cuda")
    return r, k, v, w, u, dy


def scan_inputs(gen, b, s, d, n):
    """abar f32 in [0.8, 0.999], bx bf16, c a bf16 strided view, dy
    bf16."""
    abar = 0.8 + 0.199 * torch.rand((b, s, d, n), generator=gen,
                                    device="cuda")
    bx = torch.randn((b, s, d, n), generator=gen,
                     device="cuda").to(torch.bfloat16)
    c = torch.randn((b, s, 2 * n + 3), generator=gen,
                    device="cuda").to(torch.bfloat16)[..., 3 + n:]
    dy = torch.randn((b, s, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return abar, bx, c, dy


def rel_err(got, want) -> float:
    """max |got - want| over all gradients / max |want| over all."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    return err / max(float(w.float().abs().max()) for w in want)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("recurrent_bwd_time: needs an NVIDIA card")

    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import selective_scan as scan

    gen = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {"rwkv6_wkv_bwd": {}, "selective_scan_bwd": {}}
    for kind, shapes, make, bwd, fwd, fwd_ckpt, plain in (
            ("rwkv6_wkv_bwd", WKV, wkv_inputs, wkv.rwkv6_wkv_bwd,
             wkv.rwkv6_wkv_fwd, wkv.rwkv6_wkv_fwd_ckpt,
             wkv.rwkv6_wkv_bwd_plain),
            ("selective_scan_bwd", SCAN, scan_inputs, scan.selective_scan_bwd,
             scan.selective_scan_fwd, scan.selective_scan_fwd_ckpt,
             scan.selective_scan_bwd_plain)):
        for label, c in shapes.items():
            args = make(gen, *c.values())
            reps = 20 if label == "train" else 5
            # The backward as training runs it: on the checkpoints of the
            # forward kernel over the same inputs.
            ckpts = fwd_ckpt(*args[:-1])[1:]
            run = functools.partial(bwd, *args, *ckpts)
            row = {"device_ms": device_ms(run, reps),
                   "fwd_ckpt_device_ms": device_ms(
                       lambda: fwd_ckpt(*args[:-1]), reps),
                   "fwd_device_ms": device_ms(lambda: fwd(*args[:-1]),
                                              reps),
                   "standalone_device_ms": device_ms(lambda: bwd(*args),
                                                     reps),
                   "by_kernel_us": by_kernel_us(run)}
            if label == "train":
                got = run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = plain(*args)
                torch.cuda.synchronize()
                row["plain_ms"] = 1e3 * (time.perf_counter() - t0)
                row["rel_err_vs_plain"] = rel_err(got, want)
                del got, want
            out[kind][label] = row
            del args, run, ckpts
            torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
