"""Time the flash attention backward on the card at the training slice's
shape (B=2, H=16, Hkv=8, S=1024, D=128) and the serve prefill's (B=4,
S=4096), bf16, causal, on the model's (B, S, H, D) views: the three
kernels of one ``flash_attention_bwd`` call as device time, the stream
held busy by a sleep kernel while the host enqueues the calls, as
``chip_smoke.py`` times ``device_ms``; the forward kernel (no lse, as
serving calls it) the same way, and SDPA's backward beside them as the
yardstick.

Prints one JSON line: the device ms at each shape, the backward's
device time a call by kernel (torch.profiler over 5 calls), its variant
counts where the checkout has them, and the card's name and power
limit.

    PYTHONPATH=src python -m repro_torch.launch.flash_bwd_time

It uses only what earlier versions of the port also have
(``flash_attention_fwd(..., with_lse=True)``, ``flash_attention_bwd``),
so a copy of this file in an older checkout's ``src/repro_torch/launch/``
times that checkout's backward; run both in one call on one card to
compare them.
"""
from __future__ import annotations

import json
import subprocess

import torch

SHAPES = {"train": dict(b=2, h=16, hkv=8, s=1024, d=128),
          "serve": dict(b=4, h=16, hkv=8, s=4096, d=128)}


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls after 2
    warm-ups, enqueued behind a ~25 ms sleep kernel so that each call's
    host cost is hidden."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e7))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def by_kernel_us(fn, calls: int = 5) -> dict:
    """Device us a call of each kernel ``fn`` launches, from
    torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = (ev.name.replace("(anonymous namespace)::", "")
                    .split("(")[0].split("<")[0].split("::")[-1].split()[-1])
            out[name] = (out.get(name, 0.0)
                         + ev.time_range.elapsed_us() / calls)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_time: needs an NVIDIA card")

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {}
    for label, c in SHAPES.items():
        b, h, hkv, s, d = (c[x] for x in ("b", "h", "hkv", "s", "d"))
        q, k, v, do = (torch.randn((b, s, n, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       .transpose(1, 2) for n in (h, hkv, hkv, h))
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        reps = 20 if label == "train" else 5
        row = {"device_ms": device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), reps),
            "fwd_device_ms": device_ms(
                lambda: fa.flash_attention_fwd(q, k, v), 4 * reps),
            "by_kernel_us": by_kernel_us(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))}
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        ref = torch.nn.functional.scaled_dot_product_attention(
            *qkv, is_causal=True, enable_gqa=True)
        row["sdpa_device_ms"] = device_ms(
            lambda: torch.autograd.grad(ref, qkv, do, retain_graph=True),
            reps)
        out[label] = row
        del q, k, v, do, o, lse, qkv, ref
        torch.cuda.empty_cache()
    fn = fa.flash_attention
    out["variants"] = {x: getattr(fn, x) for x in
                       ("launches_bwd", "launches_bwd_tc",
                        "launches_bwd_simt") if hasattr(fn, x)}
    out["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
