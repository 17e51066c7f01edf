"""Time flash attention's kernels on the card, both routes, causal, on the
model's (B, S, H, D) views:

- ``tc`` (bf16): the training slice's shape (B=2, H=16, Hkv=8, S=1024,
  D=128) and the serve prefill's (B=4, S=4096); MLA's (96, 64) pair
  (minicpm3-4b) at its training shape (``mla_train``: B=2, H=Hkv=40,
  S=1024) and its prefill shape (``mla_serve``: B=4, S=4096);
- ``mma`` (f32 at every head dim, bf16 at D in {8, 24}): the example
  LM's (f32, B=2, H=4, Hkv=2, S=256, D=64), the reduced MLA's (24, 16)
  pair at B=2, H=4, S=256 in bf16 and f32, MLA's training shape in f32
  (B=2, H=Hkv=40, S=1024, (96, 64)), qwen's training shape in f32 and
  the f32 prefill (B=4, H=16, Hkv=8, S=4096, D=128, forward only).

For each: the forward (no lse, as serving calls it) and the backward as
device time, the stream held busy by a sleep kernel while the host
enqueues the calls, as ``chip_smoke.py`` times ``device_ms``; the
backward's device time a call by kernel (torch.profiler over 5 calls);
SDPA's forward and backward in the same dtype as the yardstick; the
largest error against the plain versions; whether two backward calls are
bit-equal; and the bounds, the function's FLOP and bytes over the card's
rates (``roofline.bound_ms``: bf16 on the tensor cores, f32 on them as
3xTF32). Prints one JSON line with the variant counts where the
checkout has them and the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.launch.flash_bwd_time [SHAPE ...]

Given shape labels (``train serve mla_train mla_serve``, say), it times
those alone, in that order; by default every shape.

It uses only what earlier versions of the port also have
(``flash_attention_fwd(..., with_lse=True)``, ``flash_attention_bwd``,
the plain versions and the ``*_cost`` functions), so a copy of this file
in an older checkout's ``src/repro_torch/launch/`` times that checkout's
kernels (leaving out the bounds where its ``roofline`` has no 3xTF32
rate); run both in one call on one card to compare them.
"""
from __future__ import annotations

import json
import subprocess

import torch

SHAPES = {
    "train": dict(dtype="bfloat16", b=2, h=16, hkv=8, s=1024, d=128,
                  dv=128, bwd=True),
    "serve": dict(dtype="bfloat16", b=4, h=16, hkv=8, s=4096, d=128,
                  dv=128, bwd=True),
    "mla_train": dict(dtype="bfloat16", b=2, h=40, hkv=40, s=1024, d=96,
                      dv=64, bwd=True),
    "mla_serve": dict(dtype="bfloat16", b=4, h=40, hkv=40, s=4096, d=96,
                      dv=64, bwd=True),
    "example_f32": dict(dtype="float32", b=2, h=4, hkv=2, s=256, d=64,
                        dv=64, bwd=True),
    "reduced_mla_bf16": dict(dtype="bfloat16", b=2, h=4, hkv=4, s=256,
                             d=24, dv=16, bwd=True),
    "reduced_mla_f32": dict(dtype="float32", b=2, h=4, hkv=4, s=256, d=24,
                            dv=16, bwd=True),
    "mla_train_f32": dict(dtype="float32", b=2, h=40, hkv=40, s=1024, d=96,
                          dv=64, bwd=True),
    "train_f32": dict(dtype="float32", b=2, h=16, hkv=8, s=1024, d=128,
                      dv=128, bwd=True),
    "prefill_f32": dict(dtype="float32", b=4, h=16, hkv=8, s=4096, d=128,
                        dv=128, bwd=False),
}


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls after 2
    warm-ups, enqueued behind a ~100 ms sleep kernel so that each call's
    host cost is hidden (50 calls of autograd's SDPA backward take ~25-50
    ms to enqueue)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
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


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def time_shape(fa, c: dict, gen) -> dict:
    """One shape's readings (see the module's docstring)."""
    from repro_torch.launch import roofline

    dt = getattr(torch, c["dtype"])
    b, h, hkv, s, d, dv = (c[x] for x in ("b", "h", "hkv", "s", "d", "dv"))
    q, k, v, do = (torch.randn((b, s, n, e), generator=gen, device="cuda")
                   .to(dt).transpose(1, 2)
                   for n, e in ((h, d), (hkv, d), (hkv, dv), (h, dv)))
    reps = 5 if s * s * b * h >= 2 ** 28 else 50
    shapes = (tuple(q.shape), tuple(k.shape), tuple(v.shape), dt)
    bounds = hasattr(roofline, "TF32X3_FLOP_PER_S")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    row = {"fwd_device_ms": device_ms(lambda: fa.flash_attention_fwd(q, k, v),
                                      reps),
           "fwd_err": _err(o, fa.flash_attention_plain(q, k, v))}
    with torch.no_grad():
        row["sdpa_fwd_device_ms"] = device_ms(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), reps)
    if bounds:
        row["fwd_bound_ms"], row["fwd_bound_by"] = roofline.bound_ms(
            *fa.flash_attention_cost(*shapes), True, f32=dt == torch.float32)
    if c["bwd"]:
        bwd = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
        row["bwd_device_ms"] = device_ms(bwd, reps)
        row["bwd_by_kernel_us"] = by_kernel_us(bwd)
        got, again = bwd(), bwd()
        row["bwd_bit_equal"] = all(torch.equal(x, y)
                                   for x, y in zip(got, again))
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        row["bwd_err"] = max(_err(x, w) for x, w in zip(got, want))
        del got, again, want
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        ref = sdpa(*qkv, is_causal=True, enable_gqa=True)
        row["sdpa_bwd_device_ms"] = device_ms(
            lambda: torch.autograd.grad(ref, qkv, do, retain_graph=True),
            reps)
        if bounds:
            row["bwd_bound_ms"], row["bwd_bound_by"] = roofline.bound_ms(
                *fa.flash_attention_bwd_cost(*shapes), True,
                f32=dt == torch.float32)
    return row


def main(argv: list[str] | None = None) -> int:
    import sys

    labels = sys.argv[1:] if argv is None else argv
    unknown = set(labels) - set(SHAPES)
    if unknown:
        raise SystemExit(f"flash_bwd_time: no shape {sorted(unknown)}; "
                         f"the shapes are {list(SHAPES)}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_time: needs an NVIDIA card")

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {}
    for label in labels or SHAPES:
        out[label] = time_shape(fa, SHAPES[label], gen)
        torch.cuda.empty_cache()
    fn = fa.flash_attention
    out["variants"] = {x: getattr(fn, x) for x in dir(fn)
                       if x.startswith("launches")}
    out["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
