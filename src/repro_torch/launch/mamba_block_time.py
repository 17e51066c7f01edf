"""Time one full-width jamba-v0.1-52b Mamba block's forward and backward
on the card, as training runs it: d_model 4096 -> d_inner 8192 x 16
states, bf16, batch 2 x seq 1024, the gradients of every mixer leaf and
of the input. Device time (the stream held busy by a sleep kernel while
the host enqueues the calls, as ``chip_smoke.py`` times ``device_ms``),
three readings of 10 calls, and the device us a call spends in each
kernel whose name holds ``scan`` (torch.profiler over 3 calls) beside
the sum over all kernels. The weights are the config's init from a seed;
the kernels' work does not depend on the values.

Prints one JSON line with the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.launch.mamba_block_time

It uses only what earlier versions of the port also have
(``models.ssm.mamba_forward``, ``models.params.init_params``,
``launch.flash_bwd_time``), so a copy of this file in an older
checkout's ``src/repro_torch/launch/`` times that checkout's block; run
both in one call on one card, in turns, to compare them.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess

import torch

from repro_torch.launch.flash_bwd_time import by_kernel_us, device_ms


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mamba_block_time: needs an NVIDIA card")

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    prefix = "layers/b1/mixer/"
    defs = {k: v for k, v in Transformer(cfg).defs().items()
            if k.startswith(prefix)}
    dt = getattr(torch, cfg.param_dtype)
    mixer = {k.removeprefix(prefix): v[0] for k, v in init_params(
        defs, torch.Generator(device="cuda").manual_seed(0), "cuda",
        dt).items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen,
                    device="cuda").to(dt)
    weight = torch.randn(x.shape, generator=gen, device="cuda")

    def step():
        leaves = {k: v.detach().requires_grad_() for k, v in mixer.items()}
        xx = x.detach().requires_grad_()
        out = ssm.mamba_forward(cfg, leaves, xx)
        return torch.autograd.grad((out.float() * weight).sum(),
                                   [*leaves.values(), xx])

    kernels = by_kernel_us(step, 3)
    out = {"device_ms": [device_ms(step, 10) for _ in range(3)],
           "scan_kernels_us": {k: v for k, v in kernels.items()
                               if "scan" in k},
           "all_kernels_us": sum(kernels.values())}
    out["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
