"""The benchmark's inputs that stand in for a model's weights, made on the
device from the seed in a few large draws, in the type they are served
in. The reference draws them again from the same seed.

The leaves are the benchmark's own list, from the configuration's sizes;
the runners check that the program's parameter definitions have the
same keys and shapes before they hand the leaves over.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: Elements of one normal draw (the generator's calls stay well inside
#: 32-bit offsets).
DRAW = 1 << 28


def stream_seed(seed: int, stream: int) -> int:
    """A seed of its own for each input stream of one run's seed."""
    state = np.random.SeedSequence([seed % 2**64, stream]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def draw_normal(n: int, dtype: torch.dtype, gen: torch.Generator,
                device) -> torch.Tensor:
    out = torch.empty(n, dtype=dtype, device=device)
    for i in range(0, n, DRAW):
        out[i:i + DRAW] = torch.randn(min(DRAW, n - i), dtype=dtype,
                                      generator=gen, device=device)
    return out


def materialize(specs: list, seed: int, device, dtype: torch.dtype
                ) -> dict:
    """``specs``: ``(key, shape, std)`` with ``std`` None for a leaf of
    ones and 0.0 for zeros. The normal leaves are slices of one draw,
    scaled in place, in the order of ``specs``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    n = sum(math.prod(s) for _, s, std in specs if std)
    flat = draw_normal(n, dtype, gen, device)
    out, at = {}, 0
    for key, shape, std in specs:
        if std is None:
            out[key] = torch.ones(shape, dtype=dtype, device=device)
        elif std == 0.0:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            size = math.prod(shape)
            out[key] = flat[at:at + size].view(shape).mul_(std)
            at += size
    return out


def cnn_specs(cfg: dict) -> list:
    """The paper's CNN: HWIO convolutions, ``(in, out)`` dense layers; the
    standard deviations the configuration states."""
    c = cfg["cnn"]
    c1, c2 = c["channels"]
    k, std = c["kernel"], cfg["init_std"]
    flat = (c["image_size"] // 4) ** 2 * c2
    return [("conv1_w", (k, k, 1, c1), std["conv1_w"]),
            ("conv1_b", (c1,), 0.0),
            ("conv2_w", (k, k, c1, c2), std["conv2_w"]),
            ("conv2_b", (c2,), 0.0),
            ("fc1_w", (flat, c["hidden"]), 1 / math.sqrt(flat)),
            ("fc1_b", (c["hidden"],), 0.0),
            ("fc2_w", (c["hidden"], c["num_classes"]),
             1 / math.sqrt(c["hidden"])),
            ("fc2_b", (c["num_classes"],), 0.0)]


def mla_lm_specs(cfg: dict) -> list:
    """The MLA decoder's leaves, stacked over its layers as
    ``layers/b0/...``, in sorted key order. Every matrix is drawn at its
    own fan-in (its input width); the tied table at the standard
    deviation the configuration states; the norms' gains are ones."""
    d, h, L = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["num_hidden_layers"])
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    ql, kvl, ff = cfg["q_lora_rank"], cfg["kv_lora_rank"], \
        cfg["intermediate_size"]

    def mat(din, dout):
        return (L, din, dout), 1 / math.sqrt(din)
    m = "layers/b0/mixer/"
    leaves = {
        "embed/table": ((cfg["vocab_size"], d), cfg["init_std"]["embed"]),
        "final_norm/scale": ((d,), None),
        m + "kv_norm": ((L, kvl), None),
        m + "q_norm": ((L, ql), None),
        m + "w_dkv": mat(d, kvl),
        m + "w_dq": mat(d, ql),
        m + "w_kr": mat(d, rope),
        m + "w_uk": mat(kvl, h * nope),
        m + "w_uq": mat(ql, h * (nope + rope)),
        m + "w_uv": mat(kvl, h * dv),
        m + "wo": mat(h * dv, d),
        "layers/b0/mlp/w_down": mat(ff, d),
        "layers/b0/mlp/w_gate": mat(d, ff),
        "layers/b0/mlp/w_up": mat(d, ff),
        "layers/b0/norm1/scale": ((L, d), None),
        "layers/b0/norm2/scale": ((L, d), None),
    }
    return [(k, *leaves[k]) for k in sorted(leaves)]
