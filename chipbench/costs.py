"""The yardstick's arithmetic: the card's peaks and the work of each call
and each model, counted from shapes.

Copied from the port's own cost functions (``kernels/flash_attention.py``
``flash_attention_cost`` / ``flash_attention_bwd_cost``,
``kernels/fedagg.py`` ``fedagg_cost``) and peaks (``launch/roofline.py``)
so that a later change to the program cannot move the benchmark's
bounds. Each input byte is counted read once and each output byte
written once; the FLOP are the algorithm's, not what a kernel issues.
"""
from __future__ import annotations

import math

#: NVIDIA H100 SXM5 80GB data sheet, dense, at its 700 W limit.
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flop: float, nbytes: float, flop_per_s: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flop / flop_per_s, nbytes / HBM_BYTES_PER_S)


def causal_pairs(s: int) -> int:
    """Visible (query, key) pairs of one causal head of length ``s``."""
    return s * (s + 1) // 2


def flash_fwd_cost(b: int, h: int, s: int, d: int, dv: int,
                   itemsize: int) -> tuple[int, int]:
    """(FLOP, bytes) of one causal forward call with its log-sum-exp:
    2D + 2Dv FLOP a visible pair; q, k, v read and o written once, the
    f32 lse written once."""
    flop = b * h * causal_pairs(s) * 2 * (d + dv)
    nbytes = itemsize * b * h * s * (2 * d + 2 * dv) + 4 * b * h * s
    return flop, nbytes


def flash_bwd_cost(b: int, h: int, s: int, d: int, dv: int,
                   itemsize: int) -> tuple[int, int]:
    """(FLOP, bytes) of one causal backward call: 6D + 4Dv FLOP a visible
    pair (QKᵀ again, dP, dV, dQ, dK); q, k, v, o, dO and the lse read
    once, dq, dk and dv written once."""
    flop = b * h * causal_pairs(s) * (6 * d + 4 * dv)
    nbytes = itemsize * 2 * b * h * s * (2 * d + 2 * dv) + 4 * b * h * s
    return flop, nbytes


def fold_cost(s: int, p: int, itemsize: int) -> tuple[int, int]:
    """(FLOP, bytes) of one weighted fold of ``s`` rows of ``p`` values: a
    multiply and an add per row and value (f32, outside the tensor
    cores); each row read once, the output written once, the ``s`` f32
    weights read once."""
    return 2 * s * p, (s + 1) * p * itemsize + 4 * s


def cnn_forward_flop(image: int, channels: tuple, kernel: int, hidden: int,
                     classes: int) -> int:
    """Multiply-add FLOP (2 a product) of one sample through the paper's
    CNN: two SAME convolutions, each followed by a 2x2 pool, then two
    dense layers. Pools, biases and activations are not counted."""
    c1, c2 = channels
    k2 = kernel * kernel
    conv1 = image * image * c1 * k2 * 1
    conv2 = (image // 2) ** 2 * c2 * k2 * c1
    flat = (image // 4) ** 2 * c2
    return 2 * (conv1 + conv2 + flat * hidden + hidden * classes)


def mla_lm_matmul_params(cfg: dict) -> int:
    """Parameters of the MLA decoder that a token multiplies by in the
    forward: every projection, the MLP, and the tied unembedding (the
    embedding lookup multiplies nothing)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    per_layer = (d * cfg["q_lora_rank"] + cfg["q_lora_rank"] * h * qd
                 + d * cfg["kv_lora_rank"]
                 + cfg["kv_lora_rank"] * h * cfg["qk_nope_head_dim"]
                 + cfg["kv_lora_rank"] * h * cfg["v_head_dim"]
                 + d * cfg["qk_rope_head_dim"]
                 + h * cfg["v_head_dim"] * d
                 + 3 * d * cfg["intermediate_size"])
    return cfg["num_hidden_layers"] * per_layer + cfg["vocab_size"] * d


def mla_lm_train_flop(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOP of one training step (forward and backward) of one
    satellite on ``batch`` sequences of ``seq`` tokens: 6 a matmul
    parameter a token, and the causal attention's forward (QKᵀ and PV,
    2 FLOP a product) three times (its backward counted as twice its
    forward). Recomputation under remat is not counted."""
    tokens = batch * seq
    qd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn_fwd = (batch * cfg["num_attention_heads"] * causal_pairs(seq)
                * 2 * (qd + cfg["v_head_dim"]))
    return (6 * mla_lm_matmul_params(cfg) * tokens
            + 3 * attn_fwd * cfg["num_hidden_layers"])


def pct(x: float) -> float:
    """A share as a percentage, refusing the impossible."""
    if not math.isfinite(x) or x < 0:
        raise ValueError(f"share {x} is not a share")
    return 100.0 * x
