"""The port's qwen3-0.6b stack (``repro_torch.models.transformer``)
against the JAX package's, on the same params.

Params are made by the JAX package and carried into the port with
``params_from_numpy`` (nested tree, bf16 bit for bit); tokens come from
numpy seeds. f32 tolerance ``atol=1e-4`` as the JAX package's own
decode-vs-forward check (``tests/test_decode.py:18``): both sides are
full f32 and differ in the order of their sums (the port's attention is
the dense plain version on the CPU, the JAX package's the blockwise
jnp loop). bf16: the kernel tolerance of ``tests/test_kernels.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten as ckpt_flatten
from repro.configs import SHAPES as JAX_SHAPES, get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro.models.params import is_def
from repro.models.transformer import cross_entropy_loss as jax_ce
from repro.configs import list_configs as jax_list_configs
from repro_torch.configs import SHAPES, MoEConfig, get_config, list_configs
from repro_torch.models import (Transformer, params_from_numpy,
                                params_to_numpy)
from repro_torch.models.transformer import cross_entropy_loss

from _torch_jamba import JAMBA, chip_smoke, jamba_pair

torch.set_num_threads(2)

F32 = dict(atol=1e-4, rtol=0)
BF16 = dict(atol=5e-2, rtol=5e-2)
ARCH = "qwen3-0.6b"


def _cfgs(**overrides):
    return (dataclasses.replace(get_config(ARCH).reduced(), **overrides),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **overrides))


@functools.cache
def _pair(**overrides):
    """(port model, JAX model, JAX params, port params on the CPU) of the
    reduced config; cached, never mutated by the tests."""
    cfg, jcfg = _cfgs(**overrides)
    jm = JaxTransformer(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return Transformer(cfg), jm, jp, tp


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jax_decode(jm, jp, tokens, use_window=False):
    b, s = tokens.shape
    cache = jm.init_cache(b, s, use_window=use_window)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                  use_window=use_window))
    outs = []
    for t in range(s):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, t]))
        outs.append(np.asarray(lg, np.float32))
    return np.stack(outs, 1)


@torch.no_grad()
def _port_decode(tm, tp, tokens, use_window=False):
    b, s = tokens.shape
    cache = tm.init_cache(b, s, use_window=use_window, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]),
                                   use_window=use_window)
        outs.append(lg.float().numpy())
    assert cache["idx"] == s
    return np.stack(outs, 1)


# ------------------------------------------------------------- configs
def test_configs_equal_field_by_field():
    """All ten zoo architectures of the JAX package are registered, each
    equal field by field, full and reduced."""
    assert list_configs() == jax_list_configs() and len(list_configs()) == 10
    for name in list_configs():
        full, jfull = get_config(name), jax_get_config(name)
        assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
        assert dataclasses.asdict(full.reduced()) == \
            dataclasses.asdict(jfull.reduced())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("blocks", [2, 4])
def test_jamba_local_dispatch_stack_matches_jax(blocks):
    """The stack with ``moe_dispatch_local`` (each MoE block's tokens in
    ``blocks`` blocks): logits and the summed aux against the JAX
    package's, on jamba's period at own fan-in."""
    tm, jm, jp, tp = jamba_pair()
    over = dict(moe_dispatch_local=True, moe_dispatch_blocks=blocks)
    tm = Transformer(dataclasses.replace(tm.cfg, **over))
    jm = JaxTransformer(dataclasses.replace(jm.cfg, **over))
    tokens = _tokens(2, 16, tm.cfg.vocab_size)
    want, waux = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = tm.forward(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert abs(float(aux) - float(waux)) < 1e-6


@pytest.mark.parametrize("overrides", [
    dict(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128)),
    dict(block_pattern=("attn", "mamba"),
         mamba=get_config("jamba-v0.1-52b").reduced().mamba),
], ids=["moe", "mamba"])
def test_moe_and_mamba_blocks_build(overrides):
    """MoE and Mamba blocks are ported (jamba's, and in any pattern)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **overrides)
    tm = Transformer(cfg)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        logits, aux = tm.forward(params, torch.zeros(1, 8, dtype=torch.long))
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and aux.dtype == torch.float32


def test_full_width_defs_match_jax_leaf_for_leaf():
    tm, jm = Transformer(get_config(ARCH)), JaxTransformer(
        jax_get_config(ARCH))
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.defs(), is_leaf=is_def)
    want = {"/".join(p.key for p in path): d for path, d in flat}
    got = tm.defs()
    assert list(got) == list(want)
    for k, d in got.items():
        assert (d.shape, d.init, d.scale) == \
            (want[k].shape, want[k].init, want[k].scale), k
    assert got["layers/b0/mixer/wq"].shape == (28, 1024, 2048)
    assert tm.count_params() == jm.count_params() == 596_049_920


# ------------------------------------------------------------- params
def test_nested_jax_params_carry_over_with_checkpoint_keys():
    tm, _, jp, tp = _pair()
    flat = ckpt_flatten(jp)
    assert list(tp) == list(flat) == list(tm.defs())
    for k, v in flat.items():
        assert tuple(tp[k].shape) == v.shape
        np.testing.assert_array_equal(tp[k].numpy(), v)


def test_bf16_leaf_crosses_over_bit_exactly_and_back():
    x = jax.random.normal(jax.random.key(5), (3, 7)).astype(jnp.bfloat16)
    tree = {"a": {"b": x}, "c": jnp.arange(4, dtype=jnp.int32)}
    tp = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    assert list(tp) == ["a/b", "c"]
    assert tp["a/b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["a/b"].float().numpy(),
                                  np.asarray(x, np.float32))
    back = params_to_numpy(tp)
    assert back["a/b"].dtype == np.asarray(x).dtype
    np.testing.assert_array_equal(back["a/b"].view(np.uint16),
                                  np.asarray(x).view(np.uint16))
    np.testing.assert_array_equal(back["c"], np.arange(4, dtype=np.int32))


def test_port_init_is_seeded_and_shaped():
    tm = Transformer(get_config(ARCH).reduced())
    a = tm.init(torch.Generator().manual_seed(0), "cpu")
    b = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: d.shape for k, d in tm.defs().items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.dtype == torch.float32 for v in a.values())


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("s", [16, 64])
def test_forward_matches_jax(s, kv):
    tm, jm, jp, tp = _pair(num_kv_heads=kv)
    tokens = _tokens(2, s, tm.cfg.vocab_size)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = tm.forward(tp, torch.from_numpy(tokens))
    assert got.shape == (2, s, tm.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_forward_matches_jax():
    tm, jm, jp, tp = _pair(param_dtype="bfloat16", act_dtype="bfloat16")
    assert tp["layers/b0/mixer/wq"].dtype == torch.bfloat16
    tokens = _tokens(2, 64, tm.cfg.vocab_size)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m))
        got = cross_entropy_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -------------------------------------------------------------- decode
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_decode_matches_jax_decode_and_own_forward(kv):
    tm, jm, jp, tp = _pair(num_kv_heads=kv)
    tokens = _tokens(2, 16, tm.cfg.vocab_size, seed=3)
    got = _port_decode(tm, tp, tokens)
    np.testing.assert_allclose(got, _jax_decode(jm, jp, tokens), **F32)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got, fwd.numpy(), **F32)


def test_window_decode_matches_jax():
    """Rolling cache of the reduced window (32) over 48 tokens: the ring
    buffer wraps."""
    tm, jm, jp, tp = _pair(num_kv_heads=2)
    assert tm.cfg.sliding_window == 32
    tokens = _tokens(2, 48, tm.cfg.vocab_size, seed=4)
    cache = tm.init_cache(2, 48, use_window=True, device="cpu")
    assert cache["layers/b0/k"].shape == (2, 2, 32, 2, 64)
    got = _port_decode(tm, tp, tokens, use_window=True)
    np.testing.assert_allclose(got, _jax_decode(jm, jp, tokens, True), **F32)


# ================================================================ jamba
# The reduced jamba-v0.1-52b: one period of 8 blocks (Mamba at 0-3 and
# 5-7, attention at 4 without RoPE; MoE of 4 experts, top-2, at 0, 2, 4,
# 6), d_model 256, from ``_torch_jamba.jamba_pair``: the JAX-made params
# rescaled to each matrix's own fan-in, where the port and the JAX
# package agree to ~5e-6 (at the JAX package's init they differ by ~0.5
# on logits of ~1.4, chaotic in the order of the sums). f32 tolerance
# atol=1e-4 for the forward, and the JAX package's own decode-vs-forward
# bound for jamba, 1e-2 (tests/test_decode.py:26), for decode against
# the forward.
JAMBA_DECODE = dict(atol=1e-2, rtol=0)


def test_jamba_full_width_defs_match_jax_leaf_for_leaf():
    tm, jm = Transformer(get_config(JAMBA)), JaxTransformer(
        jax_get_config(JAMBA))
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.defs(), is_leaf=is_def)
    want = {"/".join(p.key for p in path): d for path, d in flat}
    got = tm.defs()
    assert list(got) == list(want)
    for k, d in got.items():
        assert (d.shape, d.init, d.scale) == \
            (want[k].shape, want[k].init, want[k].scale), k
    assert got["layers/b0/moe/w_gate"].shape == (4, 16, 4096, 14336)
    assert got["layers/b4/mixer/wq"].shape == (4, 4096, 4096)
    assert "layers/b1/mlp/w_up" in got and "layers/b1/moe/w_up" not in got
    assert tm.count_params() == jm.count_params() == 51_570_315_264
    assert tm.active_param_count() == jm.active_param_count()
    one_period = Transformer(dataclasses.replace(get_config(JAMBA),
                                                 num_layers=8))
    assert one_period.count_params() == 13_295_235_072


def test_own_fan_in_factors_of_stacked_leaves():
    """The fan-in of a stacked (L, ..., d_in, d_out) leaf is shape[-2]:
    d_in of a matrix and of an expert stack (L, E, d_in, d_out) alike,
    not E; rwkv6-3b's factors are those of its (L, d_in, d_out)
    matrices."""
    own = chip_smoke().own_fan_in_factors
    jamba = own(Transformer(get_config(JAMBA)))
    assert jamba["layers/b0/moe/w_gate"] == pytest.approx((4 / 4096) ** 0.5)
    assert jamba["layers/b0/moe/w_down"] == pytest.approx(
        (4 / 14336) ** 0.5)
    assert jamba["layers/b0/mixer/dt_proj"] == pytest.approx((4 / 256) ** 0.5)
    assert "layers/b0/moe/router" not in jamba       # its own scale, 0.02
    assert "layers/b0/mixer/conv_w" not in jamba     # its own scale, 0.5
    rwkv = own(Transformer(get_config("rwkv6-3b")))
    assert rwkv["layers/b0/mixer/w_r"] == pytest.approx((32 / 2560) ** 0.5)
    assert rwkv["layers/b0/cm/w_v"] == pytest.approx((32 / 8960) ** 0.5)
    assert len(rwkv) == 8


@pytest.mark.parametrize("s", [16, 64])
def test_jamba_forward_and_aux_match_jax(s):
    tm, jm, jp, tp = jamba_pair()
    tokens = _tokens(2, s, tm.cfg.vocab_size)
    want, waux = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = tm.forward(tp, torch.from_numpy(tokens))
    assert got.shape == (2, s, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # four MoE blocks' Switch losses, summed
    assert float(aux) > 0.0
    assert abs(float(aux) - float(waux)) < 1e-6


def test_jamba_decode_matches_jax_decode_and_own_forward():
    """capacity_factor 8.0, as tests/test_decode.py:43-45: no prefill
    drop can make the forward diverge from decode."""
    tm, jm, jp, tp = jamba_pair(capacity_factor=8.0)
    tokens = _tokens(2, 16, tm.cfg.vocab_size, seed=3)
    got = _port_decode(tm, tp, tokens)
    np.testing.assert_allclose(got, _jax_decode(jm, jp, tokens), **F32)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got, fwd.numpy(), **JAMBA_DECODE)


def test_jamba_cache_is_stacked_and_constant_size_for_mamba():
    tm = Transformer(dataclasses.replace(get_config(JAMBA).reduced(),
                                         act_dtype="bfloat16"))
    c16 = tm.init_cache(2, 16, device="cpu")
    c64 = tm.init_cache(2, 64, device="cpu")
    assert tuple(c16["layers/b0/h"].shape) == (1, 2, 512, 8)
    assert tuple(c16["layers/b0/conv"].shape) == (1, 2, 4, 512)
    assert c16["layers/b0/h"].dtype == torch.float32
    assert c16["layers/b0/conv"].dtype == torch.bfloat16
    assert tuple(c64["layers/b4/k"].shape) == (1, 2, 64, 4, 64)
    for j in (0, 1, 2, 3, 5, 6, 7):
        for name in ("h", "conv"):
            key = f"layers/b{j}/{name}"
            assert c16[key].shape == c64[key].shape
