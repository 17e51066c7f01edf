"""The port's RWKV-6 stack (``repro_torch.models.rwkv`` and the rwkv
branches of ``repro_torch.models.transformer``) against the JAX
package's, on the reduced ``rwkv6-3b`` (2 layers, d_model 256, 8 heads
of 32, chunk 16).

Params are made by the JAX package and carried into the port with
``params_from_numpy``; inputs come from numpy seeds. The port's prefill
runs the WKV recurrence exactly (on the CPU through the plain version of
the ``rwkv6_wkv`` kernel); the JAX model runs its chunked prefix-product
form, which agrees with the recurrence at the init's decays (~0.9975;
``tests/test_torch_rwkv6_wkv.py`` pins where it does not).

Tolerances. f32: ``atol=1e-4`` for the forward and block functions
(both sides full f32; the sums run in other orders and the chunked form
rounds otherwise; measured ~3e-6 on the logits), and the JAX package's
own decode-vs-forward bound for this model, 1e-3
(``tests/test_decode.py:25``), for decode against the forward. bf16:
atol = rtol = 5e-2, the kernel tolerance of ``tests/test_kernels.py``
(bf16 rounds at other places in the two frameworks; measured ~0.018 on
logits of |max| 1.3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro.models import rwkv as jax_rwkv
from repro.models.params import init_params as jax_init_params, is_def
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset
from repro_torch.launch import serve
from repro_torch.models import (Transformer, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import rwkv

torch.set_num_threads(2)

ARCH = "rwkv6-3b"
F32 = dict(atol=1e-4, rtol=0)
DECODE = dict(atol=1e-3, rtol=0)
BF16 = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": dict(), "bfloat16": dict(param_dtype="bfloat16",
                                               act_dtype="bfloat16")}


def _cfgs(**overrides):
    return (dataclasses.replace(get_config(ARCH).reduced(), **overrides),
            dataclasses.replace(jax_get_config(ARCH).reduced(), **overrides))


@functools.cache
def _pair(dname="float32"):
    """(port model, JAX model, JAX params, port params on the CPU) of the
    reduced config; cached, never mutated by the tests."""
    cfg, jcfg = _cfgs(**DTYPES[dname])
    jm = JaxTransformer(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return Transformer(cfg), jm, jp, tp


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@functools.cache
def _block_params(dname):
    """One block's time-mix and channel-mix params, JAX-made (non-zero
    ln bias and decays spread around the init's, so every term shows)."""
    _, jcfg = _cfgs(**DTYPES[dname])
    dt = jnp.dtype(dname)
    jtm = jax_init_params(jax_rwkv.rwkv_defs(jcfg), jax.random.key(3), dt)
    jtm["ln_bias"] = jnp.full_like(jtm["ln_bias"], 0.1)
    jtm["decay_base"] = jnp.linspace(-7.0, -2.0, jcfg.d_model).astype(dt)
    jcm = jax_init_params(jax_rwkv.channel_mix_defs(jcfg),
                          jax.random.key(4), dt)
    to_port = lambda t: params_from_numpy(                   # noqa: E731
        {k: np.asarray(v) for k, v in t.items()}, "cpu")
    return jtm, jcm, to_port(jtm), to_port(jcm)


# ------------------------------------------------------------- blocks
@pytest.mark.parametrize("dname", list(DTYPES))
def test_time_mix_matches_jax(dname):
    cfg, jcfg = _cfgs(**DTYPES[dname])
    jtm, _, ttm, _ = _block_params(dname)
    x = _x(2, 32, cfg.d_model, seed=5)            # two chunks of 16
    want = jax_rwkv.rwkv_time_mix(jcfg, jtm, jnp.asarray(x, dname))
    with torch.no_grad():
        got = rwkv.rwkv_time_mix(cfg, ttm,
                                 torch.from_numpy(x).to(getattr(torch,
                                                                dname)))
    assert got.dtype == getattr(torch, dname)
    _close(got, want, F32 if dname == "float32" else BF16)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_channel_mix_matches_jax(dname):
    cfg, jcfg = _cfgs(**DTYPES[dname])
    _, jcm, _, tcm = _block_params(dname)
    x = _x(2, 16, cfg.d_model, seed=6)
    want = jax_rwkv.rwkv_channel_mix(jcfg, jcm, jnp.asarray(x, dname))
    got = rwkv.rwkv_channel_mix(cfg, tcm,
                                torch.from_numpy(x).to(getattr(torch, dname)))
    _close(got, want, F32 if dname == "float32" else BF16)


def test_time_mix_sequence_must_be_a_multiple_of_the_chunk():
    """As the JAX function (``assert s % chunk == 0``), though the kernel
    itself takes any S."""
    cfg, jcfg = _cfgs()
    jtm, _, ttm, _ = _block_params("float32")
    x = _x(1, 24, cfg.d_model, seed=7)            # 24 % 16 != 0
    with pytest.raises(AssertionError):
        jax_rwkv.rwkv_time_mix(jcfg, jtm, jnp.asarray(x))
    with pytest.raises(AssertionError):
        rwkv.rwkv_time_mix(cfg, ttm, torch.from_numpy(x))


def test_decode_block_matches_jax():
    """``rwkv_decode`` and ``rwkv_channel_mix_decode`` stepped over 8
    tokens from a non-zero cache: outputs and the in-place cache against
    the JAX functions' outputs and returned cache."""
    cfg, jcfg = _cfgs()
    jtm, jcm, ttm, tcm = _block_params("float32")
    b, d = 2, cfg.d_model
    rng = np.random.default_rng(8)
    jcache = jax_rwkv.init_rwkv_cache(jcfg, b, jnp.float32)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in jcache.items()}
    cache = {k: torch.from_numpy(np.array(v))
             for k, v in jcache.items()}
    s_view = cache["s"]
    for t in range(8):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        want, jcache = jax_rwkv.rwkv_decode(jcfg, jtm, jcm, jnp.asarray(x),
                                            jcache)
        with torch.no_grad():
            got, cache = rwkv.rwkv_decode(cfg, ttm, torch.from_numpy(x),
                                          cache)
        _close(got, want, F32)
        for k in ("s", "x_prev_tm"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **F32)
        cm_want = jax_rwkv.rwkv_channel_mix_decode(
            jcfg, jcm, jnp.asarray(x), jcache["x_prev_cm"])
        cm_got = rwkv.rwkv_channel_mix_decode(cfg, tcm, torch.from_numpy(x),
                                              cache["x_prev_cm"])
        _close(cm_got, cm_want, F32)
    assert cache["s"] is s_view                   # updated in place


# ------------------------------------------------------------- defs
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
    assert got["layers/b0/mixer/w_r"].shape == (32, 2560, 2560)
    assert "layers/b0/mlp/w_up" not in got and "head" in got
    assert tm.count_params() == jm.count_params() == 3_099_776_000


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("s", [16, 64])
def test_forward_matches_jax(s):
    tm, jm, jp, tp = _pair()
    tokens = _tokens(2, s, tm.cfg.vocab_size)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = tm.forward(tp, torch.from_numpy(tokens))
    assert got.shape == (2, s, tm.cfg.vocab_size) and float(aux) == 0.0
    _close(got, want, F32)


def test_bf16_forward_matches_jax():
    tm, jm, jp, tp = _pair("bfloat16")
    assert tp["layers/b0/mixer/w_r"].dtype == torch.bfloat16
    tokens = _tokens(2, 32, tm.cfg.vocab_size)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


# -------------------------------------------------------------- decode
def _jax_decode(jm, jp, tokens):
    b, s = tokens.shape
    cache = jm.init_cache(b, s)
    step = jax.jit(jm.decode_step)
    outs = []
    for t in range(s):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, t]))
        outs.append(np.asarray(lg, np.float32))
    return np.stack(outs, 1)


@torch.no_grad()
def _port_decode(tm, tp, tokens):
    b, s = tokens.shape
    cache = tm.init_cache(b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]))
        outs.append(lg.float().numpy())
    assert cache["idx"] == s
    return np.stack(outs, 1)


def test_decode_matches_jax_decode_and_own_forward():
    tm, jm, jp, tp = _pair()
    tokens = _tokens(2, 32, tm.cfg.vocab_size, seed=3)
    got = _port_decode(tm, tp, tokens)
    np.testing.assert_allclose(got, _jax_decode(jm, jp, tokens), **F32)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got, fwd.numpy(), **DECODE)


def test_cache_is_constant_size_and_stacked():
    """As ``tests/test_decode.py:147``: the RWKV state does not grow with
    ``max_len``; the layers are stacked on the leading axis."""
    tm = Transformer(dataclasses.replace(get_config(ARCH).reduced(),
                                         act_dtype="bfloat16"))
    c16 = tm.init_cache(2, 16, device="cpu")
    c512 = tm.init_cache(2, 512, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in c16.items() if k != "idx"}
    assert shapes == {k: tuple(v.shape) for k, v in c512.items()
                      if k != "idx"}
    assert shapes == {"layers/b0/s": (2, 2, 8, 32, 32),
                      "layers/b0/x_prev_tm": (2, 2, 256),
                      "layers/b0/x_prev_cm": (2, 2, 256)}
    assert c16["layers/b0/s"].dtype == torch.float32
    assert c16["layers/b0/x_prev_tm"].dtype == torch.bfloat16


# --------------------------------------------------------------- serve
def _jax_serve_replay(jm, jp, prompts, gen):
    """``repro/launch/serve.py:51-64``: prefill by stepping the prompt,
    then greedy; also returns each step's logits."""
    b, plen = prompts.shape
    cache = jm.init_cache(b, plen + gen)
    step = jax.jit(jm.decode_step)
    tok = jnp.asarray(prompts[:, 0])
    generated, logits_all = [np.asarray(prompts[:, 0])], []
    for i in range(1, plen + gen):
        logits, cache = step(jp, cache, tok)
        logits_all.append(np.asarray(logits))
        tok = (jnp.asarray(prompts[:, i]) if i < plen
               else jnp.argmax(logits, axis=-1).astype(jnp.int32))
        generated.append(np.asarray(tok))
    return np.stack(generated, axis=1), np.stack(logits_all, axis=1)


def _prompts(cfg, batch, plen):
    tok_cfg = TokenTaskConfig(vocab_size=cfg.vocab_size, seed=3)
    return np.stack([make_token_dataset(plen, tok_cfg, client=i)
                     for i in range(batch)])


def _assert_same_tokens(got, want, logits, plen):
    top2 = np.sort(logits[:, plen - 1:], axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    # A tie closer than the f32 tolerance could flip an argmax; the
    # margin tells such a tie from a bug.
    assert np.array_equal(got, want), (
        f"tokens differ; smallest top-2 logit margin of the greedy steps "
        f"{margin:.3e}\nport {got.tolist()}\njax  {want.tolist()}")


def test_greedy_generate_matches_jax_serve_loop():
    tm, jm, jp, tp = _pair()
    prompts = _prompts(tm.cfg, 2, 16)
    want, logits = _jax_serve_replay(jm, jp, prompts, 24)
    got = serve.greedy_generate(tm, tp, prompts, 24)
    assert got.shape == (2, 40) and got.dtype == np.int32
    _assert_same_tokens(got, want, logits, 16)


def _nest(flat):
    """The port's flat ``/``-joined params as the JAX package's nested
    tree."""
    out = {}
    for key, v in flat.items():
        *path, name = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[name] = jnp.asarray(v)
    return out


def test_main_matches_jax_serve_loop(capsys):
    """The CLI at its defaults (reduced, seed 0, batch 4, prompt 16, gen
    32) against the JAX serve loop on the same params, carried from the
    port's seeded init into the JAX package."""
    out = serve.main(["--arch", ARCH, "--device", "cpu"])
    assert "rwkv6-3b-reduced on cpu" in capsys.readouterr().out
    cfg = get_config(ARCH).reduced()
    tp = Transformer(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jm = JaxTransformer(jax_get_config(ARCH).reduced())
    want, logits = _jax_serve_replay(jm, _nest(params_to_numpy(tp)),
                                     _prompts(cfg, 4, 16), 32)
    assert out.shape == (4, 48)
    _assert_same_tokens(out, want, logits, 16)


def test_prefill_is_last_row_of_jax_forward():
    tm, jm, jp, tp = _pair()
    tokens = _tokens(3, 32, tm.cfg.vocab_size, seed=8)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    got = serve.prefill(tm, tp, torch.from_numpy(tokens))
    assert got.shape == (3, tm.cfg.vocab_size)
    _close(got, np.asarray(want)[:, -1], F32)
