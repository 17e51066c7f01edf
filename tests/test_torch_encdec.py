"""whisper-small's encoder-decoder stack (``repro_torch.models
.transformer``: the bidirectional encoder, decoder blocks with
cross-attention, ``prime_encdec`` and the encdec decode) against the JAX
package's, on the same params.

The reduced config (2 encoder and 2 decoder layers, 64 frames) at own
fan-in (``_torch_zoo``: at the reference's init the encoder is chaotic
in the order of the sums). Frames come from numpy seeds. Forward pieces
at ``atol=1e-4``; the primed decode against the JAX decode and the
port's own forward at the JAX package's 5e-4
(``tests/test_decode.py:101-122``), where a cross cache from other
frames must fail and zeroed frames must move the logits by more than
1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr

from _torch_zoo import (aux_inputs, jax_decode, port_decode, tokens,
                        zoo_pair)

torch.set_num_threads(2)

ARCH = "whisper-small"
F32 = dict(atol=1e-4, rtol=0)
DECODE = dict(atol=5e-4, rtol=0)


def _frames(cfg, b=2, seed=9):
    return aux_inputs(cfg, b, seed)["frames"]


def test_encoder_matches_jax():
    tm, jm, jp, tp = zoo_pair(ARCH)
    frames = _frames(tm.cfg)
    want = jm._encode(jp["encoder"], jnp.asarray(frames))
    with torch.no_grad():
        got = tm._encode(tp, torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("sq", [8, 40])
def test_cross_attention_matches_jax(sq):
    """A decoder layer's cross-attention: Sq text queries against the 64
    encoder states, no RoPE, the causal mask off (the kernel's Sq != Sk
    path; the JAX side blocks its queries at Sq = 40 > 32)."""
    tm, jm, jp, tp = zoo_pair(ARCH)
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq,
                               cfg.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["layers"]["xattn"])
    tx = tr._layer(tp, "layers/", 0)["xattn"]
    assert "q_norm" not in tx and set(tx) == {"wq", "wk", "wv", "wo"}
    want = jax_attn.attention_forward(
        jm.cfg, jx, jnp.asarray(x), jnp.arange(sq, dtype=jnp.int32),
        causal=False, kv_x=jnp.asarray(enc),
        kv_positions=jnp.arange(cfg.encoder_seq, dtype=jnp.int32))
    with torch.no_grad():
        got = attn.attention_forward(
            cfg, tx, torch.from_numpy(x), torch.arange(sq, dtype=torch.int32),
            causal=False, kv_x=torch.from_numpy(enc),
            kv_positions=torch.arange(cfg.encoder_seq, dtype=torch.int32))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * scale, rtol=0)


def test_cache_layout_and_prime():
    """``self/{k,v,pos}`` and ``cross/{k,v}`` stacked over the decoder's
    layers; ``prime_encdec`` fills each layer's cross cache with its own
    projections of the encoder's states."""
    tm, _, _, tp = zoo_pair(ARCH)
    cfg = tm.cfg
    cache = tm.init_cache(2, 16, device="cpu")
    kv = (cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    assert set(cache) == {"idx", "self/k", "self/v", "self/pos", "cross/k",
                          "cross/v"}
    assert cache["self/k"].shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                                     cfg.head_dim)
    assert cache["cross/k"].shape == kv and not cache["cross/k"].any()
    frames = torch.from_numpy(_frames(cfg))
    with torch.no_grad():
        cache = tm.prime_encdec(tp, cache, frames)
        enc = tm._encode(tp, frames)
        for i in range(cfg.num_layers):
            xc = attn.cross_attention_cache(
                cfg, tr._layer(tp, "layers/", i)["xattn"], enc)
            assert torch.equal(cache["cross/k"][i], xc["k"])
            assert torch.equal(cache["cross/v"][i], xc["v"])
    assert cache["cross/v"].shape == kv


def test_primed_decode_matches_jax_and_own_forward():
    tm, jm, jp, tp = zoo_pair(ARCH)
    toks = tokens(2, 8, tm.cfg.vocab_size)
    frames = _frames(tm.cfg)
    got, _ = port_decode(tm, tp, toks, frames=frames)
    want, _ = jax_decode(jm, jp, toks, frames=frames)
    np.testing.assert_allclose(got, want, **DECODE)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(toks),
                            {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(got, fwd.numpy(), **DECODE)


def test_cross_attention_is_read():
    """Zeroed frames move the decoded logits by more than 1e-3, and a
    cross cache primed from other frames (a planted fault) breaks the
    decode tolerance against the forward."""
    tm, _, _, tp = zoo_pair(ARCH)
    toks = tokens(2, 8, tm.cfg.vocab_size)
    frames = _frames(tm.cfg)
    got, _ = port_decode(tm, tp, toks, frames=frames)
    zero, _ = port_decode(tm, tp, toks, frames=np.zeros_like(frames))
    assert np.abs(zero - got).max() > 1e-3
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(toks),
                            {"frames": torch.from_numpy(frames)})
    other, _ = port_decode(tm, tp, toks, frames=_frames(tm.cfg, seed=10))
    assert np.abs(other - fwd.numpy()).max() > 10 * DECODE["atol"]


def test_frames_are_required():
    tm, _, _, tp = zoo_pair(ARCH)
    toks = torch.from_numpy(tokens(1, 4, tm.cfg.vocab_size))
    with pytest.raises(ValueError, match="frames"):
        tm.forward(tp, toks)
    with pytest.raises(ValueError, match="frames"):
        serve.greedy_generate(tm, tp, toks.numpy(), 2)


def test_serve_prefill_and_greedy_generate_with_frames():
    """``prefill`` with frames is the forward's last row; greedy
    generation from primed caches picks the JAX serve loop's tokens
    (``repro/launch/serve.py:46-64``, the frames passed in)."""
    tm, jm, jp, tp = zoo_pair(ARCH)
    toks = tokens(2, 12, tm.cfg.vocab_size, seed=5)
    frames = _frames(tm.cfg)
    ft = torch.from_numpy(frames)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(toks), {"frames": ft})
    last = serve.prefill(tm, tp, torch.from_numpy(toks), {"frames": ft})
    np.testing.assert_allclose(last.numpy(), fwd[:, -1].numpy(), **F32)

    prompts, gen = toks[:, :6], 6
    got = serve.greedy_generate(tm, tp, prompts, gen, frames=ft)
    cache = jm.prime_encdec(jp, jm.init_cache(2, 12), jnp.asarray(frames))
    step = jax.jit(jm.decode_step)
    tok, want = jnp.asarray(prompts[:, 0]), [prompts[:, 0]]
    for i in range(1, 12):
        logits, cache = step(jp, cache, tok)
        tok = (jnp.asarray(prompts[:, i]) if i < 6
               else jnp.argmax(logits, -1).astype(jnp.int32))
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got, np.stack(want, 1))
