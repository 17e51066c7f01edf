"""MLA, minicpm3-4b's multi-head latent attention
(``repro_torch.models.attention``: ``mla_forward``, ``init_mla_cache``,
``mla_decode``), against the JAX package's, on the same params.

The reduced config: q·k head dim 24 (16 nope + 8 rope), v head dim 16,
latent 32. The prefill attends through ``ops.flash_attention_op`` with
D_qk != D_v, the plain version on the CPU; here it is held to the JAX
``mla_forward``'s own attention. Decode is the absorbed-matrix form over
the latent cache, which holds ``c_kv``, ``k_rope`` and ``pos`` only. f32,
``atol=1e-4`` on logits (the JAX package's bound for minicpm3-4b's
decode against its forward, ``tests/test_decode.py:22``). A layer's own
outputs, on unit-normal inputs at the reference's init, reach |y| ~ 100:
there both sides are held to ``REL`` of the largest value. Both sum in
f32 in other orders (~1e-6 relative), and the scores, up to |s| ~ 30 at
this init, carry that into the softmax's weights; the readings are
~1e-5 of the largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref
from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa_mod, ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_rope, rms_norm_headwise

from _torch_flash import plain_launchers
from _torch_zoo import jax_decode, port_decode, tokens, zoo_pair

torch.set_num_threads(2)

ARCH = "minicpm3-4b"
F32 = dict(atol=1e-4, rtol=0)
REL = 5e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _layer0(tm, jp, tp):
    """The first layer's mixer params: JAX (jnp) and port (torch)."""
    jmix = jax.tree.map(lambda a: a[0], jp["layers"]["b0"]["mixer"])
    tmix = {k.split("/")[-1]: v[0] for k, v in tp.items()
            if k.startswith("layers/b0/mixer/")}
    return jmix, tmix


def _x(tm, b, s, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, s, tm.cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("d,dv,sq,sk,causal,window", [
    (24, 16, 40, 40, True, None), (96, 64, 33, 33, True, None),
    (96, 64, 20, 20, True, 7), (96, 64, 9, 30, False, None),
    (24, 16, 30, 9, False, None)])
def test_plain_split_flash_matches_reference(d, dv, sq, sk, causal, window):
    """The plain version with D_qk != D_v against the JAX package's dense
    oracle (which scales by q's head dim, as MLA needs)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, d)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, dv)).astype(np.float32)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, window)
    got = fa_mod.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       causal, window)
    assert got.shape == (2, 4, sq, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("s", [16, 64])
def test_plain_split_flash_is_the_jax_mla_attention(s):
    """q, k, v made by the port's projections go through the plain
    flash version; the JAX ``mla_forward`` with ``wo`` set to an identity
    on its first H·D_v outputs gives its attention (blockwise over
    queries at S = 64 > attn_chunk_q)."""
    tm, jm, jp, tp = zoo_pair(ARCH)
    cfg, m = tm.cfg, tm.cfg.mla
    h, dv = cfg.num_heads, m.v_head_dim
    jmix, tmix = _layer0(tm, jp, tp)
    x = _x(tm, 2, s)
    eye = np.eye(h * dv, cfg.d_model, dtype=np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = jax_attn.mla_forward(jm.cfg, dict(jmix, wo=jnp.asarray(eye)),
                                jnp.asarray(x), jnp.asarray(pos))
    want = np.asarray(want)[..., :h * dv]
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    with torch.no_grad():
        q_nope, q_rope = attn._mla_q(cfg, tmix, xt)
        q = torch.cat([q_nope, apply_rope(q_rope, post, cfg.rope_theta)], -1)
        c_kv = rms_norm_headwise(xt @ tmix["w_dkv"], tmix["kv_norm"])
        k_nope = (c_kv @ tmix["w_uk"]).reshape(2, s, h, m.qk_nope_head_dim)
        k_rope = apply_rope((xt @ tmix["w_kr"])[:, :, None], post,
                            cfg.rope_theta).expand(2, s, h,
                                                   m.qk_rope_head_dim)
        k = torch.cat([k_nope, k_rope], -1)
        v = (c_kv @ tmix["w_uv"]).reshape(2, s, h, dv)
        out = fa_mod.flash_attention_plain(q.transpose(1, 2),
                                           k.transpose(1, 2),
                                           v.transpose(1, 2))
    assert q.shape[-1] == 24 and v.shape[-1] == 16
    got = out.transpose(1, 2).reshape(2, s, h * dv)
    _close(got.numpy(), want)


@pytest.mark.parametrize("s", [16, 64])
def test_mla_forward_block_matches_jax(s):
    tm, jm, jp, tp = zoo_pair(ARCH)
    jmix, tmix = _layer0(tm, jp, tp)
    x = _x(tm, 2, s, seed=6)
    pos = np.arange(s, dtype=np.int32)
    want = jax_attn.mla_forward(jm.cfg, jmix, jnp.asarray(x),
                                jnp.asarray(pos))
    with torch.no_grad():
        got = attn.mla_forward(tm.cfg, tmix, torch.from_numpy(x),
                               torch.from_numpy(pos))
    _close(got.numpy(), want)


# MLA's leaf gradients, port vs jax.grad: both f32, their sums in other
# orders (~1e-6 relative); the scores (|s| up to ~30 at this init) carry
# that into the softmax's weights and so into every gradient, as into the
# outputs (REL). Measured on the CPU: within 1.3e-5 of each leaf's
# largest entry (kv_norm, w_dq, w_uk, w_uq the largest).
GRAD_REL = 1e-4


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("path", ["plain", "kernel_fn"])
def test_mla_leaf_grads_match_jax_grad(s, path, monkeypatch):
    """Every leaf's gradient of one MLA layer (and the input's), the
    port's ``mla_forward`` against ``jax.grad`` of the JAX package's on
    the same reduced params (q·k 24, v 16) and cotangent. ``w_kr``'s
    gradient is the sum over the heads of dK's rope part (``k_rope``
    expanded to every head, then concatenated): the JAX package's
    broadcast gradient. ``plain`` is the CPU training path (the plain
    flash version's autograd); ``kernel_fn`` routes the attention through
    ``FlashAttentionFn`` (the kernels' autograd node, its launchers
    replaced by the plain versions), as on the card."""
    tm, jm, jp, tp = zoo_pair(ARCH)
    jmix, tmix = _layer0(tm, jp, tp)
    x = _x(tm, 2, s, seed=9)
    ct = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)
    pos = np.arange(s, dtype=np.int32)

    def jloss(p, xx):
        y = jax_attn.mla_forward(jm.cfg, p, xx, jnp.asarray(pos))
        return jnp.sum(y * jnp.asarray(ct))
    with jax.default_matmul_precision("highest"):
        jg, jgx = jax.grad(jloss, argnums=(0, 1))(jmix, jnp.asarray(x))
    if path == "kernel_fn":
        calls = plain_launchers(monkeypatch)
        monkeypatch.setattr(ops, "flash_attention_op",
                            lambda q, k, v, causal=True, window=None:
                            fa_mod.flash_attention(q, k, v, causal, window))
    p = {k: v.clone().requires_grad_() for k, v in tmix.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = attn.mla_forward(tm.cfg, p, xt, torch.from_numpy(pos))
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                              [*p.values(), xt])
    if path == "kernel_fn":
        assert calls == [("fwd", True), ("bwd", True, None)]
    want = dict(jg, x=jgx)
    assert set(p) == set(jg)
    for name, g in zip([*p, "x"], got):
        _close(g.numpy(), want[name], rel=GRAD_REL)



def test_mla_cache_is_compressed():
    """The cache stores the latents, not expanded K/V (the JAX package's
    ``test_mla_cache_is_compressed``), stacked over the layers."""
    tm, _, _, _ = zoo_pair(ARCH)
    cfg, m = tm.cfg, tm.cfg.mla
    cache = tm.init_cache(2, 64, device="cpu")
    assert set(cache) == {"idx"} | {f"layers/b0/{n}"
                                    for n in ("c_kv", "k_rope", "pos")}
    assert cache["layers/b0/c_kv"].shape == (2, 2, 64, m.kv_lora_rank)
    assert cache["layers/b0/k_rope"].shape == (2, 2, 64,
                                               m.qk_rope_head_dim)
    expanded = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                + m.v_head_dim)
    assert m.kv_lora_rank + m.qk_rope_head_dim < expanded / 3
    full = get_config(ARCH).mla
    assert 40 * (64 + 32 + 64) / (full.kv_lora_rank
                                  + full.qk_rope_head_dim) > 20


def test_mla_cache_after_decode_equals_jax():
    """After 16 steps the port's latents, rope'd keys and positions equal
    the JAX package's cache."""
    tm, jm, jp, tp = zoo_pair(ARCH)
    toks = tokens(2, 16, tm.cfg.vocab_size, seed=3)
    _, cache = port_decode(tm, tp, toks)
    _, jcache = jax_decode(jm, jp, toks)
    for name in ("c_kv", "k_rope", "pos"):
        _close(cache[f"layers/b0/{name}"].numpy(),
               jcache["layers"]["b0"][name])
    assert cache["layers/b0/pos"][0].tolist() == list(range(16))


def test_mla_decode_step_matches_jax():
    """One absorbed-matrix step of a layer, from the same filled cache."""
    tm, jm, jp, tp = zoo_pair(ARCH)
    jmix, tmix = _layer0(tm, jp, tp)
    x = _x(tm, 2, 9, seed=8)
    jc = jax_attn.init_mla_cache(jm.cfg, 2, 12, jnp.float32)
    tc = attn.init_mla_cache(tm.cfg, 2, 12, torch.float32, "cpu")
    for t in range(9):
        jy, jc = jax_attn.mla_decode(jm.cfg, jmix, jnp.asarray(x[:, t:t + 1]),
                                     jc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            ty, tc = attn.mla_decode(tm.cfg, tmix,
                                     torch.from_numpy(x[:, t:t + 1]), tc, t)
        _close(ty.numpy(), jy)


def test_latent_cache_one_slot_off_breaks_the_tolerance():
    """A planted fault, each step's latent written one slot late from
    step 8 on, takes decode past the bound that the sound decode meets
    against the forward."""
    tm, _, _, tp = zoo_pair(ARCH)
    toks = tokens(2, 16, tm.cfg.vocab_size, seed=3)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(toks))
    fwd = fwd.numpy()
    sound, _ = port_decode(tm, tp, toks)
    np.testing.assert_allclose(sound, fwd, **F32)

    def one_slot_off(cache, t):
        if 8 <= t < 15:
            for name in ("c_kv", "k_rope"):
                leaf = cache[f"layers/b0/{name}"]
                leaf[:, :, t + 1] = leaf[:, :, t]
                leaf[:, :, t] = leaf[:, :, t - 1]
    bad, _ = port_decode(tm, tp, toks, fault=one_slot_off)
    assert np.abs(bad - fwd)[:, 9:].max() > 10 * F32["atol"]
