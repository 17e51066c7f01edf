"""The seven zoo architectures the port took last (granite-moe-1b-a400m,
mistral-nemo-12b, deepseek-coder-33b, qwen3-moe-30b-a3b, minicpm3-4b,
whisper-small, pixtral-12b) against the JAX package, on the same params.

Reduced configs in f32, JAX-made params carried over with
``params_from_numpy`` (``_torch_zoo.zoo_pair``; whisper at own fan-in),
tokens, frames and patches from numpy seeds. Forward at ``atol=1e-4``;
decode against the JAX decode at ``1e-4`` and against the port's own
forward at the JAX package's ``CASES`` tolerances
(``tests/test_decode.py:18-27``; pixtral, absent there, decodes its
mistral-nemo backbone's text at mistral's), with MoE at
``capacity_factor=8`` as that test has it. whisper's decode is in
``test_torch_encdec.py``, MLA's cache in ``test_torch_mla.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro.models.params import is_def
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Transformer
from repro_torch.models import transformer as tr
from repro_torch.models.layers import apply_embed, apply_norm
from repro_torch.models.transformer import cross_entropy_loss
from repro_torch.optim import adamw, apply_updates

from _torch_zoo import (NEW_ARCHS, aux_inputs, jax_decode, port_decode,
                        to_jax, to_torch, tokens, zoo_pair)

torch.set_num_threads(2)

F32 = dict(atol=1e-4, rtol=0)
# The JAX package's count_params at full width: (total, active).
PARAMS = {
    "granite-moe-1b-a400m": (1_334_628_352, 428_658_688),
    "mistral-nemo-12b": (12_247_782_400, 12_247_782_400),
    "deepseek-coder-33b": (33_342_991_360, 33_342_991_360),
    "qwen3-moe-30b-a3b": (30_532_122_624, 3_353_032_704),
    "minicpm3-4b": (4_073_875_968, 4_073_875_968),
    "whisper-small": (277_940_736, 277_940_736),
    "pixtral-12b": (12_247_782_400, 12_247_782_400),
}
DECODE_TOL = {"granite-moe-1b-a400m": 1e-3, "mistral-nemo-12b": 1e-4,
              "deepseek-coder-33b": 1e-4, "qwen3-moe-30b-a3b": 1e-3,
              "minicpm3-4b": 1e-4, "pixtral-12b": 1e-4}
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_defs_match_jax_leaf_for_leaf(arch):
    tm = Transformer(get_config(arch))
    jm = JaxTransformer(jax_get_config(arch))
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.defs(), is_leaf=is_def)
    want = {"/".join(p.key for p in path): d for path, d in flat}
    got = tm.defs()
    assert list(got) == list(want)
    for k, d in got.items():
        assert (d.shape, d.init, d.scale) == \
            (want[k].shape, want[k].init, want[k].scale), k
    total, active = PARAMS[arch]
    assert tm.count_params() == jm.count_params() == total
    assert tm.active_param_count() == jm.active_param_count() == active


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_active_params_below_total(arch):
    tm = Transformer(get_config(arch))
    m = tm.cfg.moe
    expert = 3 * tm.cfg.d_model * m.d_ff_expert
    assert tm.count_params() - tm.active_param_count() == \
        tm.cfg.num_layers * (m.num_experts - m.top_k) * expert > 0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_aux_match_jax(arch):
    tm, jm, jp, tp = zoo_pair(arch)
    cfg = tm.cfg
    assert list(tp) == list(tm.defs())     # every leaf carried over
    b, s = 2, 40                   # > attn_chunk_q: the JAX side blocks
    toks = tokens(b, s, cfg.vocab_size)
    aux = aux_inputs(cfg, b)
    want, waux = jm.forward(jp, jnp.asarray(toks), to_jax(aux))
    with torch.no_grad():
        got, gaux = tm.forward(tp, torch.from_numpy(toks), to_torch(aux))
    assert got.shape == (b, s + cfg.vision_patches, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert (float(gaux) > 0) == (cfg.moe is not None)
    assert abs(float(gaux) - float(waux)) < 1e-6


@pytest.mark.parametrize("arch", sorted(DECODE_TOL))
def test_decode_matches_jax_decode_and_own_forward(arch):
    kw = dict(capacity_factor=8.0) if arch in MOE_ARCHS else {}
    tm, jm, jp, tp = zoo_pair(arch, **kw)
    toks = tokens(2, 16, tm.cfg.vocab_size, seed=3)
    got, _ = port_decode(tm, tp, toks)
    want, _ = jax_decode(jm, jp, toks)
    np.testing.assert_allclose(got, want, **F32)
    with torch.no_grad():
        fwd, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got, fwd.numpy(), atol=DECODE_TOL[arch],
                               rtol=0)


def _windowed_forward(tm, tp, toks):
    """The port's forward with every attention block's sliding window on
    (the test-only reference of ``tests/test_decode.py``)."""
    cfg = tm.cfg
    x = apply_embed({"table": tp["embed/table"]}, toks.long())
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    for i in range(tm.num_periods):
        for j, kind in enumerate(tm.pattern):
            x, _ = tr._apply_block(cfg, kind, cfg.layer_is_moe(j),
                                   tr._layer(tp, f"layers/b{j}/", i), x, pos,
                                   window=cfg.sliding_window)
    x = apply_norm(tr._layer(tp, "final_norm/"), x, cfg.norm_kind)
    return tm.logits(tp, x)


def test_sliding_window_decode_matches_windowed_forward():
    """mistral-nemo-12b's rolling cache (window 32 reduced) over 64
    tokens, so the ring wraps: against the windowed forward at the JAX
    package's 2e-4, and against the JAX package's windowed decode."""
    tm, jm, jp, tp = zoo_pair("mistral-nemo-12b")
    w = tm.cfg.sliding_window
    toks = tokens(2, 64, tm.cfg.vocab_size, seed=4)
    cache = tm.init_cache(2, 64, use_window=True, device="cpu")
    assert cache["layers/b0/k"].shape[2] == w == 32
    got, _ = port_decode(tm, tp, toks, use_window=True)
    with torch.no_grad():
        ref = _windowed_forward(tm, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got, ref.numpy(), atol=2e-4, rtol=0)
    want, _ = jax_decode(jm, jp, toks, use_window=True)
    np.testing.assert_allclose(got, want, **F32)
    full, _ = port_decode(tm, tp, toks)
    assert np.abs(full - got)[:, w:].max() > 1e-3   # the window matters


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_steps_lower_loss(arch):
    """Four AdamW steps on one batch lower its loss, with finite grads
    (``tests/test_models_smoke.py:66-101`` on the port's autograd)."""
    tm, _, _, tp = zoo_pair(arch)
    cfg = tm.cfg
    b, s = 2, 32
    toks = torch.from_numpy(tokens(b, s, cfg.vocab_size))
    labels = torch.roll(toks, -1, dims=1)
    aux_in = to_torch(aux_inputs(cfg, b))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = adamw(3e-3)
    state = opt.init(params)
    losses = []
    for _ in range(4):
        logits, aux = tm.forward(params, toks, aux_in)
        loss = cross_entropy_loss(logits[:, -s:], labels) + aux
        grads = torch.autograd.grad(loss, list(params.values()))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        grads = dict(zip(params, grads))
        with torch.no_grad():
            upd, state = opt.update(grads, state, params)
            params = {k: v.requires_grad_()
                      for k, v in apply_updates(params, upd).items()}
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_patches_are_prepended_and_read():
    """pixtral: the logits cover patches + text, the text's logits move
    with the patches, and ``serve.prefill`` with the patches is the
    forward's last row."""
    tm, _, _, tp = zoo_pair("pixtral-12b")
    cfg = tm.cfg
    toks = torch.from_numpy(tokens(2, 8, cfg.vocab_size))
    aux = to_torch(aux_inputs(cfg, 2))
    with torch.no_grad():
        got, _ = tm.forward(tp, toks, aux)
        other, _ = tm.forward(tp, toks, {"patches": 2 * aux["patches"]})
        last = serve.prefill(tm, tp, toks, aux)
    assert got.shape == (2, cfg.vision_patches + 8, cfg.vocab_size)
    assert float((got - other)[:, -8:].abs().max()) > 1e-3
    np.testing.assert_allclose(last.numpy(), got[:, -1].numpy(), **F32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch <name>``
    serves the reduced config (whisper from seeded frames)."""
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 7) and out.dtype == np.int32
    assert ((out >= 0) & (out < get_config(arch).reduced().vocab_size)).all()
    assert f"[serve] {arch}-reduced on cpu" in capsys.readouterr().out
