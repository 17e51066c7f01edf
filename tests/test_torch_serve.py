"""The port's serving path (``repro_torch.launch.serve``) against the JAX
package's serve loop, and its token streams against ``repro.data.tokens``.

``greedy_generate`` from a JAX init must pick the same tokens as a
replay of ``repro/launch/serve.py``'s decode loop through the JAX
package's ``decode_step``; ``prefill`` must equal the last row of the
JAX package's ``forward`` (f32, ``atol=1e-4`` as in
``tests/test_decode.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import (TokenTaskConfig as JaxTokenCfg,
                               make_token_dataset as jax_make_tokens)
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset
from repro_torch.launch import serve
from repro_torch.models import Transformer, params_from_numpy

from _torch_jamba import jamba_pair

torch.set_num_threads(2)

ARCH = "qwen3-0.6b"


@pytest.mark.parametrize("n,kw,client,offset", [
    (64, {}, None, 0),
    (200, dict(vocab_size=512, seed=3), 1, 0),
    (16, dict(vocab_size=151936, seed=3), 2, 0),
    (300, dict(vocab_size=1000, num_states=16, client_skew=0.0, seed=7), 5,
     11),
])
def test_token_dataset_bit_equal(n, kw, client, offset):
    got = make_token_dataset(n, TokenTaskConfig(**kw), client, offset)
    want = jax_make_tokens(n, JaxTokenCfg(**kw), client, offset)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _models(kv=4):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_kv_heads=kv)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               num_kv_heads=kv)
    jm = JaxTransformer(jcfg)
    jp = jm.init(jax.random.key(0))
    return Transformer(cfg), jm, jp, params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _prompts(cfg, batch, plen):
    tok_cfg = TokenTaskConfig(vocab_size=cfg.vocab_size, seed=3)
    return np.stack([make_token_dataset(plen, tok_cfg, client=i)
                     for i in range(batch)])


def _jax_serve_replay(jm, jp, prompts, gen, use_window):
    """``repro/launch/serve.py:51-64``: prefill by stepping the prompt,
    then greedy; also returns each step's logits."""
    b, plen = prompts.shape
    max_len = plen + gen
    cache = jm.init_cache(b, max_len, use_window=use_window)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                  use_window=use_window))
    tok = jnp.asarray(prompts[:, 0])
    generated, logits_all = [np.asarray(prompts[:, 0])], []
    for i in range(1, max_len):
        logits, cache = step(jp, cache, tok)
        logits_all.append(np.asarray(logits))
        tok = (jnp.asarray(prompts[:, i]) if i < plen
               else jnp.argmax(logits, axis=-1).astype(jnp.int32))
        generated.append(np.asarray(tok))
    return np.stack(generated, axis=1), np.stack(logits_all, axis=1)


@pytest.mark.parametrize("kv,use_window", [(4, False), (2, False),
                                           (2, True)],
                         ids=["mha", "gqa", "gqa-window"])
def test_greedy_generate_matches_jax_serve_loop(kv, use_window):
    tm, jm, jp, tp = _models(kv)
    prompts = _prompts(tm.cfg, 2, 16)
    gen = 24                     # 40 positions > the reduced window (32)
    want, logits = _jax_serve_replay(jm, jp, prompts, gen, use_window)
    got = serve.greedy_generate(tm, tp, prompts, gen, use_window=use_window)
    assert got.shape == (2, 16 + gen) and got.dtype == np.int32
    top2 = np.sort(logits[:, 15:], axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    # A tie closer than the f32 tolerance could flip an argmax; the
    # margin tells such a tie from a bug.
    assert np.array_equal(got, want), (
        f"tokens differ; smallest top-2 logit margin of the greedy steps "
        f"{margin:.3e}\nport {got.tolist()}\njax  {want.tolist()}")


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_prefill_is_last_row_of_jax_forward(kv):
    tm, jm, jp, tp = _models(kv)
    tokens = np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (3, 64)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    got = serve.prefill(tm, tp, torch.from_numpy(tokens))
    assert got.shape == (3, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1],
                               atol=1e-4, rtol=0)


def test_main_runs_on_cpu_when_asked(capsys):
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "8", "--gen", "4", "--window"])
    assert out.shape == (2, 12)
    text = capsys.readouterr().out
    assert "qwen3-0.6b-reduced on cpu" in text and "seq1:" in text
    np.testing.assert_array_equal(out[:, :8], _prompts(
        get_config(ARCH).reduced(), 2, 8))


def test_main_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--gen", "1"])


# ---------------------------------------------------------------- jamba
# The reduced jamba-v0.1-52b at its matrices' own fan-in, f32
# (``_torch_jamba.jamba_pair``).


def test_jamba_prefill_is_last_row_of_jax_forward():
    """Prefill at the JAX model's chunk (32) times two; MoE at capacity
    1.25, as served."""
    tm, jm, jp, tp = jamba_pair()
    tokens = np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (3, 64)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    got = serve.prefill(tm, tp, torch.from_numpy(tokens))
    assert got.shape == (3, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1],
                               atol=1e-4, rtol=0)


def test_jamba_greedy_generate_matches_jax_serve_loop():
    tm, jm, jp, tp = jamba_pair()
    prompts = _prompts(tm.cfg, 2, 16)
    want, logits = _jax_serve_replay(jm, jp, prompts, 16, False)
    got = serve.greedy_generate(tm, tp, prompts, 16)
    assert got.shape == (2, 32) and got.dtype == np.int32
    top2 = np.sort(logits[:, 15:], axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    assert np.array_equal(got, want), (
        f"tokens differ; smallest top-2 logit margin of the greedy steps "
        f"{margin:.3e}\nport {got.tolist()}\njax  {want.tolist()}")


def test_jamba_main_runs_on_cpu_when_asked(capsys):
    out = serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert out.shape == (2, 12)
    assert ((out >= 0) & (out < 512)).all()
    text = capsys.readouterr().out
    assert "jamba-v0.1-52b-reduced on cpu" in text and "seq1:" in text
    np.testing.assert_array_equal(out[:, :8], _prompts(
        get_config("jamba-v0.1-52b").reduced(), 2, 8))
