"""The reduced zoo architectures for the port's tests, made once per
config: JAX-made params carried into the port with ``params_from_numpy``,
seeded stub-frontend inputs, and stepped decodes on both sides.

whisper-small runs at own fan-in (``chip_smoke.own_fan_in_factors``, as
``_torch_jamba`` does for jamba): at the reference's init (every stacked
matrix at std 1/sqrt(2) at the reduced 2 layers, ROADMAP Queue C) its
encoder's logits are chaotic in the order of the sums, and the port and
the JAX package differ by ~1.2e-3 on logits of ~1.6, against ~1e-6 at
own fan-in.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.models import Transformer, params_from_numpy

from _torch_jamba import chip_smoke

NEW_ARCHS = ["granite-moe-1b-a400m", "mistral-nemo-12b",
             "deepseek-coder-33b", "qwen3-moe-30b-a3b", "minicpm3-4b",
             "whisper-small", "pixtral-12b"]
OWN_FAN_IN = {"whisper-small"}


def reduced(arch: str, **overrides):
    """(port config, JAX config), reduced, with ``overrides``; a
    ``capacity_factor`` override goes into the MoE config."""
    cf = overrides.pop("capacity_factor", None)
    out = []
    for c in (get_config(arch).reduced(), jax_get_config(arch).reduced()):
        if cf is not None:
            c = dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
        out.append(dataclasses.replace(c, **overrides))
    return tuple(out)


@functools.cache
def zoo_pair(arch: str, own_fan_in: bool | None = None, **overrides):
    """(port model, JAX model, JAX params, port params on the CPU) of the
    reduced ``arch``; the stacked matrices at own fan-in for whisper (or
    where ``own_fan_in`` says so). Cached, never mutated by the tests."""
    cfg, jcfg = reduced(arch, **overrides)
    tm, jm = Transformer(cfg), JaxTransformer(jcfg)
    jp = jm.init(jax.random.key(0))
    if arch in OWN_FAN_IN if own_fan_in is None else own_fan_in:
        factors = chip_smoke().own_fan_in_factors(tm)

        def scale(tree, prefix=""):
            return {k: scale(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else v * factors.get(prefix + k, 1.0)
                    for k, v in tree.items()}
        jp = scale(jp)
    return tm, jm, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


def tokens(b: int, s: int, vocab: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def aux_inputs(cfg, b: int, seed: int = 9) -> dict:
    """numpy stub-frontend inputs: unit-normal frames of an
    encoder-decoder config, patches at 0.1 of a vision config (as
    ``tests/test_models_smoke.py`` makes them)."""
    rng = np.random.default_rng(seed)
    aux = {}
    if cfg.is_encdec:
        aux["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_patches:
        aux["patches"] = (0.1 * rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model))).astype(np.float32)
    return aux


def to_jax(aux: dict):
    return {k: jnp.asarray(v) for k, v in aux.items()} or None


def to_torch(aux: dict):
    return {k: torch.from_numpy(v) for k, v in aux.items()} or None


def jax_decode(jm, jp, toks, use_window=False, frames=None):
    """Logits (B, S, V) of stepping ``toks`` through the JAX package's
    ``decode_step`` (its caches primed from ``frames`` where given)."""
    b, s = toks.shape
    cache = jm.init_cache(b, s, use_window=use_window)
    if frames is not None:
        cache = jm.prime_encdec(jp, cache, jnp.asarray(frames))
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t,
                                                  use_window=use_window))
    outs = []
    for t in range(s):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t]))
        outs.append(np.asarray(lg, np.float32))
    return np.stack(outs, 1), cache


@torch.no_grad()
def port_decode(tm, tp, toks, use_window=False, frames=None, fault=None):
    """Logits (B, S, V) of stepping ``toks`` through the port's
    ``decode_step`` on the CPU; ``fault(cache, t)``, where given, is
    applied to the cache after step ``t``. Returns (logits, cache)."""
    b, s = toks.shape
    cache = tm.init_cache(b, s, use_window=use_window, device="cpu")
    if frames is not None:
        cache = tm.prime_encdec(tp, cache, torch.from_numpy(frames))
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(toks[:, t]),
                                   use_window=use_window)
        if fault is not None:
            fault(cache, t)
        outs.append(lg.float().numpy())
    assert cache["idx"] == s
    return np.stack(outs, 1), cache
