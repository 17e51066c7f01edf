"""The reduced jamba-v0.1-52b for the port's tests, made once.

The JAX package's init draws every stacked matrix at std
1/sqrt(periods), 1 at the reduced config's one period (ROADMAP Queue C):
the residual stream reaches ~1e12 after one block and the logits become
chaotic in the order of the sums. So the jamba cases rescale the
JAX-made params to each matrix's own fan-in with
``chip_smoke.own_fan_in_factors``, the one place that decides it.
"""
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.models import Transformer, params_from_numpy

from _torch_flash import chip_smoke  # noqa: F401 (re-exported)

JAMBA = "jamba-v0.1-52b"


@functools.cache
def jamba_pair(capacity_factor=1.25):
    """(port model, JAX model, JAX params, port params) of the reduced
    jamba in f32, its stacked matrices at their own fan-in; cached, never
    mutated by the tests."""
    cfg, jcfg = (dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=capacity_factor))
        for c in (get_config(JAMBA).reduced(),
                  jax_get_config(JAMBA).reduced()))
    tm, jm = Transformer(cfg), JaxTransformer(jcfg)
    factors = chip_smoke().own_fan_in_factors(tm)

    def scale(tree, prefix=""):
        return {k: scale(v, f"{prefix}{k}/") if isinstance(v, dict)
                else v * factors.get(prefix + k, 1.0)
                for k, v in tree.items()}
    jp = scale(jm.init(jax.random.key(0)))
    return tm, jm, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")
