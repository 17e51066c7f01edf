"""The partition specs of the port (``Transformer.specs`` /
``cache_specs``, ``models/sharding.sanitize_specs`` and the prefill and
serve placements of ``launch/specs.py``) against the JAX package's, as
tuples: all ten archs
at full width (metadata only: no param is made), ``model`` in {2, 4, 16}
on one pod (data=16) and two (pod=2), the reference run on a
``jax.sharding.AbstractMesh`` (no device), the port on ``{axis:
size}``. The JAX side's params and caches are ``jax.eval_shape``'s, the
port's the defs and meta-device caches."""
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.models.transformer import Transformer as JTransformer
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import specs
from repro_torch.models import Transformer
from repro_torch.models import sharding as sh

ARCHS = list_configs()


def _flat(tree, prefix=""):
    """A JAX spec tree as ``{"a/b": tuple}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, P):
            out[prefix + k] = tuple(v)
        else:
            out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _meshes(m: int, multi_pod: bool):
    shape = (2, 16, m) if multi_pod else (16, m)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, names), dict(zip(names, shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    tm, jm = Transformer(get_config(arch)), JTransformer(jget(arch))
    for prefix in ((), ("data",), (("pod", "data"),)):
        assert tm.specs(prefix) == _flat(jm.specs(prefix)), prefix


@pytest.mark.parametrize("long_ctx", [False, True])
@pytest.mark.parametrize("use_window", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, use_window, long_ctx):
    tm, jm = Transformer(get_config(arch)), JTransformer(jget(arch))
    got = tm.cache_specs(use_window=use_window, long_ctx=long_ctx)
    assert got == _flat(jm.cache_specs(use_window=use_window,
                                       long_ctx=long_ctx))
    cache = tm.init_cache(1, 8, use_window=use_window, device="meta")
    assert set(got) == set(cache)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitized_placements_match_jax(arch, m, multi_pod):
    """The params' sanitized specs (trailing, and the train step's with
    the satellite dim), and the serve step's cache placements at
    decode_32k and long_500k, equal the reference's."""
    amesh, sizes = _meshes(m, multi_pod)
    tm, jm = Transformer(get_config(arch)), JTransformer(jget(arch))
    example = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                             jnp.bfloat16))
    want = _flat(jspecs.sanitize_specs(example, jm.specs(), amesh))
    got = sh.sanitize_specs(tm.defs(), tm.specs(), sizes)
    assert got == want
    lead = jspecs._lead(multi_pod)
    assert ({k: tuple(P(lead, *s)) for k, s in want.items()}
            == {k: (lead[0] if len(lead) == 1 else lead, *s)
                for k, s in got.items()})
    # the prefill step's placements: the params', the inputs' batch dim
    pspecs, prefill_sh = specs.prefill_shardings(tm, sizes)
    assert pspecs == want
    pre = specs.prefill_input_specs(tm.cfg, SHAPES["prefill_32k"])
    b = SHAPES["prefill_32k"].global_batch
    dp = jspecs._dp(multi_pod, b, amesh)
    assert prefill_sh(pre, b) == {
        k: tuple(P(dp, *([None] * (x.dim() - 1)))) for k, x in pre.items()}
    for shape_name in ("decode_32k", "long_500k"):
        shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
        use_window = specs.use_window_for(tm.cfg, shape)
        long_ctx = shape_name == "long_500k"
        b = shape.global_batch
        _, cache_sh, token_sh = specs.serve_shardings(tm, sizes, use_window,
                                                      long_ctx)
        cache = tm.init_cache(b, shape.seq_len, use_window=use_window,
                              device="meta")
        got_c = cache_sh(b, cache)
        # the reference's make_serve_step.cache_shardings, which needs a
        # concrete mesh for its NamedShardings: its specs step by step
        jcache = jax.eval_shape(lambda: jm.init_cache(
            b, jshape.seq_len, use_window=use_window, dtype=jnp.bfloat16))
        dp = jspecs._dp(multi_pod, b, amesh)

        def fix(spec):
            parts = list(spec)
            if len(parts) > 1 and parts[1] == "data":
                parts[1] = dp
            return P(*parts)
        jc = jax.tree.map(fix, jm.cache_specs(use_window=use_window,
                                              long_ctx=long_ctx),
                          is_leaf=lambda x: isinstance(x, P))
        want_c = _flat(jspecs.sanitize_specs(jcache, jc, amesh))
        assert got_c == want_c, shape_name
        assert token_sh(b) == tuple(P(dp))


def test_sanitize_relocates_and_drops():
    """whisper-small's 51865-row table moves its ``model`` to d_model;
    a dim nothing divides drops it; a leading prefix entry is kept."""
    tm = Transformer(get_config("whisper-small"))
    got = sh.sanitize_specs(tm.defs(), tm.specs(), {"model": 16})
    assert got["embed/table"] == (None, "model")
    assert got["head"] == ("model", None)
    odd = {"x": jax.ShapeDtypeStruct((3, 5), jnp.float32)}
    assert sh.sanitize_specs(odd, {"x": (None, "model")},
                             {"model": 2}) == {"x": (None, None)}
    assert sh.sanitize_specs(odd, {"x": ("data", None, "model")},
                             {"model": 2}) == {"x": ("data", None, None)}
    assert sh.sanitize_specs({"i": 0}, {"i": ()}, {"model": 4}) == {"i": ()}
