"""The JAX side of ``tests/test_torch_dryrun_tp.py``'s FLOP case:
``python tests/_torch_dryrun_tp.py OUT.json`` compiles the JAX package's
unrolled prefill of qwen3-0.6b at full width (B x S below) on a
``(data=2, model=2)`` mesh of 4 forced host devices, its params placed
by ``sanitize_specs(model.specs())`` as ``make_prefill_step`` places
them, and writes ``cost_analysis()["flops"]`` as JSON (the whole mesh's
count: the unsharded program's within 0.0002%)."""
import json
import os
import sys

B, S = 4, 128
MESH = (2, 2)


def main(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.launch.specs import sanitize_specs
    from repro.models.transformer import Transformer

    assert jax.device_count() == 4, jax.device_count()
    mesh = jax.make_mesh(MESH, ("data", "model"))
    jm = Transformer(get_config("qwen3-0.6b"))
    example = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                             jnp.float32))
    specs = sanitize_specs(example, jm.specs(), mesh)
    params_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)

    def prefill(p, t):
        return jm.forward(p, t, None, unroll=True)[0][:, -1, :]

    jitted = jax.jit(prefill, in_shardings=(params_sh,
                                            NamedSharding(mesh, P("data"))))
    with set_mesh(mesh):
        cost = jitted.lower(example, tok).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    with open(path, "w") as f:
        json.dump({"flops": float(cost["flops"])}, f)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", ""))
    main(sys.argv[1])
