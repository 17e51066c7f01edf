"""granite-moe-1b-a400m [moe] — small 32-expert top-8 MoE.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base] d_ff=512 is the per-expert
intermediate size; embeddings tied (granite ties input/output embeddings).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("granite-moe-1b-a400m")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=24,
        d_model=1024,
        d_ff=512,
        vocab_size=49155,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        rope_theta=1e4,
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512, every=1),
        tie_embeddings=True,
        sliding_window=4096,
        long_context_mode="swa",
    )
