"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887] Jamba period: 8 blocks with one attention layer at
index 4 of each period; MoE replaces the MLP in every second block.
Attention layers carry no positional encoding (Mamba provides position).
"""
from repro_torch.configs.base import (ArchConfig, MambaConfig, MoEConfig,
                                      register)


@register("jamba-v0.1-52b")
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=65536,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        block_pattern=(
            "mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba",
        ),
        use_rope=False,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        long_context_mode="native",  # 4 full-attn layers -> O(L) decode
    )
