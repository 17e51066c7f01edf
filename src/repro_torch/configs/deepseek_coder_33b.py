"""deepseek-coder-33b [dense] — deep llama-arch code model.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
[arXiv:2401.14196] 56 heads over a 16-way model axis is a non-divisible
sharding — GSPMD pads (DESIGN.md §4). long_500k via the SWA variant.
"""
from repro_torch.configs.base import ArchConfig, register


@register("deepseek-coder-33b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b",
        family="dense",
        source="arXiv:2401.14196",
        num_layers=62,
        d_model=7168,
        d_ff=19200,
        vocab_size=32256,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e5,
        sliding_window=4096,
        long_context_mode="swa",
    )
