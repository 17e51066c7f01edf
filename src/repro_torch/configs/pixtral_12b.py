"""pixtral-12b [vlm] — pixtral-ViT frontend (stub) + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409] The vision encoder + projector are a stub
frontend (DESIGN.md: `input_specs` supplies pre-projected patch embeddings
of shape (batch, vision_patches, d_model)); the language backbone consumes
[patch embeds ; text tokens].
"""
from repro_torch.configs.base import ArchConfig, register


@register("pixtral-12b")
def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        source="hf:mistralai/Pixtral-12B-2409",
        num_layers=40,
        d_model=5120,
        d_ff=14336,
        vocab_size=131072,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1e9,          # nemo-style long-context rope base
        vision_patches=1024,
        sliding_window=4096,     # SWA variant for long_500k
        long_context_mode="swa",
    )
