"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA).

62L d_model=2560 40H (kv=40 — MLA has per-head latents, no GQA grouping)
d_ff=6400 vocab=73448. [hf:openbmb/MiniCPM3-4B]
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
long_500k runs natively: the MLA cache stores the compressed latent
(kv_lora_rank + qk_rope per token = 288 floats), and decode uses the
absorbed-matrix trick, so a 512k cache is only ~0.3 GB.
"""
from repro_torch.configs.base import ArchConfig, MlaConfig, register


@register("minicpm3-4b")
def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B",
        num_layers=62,
        d_model=2560,
        d_ff=6400,
        vocab_size=73448,
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,
        attention_kind="mla",
        mla=MlaConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
        rope_theta=1e4,
        tie_embeddings=True,
        long_context_mode="native",
    )
