"""Model configurations of the port: the paper's CNN and MLP
(``paper_cnn``, ``paper_mlp``) and the LM zoo's registry (``base``, a
copy of ``repro.configs.base``).

All ten zoo architectures of the JAX package are registered, each module
a copy of its ``repro.configs`` original: ``qwen3-0.6b``, ``rwkv6-3b``,
``jamba-v0.1-52b``, ``granite-moe-1b-a400m``, ``mistral-nemo-12b``,
``deepseek-coder-33b``, ``qwen3-moe-30b-a3b``, ``minicpm3-4b`` (MLA),
``whisper-small`` (encoder-decoder) and ``pixtral-12b`` (vision
patches).
"""
from repro_torch.configs.base import (
    ArchConfig,
    MambaConfig,
    MlaConfig,
    MoEConfig,
    RwkvConfig,
    ShapeConfig,
    SHAPES,
    get_config,
    list_configs,
    register,
)

# Importing a module registers its architecture.
from repro_torch.configs import (  # noqa: F401
    deepseek_coder_33b,
    granite_moe_1b_a400m,
    jamba_v01_52b,
    minicpm3_4b,
    mistral_nemo_12b,
    pixtral_12b,
    qwen3_0_6b,
    qwen3_moe_30b_a3b,
    rwkv6_3b,
    whisper_small,
)

__all__ = [
    "ArchConfig", "MambaConfig", "MlaConfig", "MoEConfig", "RwkvConfig",
    "ShapeConfig", "SHAPES", "get_config", "list_configs", "register",
]
