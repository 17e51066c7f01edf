"""Model configurations of the port: the paper's CNN and MLP
(``paper_cnn``, ``paper_mlp``) and the LM zoo's registry (``base``, a
copy of ``repro.configs.base``).

Registered: ``qwen3-0.6b``, ``rwkv6-3b`` and ``jamba-v0.1-52b``.
:func:`get_config` of another zoo name raises a ``KeyError`` naming the
ROADMAP item that brings it.
"""
from repro_torch.configs import base as _base
from repro_torch.configs.base import (
    ArchConfig,
    MambaConfig,
    MlaConfig,
    MoEConfig,
    RwkvConfig,
    ShapeConfig,
    SHAPES,
    list_configs,
    register,
)

# Importing a module registers its architecture.
from repro_torch.configs import (  # noqa: F401
    jamba_v01_52b, qwen3_0_6b, rwkv6_3b)

# The JAX package's other zoo architectures, with the ROADMAP item that
# brings each (Queue A item 13; their kernels are in Queue B).
NOT_PORTED: dict[str, str] = {
    "granite-moe-1b-a400m": "ROADMAP Queue A item 13 (models/moe.py)",
    "qwen3-moe-30b-a3b": "ROADMAP Queue A item 13 (models/moe.py)",
    "mistral-nemo-12b": "ROADMAP Queue A item 13 (the zoo configs)",
    "deepseek-coder-33b": "ROADMAP Queue A item 13 (the zoo configs)",
    "minicpm3-4b": "ROADMAP Queue A item 13 (MLA attention)",
    "pixtral-12b": "ROADMAP Queue A item 13 (vision patches)",
    "whisper-small": "ROADMAP Queue A item 13 (encoder-decoder)",
}


def get_config(name: str) -> ArchConfig:
    """The registered architecture ``name`` (``repro.configs.get_config``);
    a zoo architecture not ported yet raises a ``KeyError`` naming its
    ROADMAP item."""
    if name in NOT_PORTED:
        raise KeyError(f"arch '{name}' is not ported yet: "
                       f"{NOT_PORTED[name]}")
    return _base.get_config(name)


__all__ = [
    "ArchConfig", "MambaConfig", "MlaConfig", "MoEConfig", "NOT_PORTED",
    "RwkvConfig", "ShapeConfig", "SHAPES", "get_config", "list_configs",
    "register",
]
