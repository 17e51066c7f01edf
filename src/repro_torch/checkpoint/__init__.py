"""Host-side checkpointing (npz + json manifest, the JAX package's
format)."""
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
