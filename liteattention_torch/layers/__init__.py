"""Layers without kernels (counterpart of ``liteattention_tpu/layers``):
rotary embeddings, patch embedding."""

from liteattention_torch.layers.patch_embed import PatchEmbed
from liteattention_torch.layers.rotary import (
    RotaryEmbedding,
    apply_rotary_emb,
    rotary_freqs,
)

__all__ = ["RotaryEmbedding", "apply_rotary_emb", "rotary_freqs", "PatchEmbed"]
