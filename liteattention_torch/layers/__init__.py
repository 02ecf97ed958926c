"""Layers without kernels (counterpart of ``liteattention_tpu/layers``)."""

from liteattention_torch.layers.rotary import (
    RotaryEmbedding,
    apply_rotary_emb,
    rotary_freqs,
)

__all__ = ["RotaryEmbedding", "apply_rotary_emb", "rotary_freqs"]
