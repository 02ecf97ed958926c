"""2D patch embedding for ViT-style models.

Counterpart of ``liteattention_tpu/layers/patch_embed.py:PatchEmbed`` on
channels-last images ``[B, H, W, C]``, as in JAX: each ``ph x pw`` patch
is flattened in (ph, pw, c) order and projected by one linear layer
(fp32 parameters, computing in ``dtype``; the same function as a strided
Conv2d whose weight is permuted to that order). ``norm`` adds a
LayerNorm (eps 1e-6, flax's default) over the embedding; ``flatten=False``
keeps the patch grid, ``[B, gh, gw, embed_dim]``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from liteattention_torch.device import resolve_device
from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.norms import layer_norm


class PatchEmbed(nn.Module):
    """``[B, H, W, C]`` -> ``[B, N_patches, embed_dim]``. ``in_chans`` is
    the images' C (flax infers it from the first call)."""

    def __init__(self, patch_size: Tuple[int, int] = (16, 16), embed_dim: int = 768,
                 in_chans: int = 3, bias: bool = True, flatten: bool = True,
                 norm: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.patch_size, self.embed_dim, self.flatten = tuple(patch_size), embed_dim, flatten
        ph, pw = self.patch_size
        self.proj = Dense(ph * pw * in_chans, embed_dim, bias, dtype, device)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6, device=device) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ph, pw = self.patch_size
        if h % ph or w % pw:
            raise ValueError(f"image size ({h},{w}) not divisible by patch size ({ph},{pw})")
        gh, gw = h // ph, w // pw
        x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
        x = self.proj(x.reshape(b, gh * gw, ph * pw * c))
        if self.norm is not None:
            x = layer_norm(x, self.norm.weight, self.norm.bias, eps=self.norm.eps)
        if not self.flatten:
            x = x.reshape(b, gh, gw, self.embed_dim)
        return x


__all__ = ["PatchEmbed"]
