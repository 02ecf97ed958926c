"""Vision Transformer on the flash kernels.

Counterpart of ``liteattention_tpu/models/vit.py`` (``ViTConfig``,
``VisionTransformer``): a patch embedding of channels-last images
(:class:`~liteattention_torch.layers.patch_embed.PatchEmbed`), a cls token
and learned positions (fp32 parameters, added in ``cfg.dtype``), pre-norm
blocks whose residual stream runs in fp32, the final LayerNorm and an fp32
classification head over the cls token (the mean over the patches
without it). The attention is non-causal: B1 forward and B7 backward on
the card, their plain versions on the CPU. ``ViTConfig()`` is ViT-B/16 at
224 x 224 (197 tokens: a ragged last 128-row tile and key tile).
JAX's ``block_sizes`` (the TPU kernel's tiles) has no counterpart: the
card's kernels pick their own tiles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from liteattention_torch.device import resolve_device
from liteattention_torch.layers.patch_embed import PatchEmbed
from liteattention_torch.models.convert import state_dict_from_flax
from liteattention_torch.modules.block import Block
from liteattention_torch.modules.dense import Dense
from liteattention_torch.modules.mha import MHA
from liteattention_torch.modules.mlp import Mlp
from liteattention_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """JAX ``ViTConfig``'s fields (less ``block_sizes``), plus the images'
    channel count, which flax infers from the first call."""

    image_size: Tuple[int, int] = (224, 224)
    patch_size: Tuple[int, int] = (16, 16)
    num_classes: int = 1000
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    use_cls_token: bool = True
    dtype: Any = torch.bfloat16
    in_chans: int = 3

    @staticmethod
    def tiny():
        return ViTConfig(image_size=(32, 32), patch_size=(8, 8), num_classes=10, dim=64,
                         num_layers=2, num_heads=2, ffn_dim=128)

    @property
    def num_tokens(self) -> int:
        (h, w), (ph, pw) = self.image_size, self.patch_size
        return (h // ph) * (w // pw) + int(self.use_cls_token)


class VisionTransformer(nn.Module):
    """``forward(images [B, H, W, C])`` -> fp32 logits ``[B, num_classes]``.
    Parameters go on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.dim, cfg.in_chans, dtype=cfg.dtype,
                                      device=device)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, cfg.dim, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg.dim, MHA(cfg.dim, cfg.num_heads, dtype=cfg.dtype, device=device),
                  Mlp(cfg.dim, cfg.ffn_dim, dtype=cfg.dtype, device=device), prenorm=True,
                  residual_in_fp32=True, dtype=cfg.dtype, device=device)
            for _ in range(cfg.num_layers))
        self.norm_scale = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.norm_bias = nn.Parameter(torch.zeros(cfg.dim, device=device))
        self.head = Dense(cfg.dim, cfg.num_classes, True, torch.float32, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``, JAX's initializer scales up to
        truncation: ``N(0, 1/fan_in)`` Dense kernels, ``N(0, 0.02)`` cls token
        and positions, zero biases, unit norm scales."""
        for name, p in self.named_parameters():
            if name in ("cls_token", "pos_embed"):
                p.normal_(0.0, 0.02, generator=generator)
            elif p.dim() == 2:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed(images)
        b = x.shape[0]
        if cfg.use_cls_token:
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, cfg.dim), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        residual = None
        for blk in self.blocks:
            x, residual = blk(x, residual)
        x = (x.float() + residual).to(cfg.dtype)
        x = layer_norm(x, self.norm_scale, self.norm_bias)
        feat = x[:, 0] if cfg.use_cls_token else x.mean(dim=1)
        return self.head(feat.float())


def vit_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` params -> this module's ``state_dict``
    (``patch_embed/proj/kernel`` -> ``patch_embed.proj.weight`` transposed,
    ``block_i`` -> ``blocks.i``, ``cls_token``, ``pos_embed``, ``norm_scale``
    and ``norm_bias`` as they are, ``head/kernel`` -> ``head.weight``)."""
    return state_dict_from_flax(params)


__all__ = ["ViTConfig", "VisionTransformer", "vit_state_dict_from_jax"]
