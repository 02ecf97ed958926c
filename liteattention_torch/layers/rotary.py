"""Rotary position embeddings (1D, GPT/LLaMA-style).

Counterpart of ``liteattention_tpu/layers/rotary.py``. The rotation is a
handful of elementwise ops on the projected q/k, so there is no kernel:
a functional API and a stateless module. The rotation runs in fp32 and
casts back to the input dtype.

Both the GPT-NeoX convention (half split, ``interleaved=False``) and the
GPT-J convention (even/odd interleave, ``interleaved=True``) are taken;
a rotary dim below the head dim rotates the first ``rotary_dim``
features and passes the rest through.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from liteattention_torch.device import resolve_device


def rotary_freqs(
    seqlen: int,
    rotary_dim: int,
    base: float = 10000.0,
    offset: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape ``[seqlen, rotary_dim // 2]`` (fp32) for
    positions ``offset .. offset + seqlen - 1``, on ``device`` (default
    ``cuda``)."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    inv = 1.0 / (base ** (torch.arange(0, rotary_dim, 2, **f32) / rotary_dim))
    pos = torch.arange(offset, offset + seqlen, **f32)
    freqs = torch.outer(pos, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_emb(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    interleaved: bool = False,
) -> torch.Tensor:
    """Rotate ``x`` ``[..., S, H, D]``: the first ``2 * cos.shape[-1]``
    features of D rotate, the rest pass through."""
    ro_dim = 2 * cos.shape[-1]
    xf = x[..., :ro_dim].float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        rotated = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
        rotated = rotated.reshape(xf.shape)
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        rotated = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    rotated = rotated.to(x.dtype)
    if ro_dim < x.shape[-1]:
        rotated = torch.cat([rotated, x[..., ro_dim:]], dim=-1)
    return rotated


class RotaryEmbedding(nn.Module):
    """Stateless rotary module (``RotaryEmbedding(dim, base,
    interleaved)``); ``forward(q, k, seqlen_offset)`` rotates q and k
    ``[B, S, H, D]`` at positions ``seqlen_offset + 0 .. S - 1``."""

    def __init__(self, dim: int, base: float = 10000.0, interleaved: bool = False):
        super().__init__()
        self.dim = dim
        self.base = base
        self.interleaved = interleaved

    def forward(self, q: torch.Tensor, k: torch.Tensor, seqlen_offset: int = 0):
        cos, sin = rotary_freqs(q.shape[-3], self.dim, self.base, seqlen_offset, q.device)
        return (
            apply_rotary_emb(q, cos, sin, self.interleaved),
            apply_rotary_emb(k, cos, sin, self.interleaved),
        )


__all__ = ["RotaryEmbedding", "apply_rotary_emb", "rotary_freqs"]
