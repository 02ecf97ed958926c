"""Multi-head self-attention over the flash kernels (counterpart of
``liteattention_tpu/modules/mha.py:MHA``, its training path).

A fused ``Wqkv`` projection packs q | k | v along its output (GQA when
``num_heads_kv < num_heads``); the heads go ``[B, S, H, D]`` ->
``[B, H, S, D]`` around :func:`~liteattention_torch.ops.flash_fwd.flash_attention`
(kernel B1 forward, B7 backward) and back through ``out_proj``.

Not ported yet: cross-attention; the decoding cache
(``inference_params``), rotary, ALiBi and attention dropout raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.flash_fwd import flash_attention


class MHA(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        num_heads_kv: Optional[int] = None,
        qkv_proj_bias: bool = True,
        out_proj_bias: bool = True,
        dropout: float = 0.0,
        softmax_scale: Optional[float] = None,
        causal: bool = False,
        rotary_emb_dim: int = 0,
        use_alibi: bool = False,
        dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        unported = {
            "dropout": dropout > 0.0,
            "rotary_emb_dim": rotary_emb_dim > 0, "use_alibi": use_alibi,
        }
        if any(unported.values()):
            raise NotImplementedError(
                f"MHA: {[k for k, v in unported.items() if v]} not ported yet"
            )
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = embed_dim // num_heads
        self.softmax_scale = softmax_scale
        self.causal = causal
        qkv = (self.num_heads + 2 * self.num_heads_kv) * self.head_dim
        self.Wqkv = Dense(embed_dim, qkv, qkv_proj_bias, dtype, device)
        self.out_proj = Dense(self.num_heads * self.head_dim, embed_dim,
                              out_proj_bias, dtype, device)

    def forward(self, x: torch.Tensor, inference_params=None) -> torch.Tensor:
        if inference_params is not None:
            raise NotImplementedError("MHA: the decoding cache is not ported yet")
        b, s, _ = x.shape
        h, hk, d = self.num_heads, self.num_heads_kv, self.head_dim
        q, k, v = self.Wqkv(x).split([h * d, hk * d, hk * d], dim=-1)
        out = flash_attention(
            q.reshape(b, s, h, d).transpose(1, 2),
            k.reshape(b, s, hk, d).transpose(1, 2),
            v.reshape(b, s, hk, d).transpose(1, 2),
            scale=self.softmax_scale, causal=self.causal,
        )
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))


__all__ = ["MHA"]
