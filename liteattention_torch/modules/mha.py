"""Multi-head self-attention over the flash kernels (counterpart of
``liteattention_tpu/modules/mha.py:MHA`` and ``InferenceParams``).

A fused ``Wqkv`` projection packs q | k | v along its output (GQA when
``num_heads_kv < num_heads``); rotary embeddings rotate q and k at the
decode offset; the heads go ``[B, S, H, D]`` -> ``[B, H, S, D]`` around
the attention and back through ``out_proj``.

* Training / full forward: causal
  :func:`~liteattention_torch.ops.flash_fwd.flash_attention` (kernel B1
  forward, B7 backward). With ``use_alibi`` the forward takes B1's ALiBi
  channel (:func:`~liteattention_torch.ops.flash_fwd.flash_attention_masked`
  with :func:`alibi_slopes`) and the backward B7's. The cached path below
  is forward-only, as in JAX.
* Decoding (``inference_params``): a cache per layer, keyed by
  ``layer_idx``, in the head-major layout ``[B, Hk, S_max, D]``. The new
  rows are written in place at ``seqlen_offset`` (quantized with the
  frozen scales when the entry is int8). A single-token step without
  ALiBi goes to
  :func:`~liteattention_torch.ops.flash_fwd.flash_attention_decode`
  (kernel B8) with the ``group`` q heads packed as rows over each KV head;
  the cache is handed over as a strided view, never copied. Prefill,
  multi-token steps and every ALiBi step run B1 over the whole cache with
  the per-batch bound ``offset + s_new`` and ``bound_causal`` (JAX's
  route): the walk stops at the bound's diagonal, so the keys past it cost
  nothing and nothing is copied. A multi-token step on an int8 cache
  raises, as in JAX.
* Attention dropout (``dropout`` > 0, a call with ``deterministic=False``
  and a ``generator``, JAX's flax "dropout" stream): each call draws an
  int32 seed from the generator on the device (:func:`draw_dropout_seed`,
  no host sync) and hands it to B1's and B7's dropout instantiations,
  which regenerate the keep mask from it. The cached path takes none, as
  in JAX.

Not ported yet: cross-attention raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from liteattention_torch.device import resolve_device
from liteattention_torch.layers.rotary import RotaryEmbedding
from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.flash_fwd import flash_attention_decode, flash_attention_masked
from liteattention_torch.ops.kv_quant import quantize_rows_native


@dataclasses.dataclass
class InferenceParams:
    """Decoding-time KV cache holder: ``key_value_memory_dict`` maps a
    layer's ``layer_idx`` to ``(k, v)`` ``[B, Hk, S_max, D]`` or, once
    int8-quantized, ``(k_i8, v_i8, k_scale, v_scale)``."""

    max_seqlen: int
    max_batch_size: int
    seqlen_offset: int = 0
    key_value_memory_dict: dict = dataclasses.field(default_factory=dict)

    def reset(self):
        self.seqlen_offset = 0
        self.key_value_memory_dict.clear()


def alibi_slopes(nheads: int) -> torch.Tensor:
    """The ALiBi slope of each head, fp32 ``[nheads]`` (JAX
    ``modules/mha.py:alibi_slopes``): geometric from ``2^(-8/n)``; for a
    head count that is not a power of two, the slopes of the power of two
    below it, then every other slope of twice that count."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(nheads).is_integer():
        return torch.tensor(pow2(nheads), dtype=torch.float32)
    closest = 2 ** int(math.floor(math.log2(nheads)))
    extra = pow2(2 * closest)[0::2][: nheads - closest]
    return torch.tensor(pow2(closest) + extra, dtype=torch.float32)


def draw_dropout_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """An int32 seed ``[1]`` for the attention-dropout kernels, drawn from
    ``generator`` on ``device`` (JAX draws ``randint(rng, (), -2**31, 2**31
    - 1, int32)``); a ``generator`` is required, as JAX's ``make_rng``
    needs an rng."""
    if generator is None:
        raise ValueError("attention dropout requires a torch.Generator (generator=)")
    return torch.randint(-(2**31), 2**31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int32)


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
        rotary_emb_base: float = 10000.0,
        rotary_emb_interleaved: bool = False,
        use_alibi: bool = False,
        layer_idx: Optional[int] = None,
        dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dropout = float(dropout)
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = embed_dim // num_heads
        self.softmax_scale = softmax_scale
        self.causal = causal
        self.layer_idx = layer_idx
        # The slopes as a buffer (None without ALiBi), so no step copies them
        # from the host.
        self.register_buffer(
            "alibi", alibi_slopes(num_heads).to(device) if use_alibi else None, persistent=False
        )
        self.rotary = (
            RotaryEmbedding(rotary_emb_dim, rotary_emb_base, rotary_emb_interleaved)
            if rotary_emb_dim > 0 else None
        )
        qkv = (self.num_heads + 2 * self.num_heads_kv) * self.head_dim
        self.Wqkv = Dense(embed_dim, qkv, qkv_proj_bias, dtype, device)
        self.out_proj = Dense(self.num_heads * self.head_dim, embed_dim,
                              out_proj_bias, dtype, device)

    def forward(self, x: torch.Tensor, inference_params: Optional[InferenceParams] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` ``[B, S, dim]`` -> ``[B, S, dim]``; with ``deterministic=False``
        attention dropout at ``dropout``, its seed drawn from ``generator``."""
        b, s, _ = x.shape
        h, hk, d = self.num_heads, self.num_heads_kv, self.head_dim
        q, k, v = self.Wqkv(x).split([h * d, hk * d, hk * d], dim=-1)
        q, k, v = q.reshape(b, s, h, d), k.reshape(b, s, hk, d), v.reshape(b, s, hk, d)
        offset = inference_params.seqlen_offset if inference_params is not None else 0
        if self.rotary is not None:
            q, k = self.rotary(q, k, seqlen_offset=offset)
        if inference_params is None:
            drop = self.dropout if self.dropout > 0.0 and not deterministic else 0.0
            out = flash_attention_masked(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                alibi_slopes=self.alibi, scale=self.softmax_scale, causal=self.causal,
                dropout_p=drop,
                dropout_seed=draw_dropout_seed(generator, x.device) if drop else None,
            )
        else:
            out = self._decode(q, k, v, inference_params, offset)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))

    def _decode(self, q, k, v, inference_params, offset):
        """Append k/v ``[B, S_new, Hk, D]`` to this layer's cache and attend
        over it; returns ``[B, H, S_new, D]``."""
        if self.layer_idx is None:
            raise ValueError("MHA: decoding with a cache needs layer_idx")
        b, s_new, hk, d = k.shape
        cache = inference_params.key_value_memory_dict
        if self.layer_idx not in cache:
            shape = (b, hk, inference_params.max_seqlen, d)
            cache[self.layer_idx] = (
                torch.zeros(shape, dtype=k.dtype, device=k.device),
                torch.zeros(shape, dtype=v.dtype, device=v.device),
            )
        entry = cache[self.layer_idx]
        quantized = len(entry) == 4
        kc, vc = entry[0], entry[1]
        kn, vn = k.transpose(1, 2), v.transpose(1, 2)
        if quantized:
            kn, vn = quantize_rows_native(kn, entry[2]), quantize_rows_native(vn, entry[3])
        kc[:, :, offset : offset + s_new] = kn
        vc[:, :, offset : offset + s_new] = vn
        qh = q.transpose(1, 2)
        bound = torch.full((b,), offset + s_new, dtype=torch.int32, device=q.device)
        if s_new == 1 and self.alibi is None:
            out, _ = flash_attention_decode(
                qh, kc.transpose(1, 2), vc.transpose(1, 2), kv_bound=bound,
                scale=self.softmax_scale,
                k_scale=entry[2] if quantized else None,
                v_scale=entry[3] if quantized else None,
            )
            return out
        if quantized:
            raise NotImplementedError(
                "MHA: the int8 decode cache takes single-token steps without ALiBi only "
                "(quantize after prefill)"
            )
        return flash_attention_masked(
            qh, kc, vc, kv_bound=bound, alibi_slopes=self.alibi, scale=self.softmax_scale,
            bound_causal=self.causal,
        )


__all__ = ["MHA", "InferenceParams", "alibi_slopes", "draw_dropout_seed"]
