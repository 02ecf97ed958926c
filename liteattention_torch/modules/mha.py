"""Multi-head self- and cross-attention over the flash kernels (counterpart
of ``liteattention_tpu/modules/mha.py:MHA`` and ``InferenceParams``).

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

* Cross-attention (``cross_attn=True``), as JAX's: q by ``Wq`` from
  ``x``, k and v by ``Wkv`` from ``x_kv`` (``[B, S_kv, dim]``), no rotary
  and no cache (``inference_params`` is not read); the attention is the
  full forward's (B1, non-causal Sq != Sk unless ``causal``), dropout and
  ALiBi included.
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
from liteattention_torch.parallel._collectives import all_reduce, copy_to_group
from liteattention_torch.parallel.tensor_parallel import shard_cols, shard_rows


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
        cross_attn: bool = False,
        head_dim: Optional[int] = None,
    ):
        super().__init__()
        self.cross_attn = cross_attn
        device = resolve_device(device)
        self.dropout = float(dropout)
        self.num_heads = num_heads
        self.num_heads_kv = num_heads_kv or num_heads
        self.head_dim = head_dim or embed_dim // num_heads
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
        hd, kvd = self.num_heads * self.head_dim, self.num_heads_kv * self.head_dim
        if cross_attn:
            self.Wq = Dense(embed_dim, hd, qkv_proj_bias, dtype, device)
            self.Wkv = Dense(embed_dim, 2 * kvd, qkv_proj_bias, dtype, device)
        else:
            self.Wqkv = Dense(embed_dim, hd + 2 * kvd, qkv_proj_bias, dtype, device)
        self.out_proj = Dense(self.num_heads * self.head_dim, embed_dim,
                              out_proj_bias, dtype, device)

    def forward(self, x: torch.Tensor, inference_params: Optional[InferenceParams] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` ``[B, S, dim]`` -> ``[B, S, dim]``; with ``deterministic=False``
        attention dropout at ``dropout``, its seed drawn from ``generator``.
        With ``cross_attn`` k and v come from ``x_kv`` ``[B, S_kv, dim]``
        (required), with no rotary and no cache."""
        b, s, _ = x.shape
        h, hk, d = self.num_heads, self.num_heads_kv, self.head_dim
        if self.cross_attn:
            if x_kv is None:
                raise ValueError("MHA(cross_attn=True) needs x_kv")
            q = self.Wq(x).reshape(b, s, h, d)
            k, v = self.Wkv(x_kv).reshape(b, x_kv.shape[1], 2, hk, d).unbind(2)
            inference_params = None  # no cache and no rotary, as in JAX
        else:
            q, k, v = self.Wqkv(x).split([h * d, hk * d, hk * d], dim=-1)
            q, k, v = q.reshape(b, s, h, d), k.reshape(b, s, hk, d), v.reshape(b, s, hk, d)
        offset = inference_params.seqlen_offset if inference_params is not None else 0
        if self.rotary is not None and not self.cross_attn:
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


class ParallelMHA(nn.Module):
    """Tensor-parallel MHA (JAX ``modules/mha.py:ParallelMHA``): the heads
    split over ``group``'s ``n`` ranks. This rank holds an :class:`MHA` of
    ``num_heads / n`` q heads and ``num_heads_kv / n`` KV heads of the full
    model's head dim (``local_mha``: its ``Wqkv`` the column-parallel
    projection, its ``out_proj`` the row-parallel one, without bias),
    attends with no collective, and the ``all_reduce`` of the output
    projection's partial sums is followed by ``out_bias``. Differentiable:
    the input's gradient is summed over the group (Megatron's copy to the
    group), so it is whole on every rank. Parameters go on ``device``
    (default ``cuda``).
    """

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        group,
        num_heads_kv: Optional[int] = None,
        qkv_proj_bias: bool = True,
        out_proj_bias: bool = True,
        softmax_scale: Optional[float] = None,
        causal: bool = False,
        rotary_emb_dim: int = 0,
        dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        tp = group.size()
        hk = num_heads_kv or num_heads
        if num_heads % tp or hk % tp:
            raise ValueError(f"ParallelMHA: {num_heads} heads / {hk} KV heads do not split "
                             f"over {tp} ranks")
        self.group = group
        self.local_mha = MHA(
            embed_dim, num_heads // tp, num_heads_kv=hk // tp, qkv_proj_bias=qkv_proj_bias,
            out_proj_bias=False, softmax_scale=softmax_scale, causal=causal,
            rotary_emb_dim=rotary_emb_dim, dtype=dtype, device=device,
            head_dim=embed_dim // num_heads,
        )
        self.out_bias = (nn.Parameter(torch.zeros(embed_dim, device=device))
                         if out_proj_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = all_reduce(self.local_mha(copy_to_group(x, self.group)), self.group)
        if self.out_bias is not None:
            out = out + self.out_bias.to(out.dtype)
        return out


def parallel_mha_state_dict(state_dict, num_heads: int, rank: int, tp: int,
                            num_heads_kv: Optional[int] = None):
    """An :class:`MHA`'s ``state_dict`` (``Wqkv``, ``out_proj``) -> rank
    ``rank``'s :class:`ParallelMHA` ``state_dict`` of ``tp`` ranks: its q,
    k and v heads of ``Wqkv`` (weight and bias), its input columns of
    ``out_proj``, and ``out_proj``'s bias as ``out_bias``. A JAX
    ``ParallelMHA`` rank's own Flax tree converts as it is
    (:func:`~liteattention_torch.models.convert.state_dict_from_flax`)."""
    hk = num_heads_kv or num_heads
    w = state_dict["Wqkv.weight"]
    d = w.shape[0] // (num_heads + 2 * hk)
    sections = [num_heads * d, hk * d, hk * d]
    out = {"local_mha.Wqkv.weight": shard_rows(w, rank, tp, sections),
           "local_mha.out_proj.weight": shard_cols(state_dict["out_proj.weight"], rank, tp)}
    if "Wqkv.bias" in state_dict:
        out["local_mha.Wqkv.bias"] = shard_rows(state_dict["Wqkv.bias"], rank, tp, sections)
    if "out_proj.bias" in state_dict:
        out["out_bias"] = state_dict["out_proj.bias"]
    return out


__all__ = ["MHA", "InferenceParams", "ParallelMHA", "alibi_slopes", "draw_dropout_seed",
           "parallel_mha_state_dict"]
