"""int8 KV-cache quantization for bandwidth-bound decode.

Counterpart of ``liteattention_tpu/ops/kv_quant.py``. Decode reads the
whole cache every step and does a few operations per byte, so fewer
bytes is the lever: an int8 cache halves the stream.

Numerics are the JAX package's, bit for bit: symmetric per-channel
scales ``max(absmax / 127, 1e-8)`` (absmax over the sequence axis, or
over pages and slots for page pools), values ``round(x / scale)``
(half to even) clipped to [-127, 127]. The scales fold exactly outside
the decode kernel: k scales multiply q per channel, v scales multiply
the output (``ops/flash_fwd.flash_attention_decode``,
``ops/paged_attention.paged_attention_folded``), so the kernel only
casts int8 to bf16 after the load.

Unlike JAX, whose arrays are immutable, :func:`quantize_kv_append` and
:func:`quantize_pages_append` write the new rows into the given int8
caches in place (and return them): a copy of a multi-GB cache per
decode step would cost more than the step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class QuantizedKVCache(NamedTuple):
    """int8 caches and per-(batch, kv-head, channel) dequant scales.

    ``k``/``v``: int8 ``[B, S, Hk, D]`` (or ``[B, Hk, S, D]`` from
    :func:`quantize_kv_cache_native`); ``k_scale``/``v_scale``: fp32
    ``[B, Hk, D]``.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


class QuantizedKVPages(NamedTuple):
    """int8 page pools ``[num_pages, page_size, Hk, D]`` and global
    per-(kv-head, channel) scales ``[Hk, D]`` (pages are shared across
    sequences, so the scales carry no batch axis)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(x / scale)`` clipped to [-127, 127]; ``scale`` broadcasts."""
    return torch.round(x.float() / scale).clamp_(-127.0, 127.0).to(torch.int8)


def _absmax_scale(x: torch.Tensor, dims) -> torch.Tensor:
    return (x.float().abs().amax(dim=dims) / 127.0).clamp_min(1e-8)


def quantize_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor) -> QuantizedKVCache:
    """Quantize float caches ``[B, S, Hk, D]`` to int8 (e.g. once after
    prefill), absmax over S. Zero padding never raises the absmax."""
    ks, vs = _absmax_scale(k_cache, 1), _absmax_scale(v_cache, 1)
    return QuantizedKVCache(_q8(k_cache, ks[:, None]), _q8(v_cache, vs[:, None]), ks, vs)


def quantize_kv_append(
    cache: QuantizedKVCache,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,
) -> QuantizedKVCache:
    """Write new float rows ``[B, S_new, Hk, D]`` into the int8 ``[B, S,
    Hk, D]`` cache at ``positions`` ``[B]`` (the lengths before the
    append), quantized with the cache's existing scales (values beyond
    the calibrated absmax clamp). In place; returns ``cache``."""
    b, s_new = k_new.shape[:2]
    idx = positions.long()[:, None] + torch.arange(s_new, device=positions.device)[None]
    bi = torch.arange(b, device=positions.device)[:, None]
    cache.k[bi, idx] = _q8(k_new, cache.k_scale[:, None])
    cache.v[bi, idx] = _q8(v_new, cache.v_scale[:, None])
    return cache


def quantize_rows_native(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize head-major rows ``[B, Hk, S_new, D]`` with existing scales
    ``[B, Hk, D]`` (clamped: decode appends)."""
    return _q8(x, scale[:, :, None, :])


def quantize_kv_cache_native(k_cache: torch.Tensor, v_cache: torch.Tensor) -> QuantizedKVCache:
    """Quantize head-major caches ``[B, Hk, S, D]`` (the MHA decode cache,
    ``kv_cache_layout="bhsd"``), absmax over S; the int8 caches stay
    head-major."""
    ks, vs = _absmax_scale(k_cache, 2), _absmax_scale(v_cache, 2)
    return QuantizedKVCache(
        quantize_rows_native(k_cache, ks), quantize_rows_native(v_cache, vs), ks, vs
    )


def quantize_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor) -> QuantizedKVPages:
    """Quantize float pools ``[num_pages, page_size, Hk, D]`` with global
    per-(kv-head, channel) scales (zero-filled dead pages never raise
    the absmax)."""
    ks, vs = _absmax_scale(k_pages, (0, 1)), _absmax_scale(v_pages, (0, 1))
    return QuantizedKVPages(_q8(k_pages, ks), _q8(v_pages, vs), ks, vs)


def quantize_pages_append(
    pages: QuantizedKVPages,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
) -> QuantizedKVPages:
    """Scatter new float rows ``[B, S_new, Hk, D]`` into the int8 pools at
    ``positions`` ``[B]`` through ``page_table`` ``[B, pages]``,
    quantized with the pools' scales. In place; returns ``pages``."""
    b, s_new, hk, d = k_new.shape
    page_size = pages.k.shape[1]
    pos = positions.long()[:, None] + torch.arange(s_new, device=positions.device)[None]
    page_of = torch.gather(page_table.long(), 1, pos // page_size).reshape(-1)
    slot = (pos % page_size).reshape(-1)
    pages.k[page_of, slot] = _q8(k_new, pages.k_scale).reshape(-1, hk, d)
    pages.v[page_of, slot] = _q8(v_new, pages.v_scale).reshape(-1, hk, d)
    return pages


def dequantize_kv_cache(
    cache: QuantizedKVCache, dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dequantization of a ``[B, S, Hk, D]`` cache (tests)."""
    k = cache.k.float() * cache.k_scale[:, None]
    v = cache.v.float() * cache.v_scale[:, None]
    return k.to(dtype), v.to(dtype)


__all__ = [
    "QuantizedKVCache",
    "QuantizedKVPages",
    "quantize_kv_cache",
    "quantize_kv_cache_native",
    "quantize_rows_native",
    "quantize_kv_append",
    "quantize_kv_pages",
    "quantize_pages_append",
    "dequantize_kv_cache",
]
