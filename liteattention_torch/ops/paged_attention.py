"""Paged-KV decode attention (kernels B9a and B9b).

Counterpart of ``liteattention_tpu/ops/paged_attention.py``: the KV cache
lives in fixed-size pages and each sequence owns a row of a page table.

* :func:`paged_attention` (B9a, replacing ``_paged_kernel``) takes
  head-major pools ``[Hk, num_pages, page_size, D]``.
* :func:`paged_attention_folded` (B9b, replacing ``_paged_folded_kernel``)
  takes native pools ``[num_pages, page_size, Hk, D]`` (the vLLM/HF
  layout), bf16 or int8 with global ``[Hk, D]`` scales.

Both launch the split-KV decode kernel of
:mod:`liteattention_torch.ops.flash_decode` with the page table and the
pools' strides: the pool is read in place, never transposed or copied,
one TMA box per page where pages are smaller than the kernel's key tile
(pages of a multiple of 8 keys; others raise on the card). The q rows of
each KV head are packed (q position, group member), so appends and paged
prefill keep bottom-right causality per q position (``causal``: q row
``i`` sees positions ``< length - Sq + i + 1``). ``pages_per_step`` (a TPU DMA batching knob)
is accepted and ignored; ``int8_mma`` is not ported and raises.

Each wrapper runs its plain PyTorch version (the pages gathered into a
dense cache) for CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from liteattention_torch.ops.flash_decode import decode_plain, launch_decode


def _paged(q, k_pages, v_pages, lengths, page_indices, scale, causal, return_lse,
           k_scale, v_scale, num_splits, head_major, plain, counter):
    decode_rank = q.dim() == 3
    if decode_rank:
        q = q[:, None]
    b, sq, hq, d = q.shape
    if head_major:
        hk, num_pages, page_size, _ = k_pages.shape
        strides = lambda x: (x.stride(1), x.stride(2), x.stride(0))  # noqa: E731
    else:
        num_pages, page_size, hk, _ = k_pages.shape
        strides = lambda x: x.stride()[:3]  # noqa: E731
    if v_pages.shape != k_pages.shape or hq % hk or k_pages.shape[-1] != d:
        raise ValueError(f"incompatible shapes {q.shape} / {k_pages.shape} / {v_pages.shape}")
    group = hq // hk
    if scale is None:
        scale = d**-0.5
    if k_pages.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need k_scale/v_scale [Hk, D] (ops/kv_quant)")
        qf = q.float().reshape(b, sq, hk, group, d) * k_scale[None, None, :, None, :]
        q = qf.to(q.dtype).reshape(b, sq, hq, d)
    qp = q.reshape(b, sq, hk, group, d).transpose(1, 2).reshape(b, hk, sq * group, d)
    causal = causal and sq > 1
    if plain or q.device.type == "cpu":
        tbl = page_indices.long().clamp(0, num_pages - 1)
        s_len = tbl.shape[1] * page_size

        def dense(x):  # -> [B, Hk, S, D] over the table's pages
            if head_major:
                return x[:, tbl].reshape(hk, b, s_len, d).transpose(0, 1)
            return x[tbl].reshape(b, s_len, hk, d).transpose(1, 2)

        o, lse = decode_plain(qp, dense(k_pages), dense(v_pages), lengths, None, group,
                              causal, scale, 0.0, num_splits)
    else:
        o, lse = launch_decode(
            qp, k_pages, v_pages, (num_pages, page_size, hk), strides(k_pages),
            strides(v_pages), lengths, None, group=group, causal=causal, scale=scale,
            softcap=0.0, num_splits=num_splits, capacity=page_indices.shape[1] * page_size,
            table=page_indices, page_size=page_size,
        )
        counter.launches += 1
    if v_scale is not None:
        o = (o.float() * v_scale[None, :, None, :]).to(o.dtype)
    out = o.reshape(b, hk, sq, group, d).transpose(1, 2).reshape(b, sq, hq, d)
    if decode_rank:
        out = out[:, 0]
    if not return_lse:
        return out
    return out, lse.reshape(b, hk, sq, group).transpose(2, 3).reshape(b, hq, sq)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = True,
    return_lse: bool = False,
):
    """Decode / append / prefill attention over head-major page pools
    (kernel B9a).

    Args:
      q: ``[B, Hq, D]`` (single-token decode) or ``[B, Sq, Hq, D]``
        (append / prefill; the new tokens already live in the pages).
      k_pages / v_pages: ``[Hk, num_pages, page_size, D]``.
      lengths: int ``[B]`` live tokens per sequence, the appended ones
        included.
      page_indices: int ``[B, pages_per_seq]``; entries past
        ``ceil(length / page_size)`` are ignored.
      causal: bottom-right causality of the q rows (no-op at Sq 1).

    Returns ``out`` with the rank of ``q`` (and lse fp32 ``[B, Hq, Sq]``
    with ``return_lse``).
    """
    return _paged(q, k_pages, v_pages, lengths, page_indices, scale, causal,
                  return_lse, None, None, 0, True, False, paged_attention)


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices, scale=None,
                          causal=True, return_lse=False):
    """Plain PyTorch version of :func:`paged_attention` on any device."""
    return _paged(q, k_pages, v_pages, lengths, page_indices, scale, causal,
                  return_lse, None, None, 0, True, True, None)


def paged_attention_folded(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = True,
    return_lse: bool = False,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    pages_per_step: Optional[int] = None,
    int8_mma: bool = False,
    num_splits: int = 0,
):
    """Paged decode over native pools ``[num_pages, page_size, Hk, D]``
    (kernel B9b); arguments as :func:`paged_attention`.

    int8 pools (``ops/kv_quant.quantize_kv_pages``) take global
    ``k_scale``/``v_scale`` ``[Hk, D]``: q is multiplied by ``k_scale``
    before the kernel and the output by ``v_scale`` after it.
    ``pages_per_step`` is a TPU DMA knob, accepted and ignored;
    ``int8_mma`` raises (not ported, ROADMAP B9). ``num_splits``: KV
    splits on the card (n > 1: n CTAs per unit; 0 or 1: one CTA per SM,
    balanced over the keys present).
    """
    del pages_per_step
    if int8_mma:
        raise NotImplementedError("paged_attention_folded: int8_mma is not ported (ROADMAP B9)")
    return _paged(q, k_pages, v_pages, lengths, page_indices, scale, causal,
                  return_lse, k_scale, v_scale, num_splits, False, False,
                  paged_attention_folded)


def paged_attention_folded_plain(q, k_pages, v_pages, lengths, page_indices, scale=None,
                                 causal=True, return_lse=False, k_scale=None,
                                 v_scale=None, pages_per_step=None, int8_mma=False,
                                 num_splits=0):
    """Plain PyTorch version of :func:`paged_attention_folded` on any
    device."""
    del pages_per_step
    if int8_mma:
        raise NotImplementedError("paged_attention_folded: int8_mma is not ported (ROADMAP B9)")
    return _paged(q, k_pages, v_pages, lengths, page_indices, scale, causal,
                  return_lse, k_scale, v_scale, num_splits, False, True, None)


paged_attention.launches = 0
paged_attention_folded.launches = 0

__all__ = [
    "paged_attention",
    "paged_attention_plain",
    "paged_attention_folded",
    "paged_attention_folded_plain",
]
