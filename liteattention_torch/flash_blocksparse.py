"""FA1-era block-sparse attention API (static block masks).

Counterpart of ``liteattention_tpu/flash_blocksparse.py``. The original
masks attention at a fixed 16 x 256 block granularity (layout rows are 16
q positions, columns 256 k positions) with a static 0/1 layout.

The kernel route is the skip-masked engine: a 16 x 256 layout is exactly
a fine 128 x 128 tile mask when every group of 8 consecutive layout rows
is identical (a column always splits into two fine tiles), and then
:func:`~liteattention_torch.flash_attn_interface.flash_attn_func` runs it
with ``attn_read_list`` (kernels B2 and B3 on the card). The other cases
-- a layout that is not uniform per 8 rows, ``causal``, dropout, ragged
``cu_seqlens``, ``return_attn_probs``, ``trainable`` or a
``key_padding_mask`` -- have no kernel yet: on CUDA tensors they raise
``NotImplementedError`` naming themselves. On CPU tensors they run the
exact path, :func:`_exact_attention`, the plain PyTorch version that
applies the layout at its own 16 x 256 granularity (JAX's XLA
fallback). It masks with a finite -1e30, so it is differentiable and a
fully masked row gives out 0 and gradient 0; its dropout takes an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from liteattention_torch.flash_attn_interface import flash_attn_func

BLOCK_ROWS = 16   # q positions per layout row
BLOCK_COLS = 256  # k positions per layout column
_MASK_VALUE = -1e30


def convert_blockmask(blockmask, causal: bool = False) -> np.ndarray:
    """A 0/1 layout ``[nrow, ncol]`` -> the fine 128 x 128 bool tile mask
    ``[ceil(nrow / 8), 2 * ncol]`` (numpy): the OR over each 8-row group,
    each column split in two. Exact iff the layout is uniform within each
    8-row group."""
    if causal:
        raise ValueError("causal + blockmask is handled by the caller")
    bm = np.asarray(blockmask) != 0
    nrow, ncol = bm.shape
    pad = (-nrow) % 8
    if pad:
        bm = np.concatenate([bm, np.zeros((pad, ncol), bool)], axis=0)
    fine_q = bm.reshape(-1, 8, ncol).any(axis=1)
    return np.repeat(fine_q, BLOCK_COLS // 128, axis=1)


def _row_group_uniform(blockmask) -> bool:
    bm = np.asarray(blockmask) != 0
    return all((bm[g0:g0 + 8] == bm[g0]).all() for g0 in range(0, bm.shape[0], 8))


def _no_kernel(x: torch.Tensor, cases: dict) -> None:
    """Raise for a CUDA tensor when one of ``cases`` (name -> taken)
    needs the exact path, which has no kernel."""
    taken = [name for name, on in cases.items() if on]
    if x.is_cuda and taken:
        raise NotImplementedError(
            f"block-sparse attention with {', '.join(taken)} has no CUDA kernel yet "
            "(only equal lengths, no causal, no dropout, a layout uniform per 8 rows)"
        )


def _blockmask_elementwise(blockmask, sq: int, sk: int, device) -> torch.Tensor:
    """The layout as an ``[sq, sk]`` bool element mask (16 x 256 blocks)."""
    bm = torch.as_tensor(np.asarray(blockmask) != 0, device=device)
    el = bm.repeat_interleave(BLOCK_ROWS, dim=0).repeat_interleave(BLOCK_COLS, dim=1)
    return el[:sq, :sk]


def _exact_attention(q, k, v, element_mask, softmax_scale, causal, key_valid=None,
                     dropout_p=0.0, generator=None, return_attn_probs=False):
    """Block-sparse attention at the layout's own granularity, ``[B, S, H,
    D]``, fp32 math: masked blocks leave the softmax, fully masked rows give
    out 0. With ``return_attn_probs``: ``(out, probs, lse)``, lse natural
    log ``[B, H, Sq]`` (-inf on fully masked rows)."""
    if dropout_p > 0.0 and generator is None:
        raise ValueError("dropout_p > 0 needs a torch.Generator (generator=)")
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = element_mask[None, None]
    if causal:
        tri = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        mask = mask & tri
    if key_valid is not None:  # [B, sk] bool
        mask = mask & key_valid[:, None, None, :]
    scores = torch.where(mask, scores, _MASK_VALUE)
    row_any = mask.any(dim=-1, keepdim=True)
    probs = torch.where(row_any, torch.softmax(scores, dim=-1), 0.0)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator, device=probs.device) >= dropout_p
        probs = probs * keep / (1.0 - dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    if not return_attn_probs:
        return out
    lse = torch.logsumexp(torch.where(mask, scores, -math.inf), dim=-1)
    return out, probs, lse


def flash_blocksparse_attn_func(
    qkv: torch.Tensor,
    cu_seqlens,
    blockmask,
    dropout_p: float = 0.0,
    max_s: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    return_attn_probs: bool = False,
    convert_mask: bool = True,
    generator: Optional[torch.Generator] = None,
    trainable: bool = False,
):
    """Block-sparse attention on packed varlen QKV ``[total, 3, H, D]`` with
    ``cu_seqlens`` boundaries; ``blockmask`` is the static 0/1 layout
    ``[ceil(S/16), ceil(S/256)]`` shared by all sequences
    (``convert_mask=False``: already the fine mask of
    :func:`convert_blockmask`).

    An equal-length, non-causal call without dropout on a representable
    mask runs the kernel route (forward only). Anything else, or
    ``trainable=True``, raises on CUDA tensors and runs the exact path on
    CPU tensors. ``generator`` draws the exact path's dropout (JAX's
    ``dropout_rng``). With ``return_attn_probs`` returns ``(out, probs,
    lse)`` on the padded ``[B, max_s]`` layout.
    """
    cu = np.asarray(torch.as_tensor(cu_seqlens).cpu())
    lens = cu[1:] - cu[:-1]
    batch = len(lens)
    max_s = int(max_s if max_s is not None else lens.max())
    bm_np = np.asarray(blockmask)
    representable = (not convert_mask) or _row_group_uniform(bm_np)
    fine = convert_blockmask(bm_np) if convert_mask else bm_np != 0
    h, d = qkv.shape[-2], qkv.shape[-1]

    exact_cases = {
        "ragged cu_seqlens": not bool((lens == lens[0]).all()),
        "a layout not uniform per 8 rows": not representable,
        "causal": causal,
        "dropout": dropout_p > 0.0,
        "return_attn_probs": return_attn_probs,
        "trainable": trainable,
    }
    _no_kernel(qkv, exact_cases)
    if not any(exact_cases.values()):
        s = int(lens[0])
        q, k, v = (qkv[:, i].reshape(batch, s, h, d) for i in range(3))
        qt = -(-s // 128)
        read = torch.as_tensor(fine[:qt, :qt], device=qkv.device)
        read = read[None, None].expand(batch, h, qt, qt)
        out = flash_attn_func(q, k, v, softmax_scale=softmax_scale, attn_read_list=read)
        return out.reshape(batch * s, h, d)

    # Exact path: pad each sequence to max_s, mask the padded keys.
    packed = qkv.new_zeros((batch, max_s) + tuple(qkv.shape[1:]))
    for i in range(batch):
        packed[i, : int(lens[i])] = qkv[int(cu[i]) : int(cu[i + 1])]
    q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
    lens_t = torch.as_tensor(lens, device=qkv.device)
    key_valid = torch.arange(max_s, device=qkv.device)[None, :] < lens_t[:, None]
    if convert_mask:
        el = _blockmask_elementwise(bm_np, max_s, max_s, qkv.device)
    else:
        el = torch.as_tensor(fine, device=qkv.device)
        el = el.repeat_interleave(128, dim=0).repeat_interleave(128, dim=1)[:max_s, :max_s]
    res = _exact_attention(
        q, k, v, el, softmax_scale, causal, key_valid=key_valid, dropout_p=dropout_p,
        generator=generator, return_attn_probs=return_attn_probs,
    )
    out, probs, lse = res if return_attn_probs else (res, None, None)
    flat = torch.cat([out[i, : int(lens[i])] for i in range(batch)], dim=0)
    return (flat, probs, lse) if return_attn_probs else flat


class FlashBlocksparseAttention:
    """Block-sparse attention over ``[B, S, 3, H, D]`` packed QKV.

    Takes a concrete layout array, or an object with
    ``make_layout(max_seq_length)`` (the original's DeepSpeed-style
    ``sparsity_config``). ``key_padding_mask`` is bool ``[B, S]`` (True =
    keep): the padded keys are masked and the padded query rows zeroed in
    place -- equivalent to the original's unpad/repad only for trailing
    padding, as in JAX. Returns ``(output, None)``. With a
    ``key_padding_mask`` or training dropout it runs the exact path, which
    raises on CUDA tensors.
    """

    def __init__(self, sparsity_config, softmax_temp=None,
                 attention_dropout: float = 0.0, max_seq_length: int = 2048):
        max_seq_length = -(-max_seq_length // 256) * 256
        if hasattr(sparsity_config, "make_layout"):
            layout = np.asarray(sparsity_config.make_layout(max_seq_length))
        else:
            layout = np.asarray(sparsity_config)
        if (layout.shape[0] < max_seq_length // BLOCK_ROWS
                or layout.shape[1] < max_seq_length // BLOCK_COLS):
            raise ValueError(
                f"layout {layout.shape} too small for max_seq_length={max_seq_length}"
            )
        self.layout = layout
        self.softmax_temp = softmax_temp
        self.dropout_p = float(attention_dropout)

    def __call__(self, qkv, key_padding_mask=None, causal: bool = False,
                 training: bool = False, generator: Optional[torch.Generator] = None):
        b, s = qkv.shape[0], qkv.shape[1]
        s_rounded = -(-s // 256) * 256
        bm = self.layout[: s_rounded // BLOCK_ROWS, : s_rounded // BLOCK_COLS]
        dropout_p = self.dropout_p if training else 0.0
        if key_padding_mask is None and dropout_p == 0.0:
            cu = np.arange(0, (b + 1) * s, s, dtype=np.int32)
            flat = flash_blocksparse_attn_func(
                qkv.reshape(b * s, *qkv.shape[2:]), cu, bm, max_s=s,
                softmax_scale=self.softmax_temp, causal=causal,
            )
            return flat.reshape(b, s, *flat.shape[1:]), None
        _no_kernel(qkv, {"key_padding_mask": key_padding_mask is not None,
                         "dropout": dropout_p > 0.0})
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        el = _blockmask_elementwise(bm, s, s, qkv.device)
        out = _exact_attention(
            q, k, v, el, self.softmax_temp, causal, key_valid=key_padding_mask,
            dropout_p=dropout_p, generator=generator,
        )
        if key_padding_mask is not None:
            out = out * key_padding_mask[:, :, None, None].to(out.dtype)
        return out, None


__all__ = [
    "FlashBlocksparseAttention",
    "convert_blockmask",
    "flash_blocksparse_attn_func",
]
