"""Pad and unpad variable-length batches: padded ``[B, S, ...]`` batches
to packed ``[total_tokens, ...]`` rows with ``cu_seqlens``, the inputs of
:func:`~liteattention_torch.flash_attn_interface.flash_attn_varlen_func`,
and back.

Counterpart of ``liteattention_tpu/utils/padding.py`` (the reference's
``bert_padding.py``), with its signatures and its static capacity:
:func:`unpad_input` packs into ``max_tokens`` rows (default ``B * S``) and
zeroes the rows past the valid total, which the varlen ids then put in one
more segment of their own, the phantom segment ``B``; passing ``max_tokens
= total`` leaves none. Everything stays on the device with no host sync,
but :func:`unpad_input_for_concatenated_sequences` reads the number of
sub-samples to check it against ``max_seqs``. Gathers and scatters are
differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def index_first_axis(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``indices`` of ``x``."""
    return x.index_select(0, indices.to(x.device, torch.int64))


def unpad_input(
    hidden_states: torch.Tensor,
    attention_mask: torch.Tensor,
    max_tokens: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the valid tokens of ``hidden_states`` ``[B, S, ...]`` (where
    ``attention_mask`` ``[B, S]`` is nonzero), in order, into ``[max_tokens,
    ...]`` rows, zero past the valid total. Returns (packed, indices
    ``[max_tokens]`` int32 into the flattened batch, cu_seqlens ``[B + 1]``
    int32, total tokens as a 0-d int32 tensor)."""
    b, s = attention_mask.shape
    if max_tokens is None:
        max_tokens = b * s
    mask = attention_mask.bool().reshape(-1)
    seqlens = attention_mask.to(torch.int32).sum(-1)
    cu_seqlens = torch.nn.functional.pad(torch.cumsum(seqlens, 0, dtype=torch.int32), (1, 0))
    total = cu_seqlens[-1]
    # Valid positions first, in order.
    indices = torch.argsort((~mask).to(torch.int8), stable=True)[:max_tokens].to(torch.int32)
    flat = hidden_states.reshape(b * s, *hidden_states.shape[2:])
    packed = index_first_axis(flat, indices)
    valid = torch.arange(indices.numel(), device=packed.device) < total
    packed = torch.where(valid.reshape(-1, *([1] * (packed.dim() - 1))), packed, 0)
    return packed, indices, cu_seqlens, total


def pad_input(packed: torch.Tensor, indices: torch.Tensor, batch: int,
              seqlen: int) -> torch.Tensor:
    """Inverse of :func:`unpad_input`: ``[batch, seqlen, ...]`` with the
    packed rows at ``indices`` and zeros elsewhere."""
    flat = packed.new_zeros((batch * seqlen, *packed.shape[1:]))
    flat = flat.index_copy(0, indices.to(packed.device, torch.int64), packed)
    return flat.reshape(batch, seqlen, *packed.shape[1:])


def unpad_input_for_concatenated_sequences(
    hidden_states: torch.Tensor,
    attention_mask_in_length: torch.Tensor,
    max_tokens: Optional[int] = None,
    max_seqs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unpad rows of concatenated short samples (packed fine-tuning rows).

    ``attention_mask_in_length[b, i]`` is the length of the i-th sample in
    row ``b`` (0: none); a row is valid for its first ``sum_i length_i``
    positions. Returns (packed, indices, cu_seqlens ``[max_seqs + 1]``
    delimiting every sample, the longest sample as a 0-d tensor); entries
    past the real sample count repeat the total (empty segments). Unlike
    the JAX function, which drops the samples past ``max_seqs`` without a
    word, more samples than ``max_seqs`` raise ``ValueError``.
    """
    b, s = attention_mask_in_length.shape
    lengths = attention_mask_in_length.to(torch.int32)
    row_total = lengths.sum(-1)
    mask2d = torch.arange(s, device=lengths.device)[None, :] < row_total[:, None]
    packed, indices, _, _ = unpad_input(hidden_states, mask2d, max_tokens)
    if max_seqs is None:
        max_seqs = b * s
    flat_len = lengths.reshape(-1)
    is_seq = flat_len > 0
    nseqs = int(is_seq.sum())
    if nseqs > max_seqs:
        raise ValueError(f"unpad_input_for_concatenated_sequences: {nseqs} samples exceed "
                         f"max_seqs {max_seqs}")
    order = torch.argsort((~is_seq).to(torch.int8), stable=True)
    seqlens = flat_len[order[:max_seqs]]
    seqlens = torch.where(torch.arange(seqlens.numel(), device=seqlens.device) < nseqs,
                          seqlens, 0)
    seqlens = torch.nn.functional.pad(seqlens, (0, max_seqs - seqlens.numel()))
    cu_seqlens = torch.nn.functional.pad(torch.cumsum(seqlens, 0, dtype=torch.int32), (1, 0))
    return packed, indices, cu_seqlens, seqlens.max()


__all__ = [
    "pad_input",
    "unpad_input",
    "unpad_input_for_concatenated_sequences",
    "index_first_axis",
]
