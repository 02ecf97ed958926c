"""LSE-weighted combination of partial attention outputs.

Counterpart of ``liteattention_tpu/ops/combine.py:combine_attention``:
partial (out, lse) pairs computed over disjoint KV splits merge into
the attention over their union. Plain PyTorch; it is also the plain
version of the split merges of the decode kernels (the last piece's merge
inside ``csrc/flash_decode.cu`` and inside ``csrc/mla_decode.cu``).

:func:`combine_attention_psum` is the cross-rank form
(``combine_attention_psum`` of the JAX module, which merges over a mesh
axis with ``pmax`` / ``psum``): one ``all_reduce(MAX)`` of the lse and one
``all_reduce(SUM)`` of the weighted outputs and weights packed together,
over a ``torch.distributed`` process group, on whatever device the
tensors are (the group's backend carries them).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def combine_attention(
    partial_out: torch.Tensor,
    partial_lse: torch.Tensor,
    axis: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge partial attentions stacked on ``axis``.

    ``partial_out`` ``[..., N, ..., S, D]`` (each normalized by its own
    softmax sum), ``partial_lse`` the matching natural-log LSEs (the same
    shape without D). Returns (out in ``partial_out``'s dtype, lse fp32)
    with the split axis reduced. A row whose every split is empty (lse
    -inf throughout) gives out 0 and lse -inf, not NaN.
    """
    lse32 = partial_lse.float()
    m = lse32.amax(dim=axis, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse32 - m_safe)
    w_sum = w.sum(dim=axis, keepdim=True)
    denom = w_sum.clamp_min(torch.finfo(torch.float32).tiny)
    out = (partial_out.float() * w.unsqueeze(-1)).sum(dim=axis) / denom.unsqueeze(-1).squeeze(axis)
    lse = torch.where(w_sum == 0.0, -torch.inf, m_safe + torch.log(denom)).squeeze(axis)
    return out.to(partial_out.dtype), lse


def combine_attention_psum(
    out_local: torch.Tensor,
    lse_local: torch.Tensor,
    group: dist.ProcessGroup,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge each rank's partial attention over ``group``.

    ``out_local`` ``[..., S, D]`` and ``lse_local`` ``[..., S]`` are this
    rank's partial over its own KV split; every rank of ``group`` calls
    with the same shapes and gets the same (out in ``out_local``'s dtype,
    lse fp32). Rows that no rank saw (lse -inf everywhere) give out 0 and
    lse -inf, as :func:`combine_attention`.
    """
    lse32 = lse_local.float()
    m = lse32.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse32 - m_safe)
    # [weighted out | weight] in one buffer: one SUM all-reduce for both.
    packed = torch.cat([out_local.float() * w.unsqueeze(-1), w.unsqueeze(-1)], dim=-1)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    w_sum = packed[..., -1]
    denom = w_sum.clamp_min(torch.finfo(torch.float32).tiny)
    out = packed[..., :-1] / denom.unsqueeze(-1)
    lse = torch.where(w_sum == 0.0, -torch.inf, m_safe + torch.log(denom))
    return out.to(out_local.dtype), lse


__all__ = ["combine_attention", "combine_attention_psum"]
