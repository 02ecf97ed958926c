"""LSE-weighted combination of partial attention outputs.

Counterpart of ``liteattention_tpu/ops/combine.py:combine_attention``:
partial (out, lse) pairs computed over disjoint KV splits merge into
the attention over their union. Plain PyTorch; it is also the plain
version of the split merges of the decode kernels (the last piece's merge
inside ``csrc/flash_decode.cu`` and inside ``csrc/mla_decode.cu``).
"""

from __future__ import annotations

from typing import Tuple

import torch


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


__all__ = ["combine_attention"]
