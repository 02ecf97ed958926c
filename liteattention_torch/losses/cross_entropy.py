"""Cross-entropy loss (counterpart of
``liteattention_tpu/losses/cross_entropy.py:cross_entropy_loss``).

Label smoothing, z-loss (``lse_square_scale * lse**2``), ``ignore_index``
and the three reductions, in fp32. The vocab-parallel form waits for the
port's tensor parallelism.
"""

from __future__ import annotations

import torch


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """CE over ``[..., V]`` logits and integer labels ``[...]``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    lf = logits.float()
    if logit_scale != 1.0:
        lf = lf * logit_scale
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    loss = lse - true_logit
    if label_smoothing > 0.0:
        smooth = lse - lf.mean(dim=-1)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    if lse_square_scale > 0.0:
        loss = loss + lse_square_scale * lse * lse
    mask = labels != ignore_index
    loss = torch.where(mask, loss, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / mask.sum().clamp_min(1)


__all__ = ["cross_entropy_loss"]
