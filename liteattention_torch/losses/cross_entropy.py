"""Cross-entropy loss, with a vocab-split tensor-parallel form
(counterpart of ``liteattention_tpu/losses/cross_entropy.py``).

Label smoothing, z-loss (``lse_square_scale * lse**2``), ``ignore_index``
and the three reductions, in fp32. :func:`parallel_cross_entropy_loss`
takes each rank's vocab slice of the logits and sends a few numbers a
token over the group, never the logits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from liteattention_torch.parallel._collectives import all_reduce


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


def parallel_cross_entropy_loss(
    logits_local: torch.Tensor,
    labels: torch.Tensor,
    group,
    label_smoothing: float = 0.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """CE over logits split on the vocab over ``group`` (JAX
    ``parallel_cross_entropy_loss``): rank ``r`` holds ``logits_local``
    ``[..., V / n]``, the vocab rows ``[r V / n, (r + 1) V / n)``, and every
    rank the whole ``labels`` ``[...]``. A max over the group, then the sum
    of exponentials and the true logit (and, with smoothing, the sum of
    the logits) each summed over it. Every rank returns the whole loss.

    The max carries no gradient: it cancels in ``lse``. So the loss is
    differentiable (JAX's is not: ``pmax`` has no differentiation rule),
    and a rank's gradient of its logits is its slice of the dense loss's
    gradient."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    vl = logits_local.shape[-1]
    n = dist.get_world_size(group)
    lf = logits_local.float()
    with torch.no_grad():
        m = lf.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    sumexp = all_reduce(torch.exp(lf - m[..., None]).sum(-1), group)
    lse = m + torch.log(sumexp)
    local = labels.long() - dist.get_rank(group) * vl
    in_shard = (local >= 0) & (local < vl)
    picked = lf.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    true_logit = all_reduce(torch.where(in_shard, picked, 0.0), group)
    loss = lse - true_logit
    if label_smoothing > 0.0:
        mean_logit = all_reduce(lf.sum(-1), group) / (vl * n)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (lse - mean_logit)
    if lse_square_scale > 0.0:
        loss = loss + lse_square_scale * lse * lse
    mask = labels != ignore_index
    loss = torch.where(mask, loss, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / mask.sum().clamp_min(1)


__all__ = ["cross_entropy_loss", "parallel_cross_entropy_loss"]
