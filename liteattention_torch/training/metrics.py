"""Running training / evaluation metrics.

Counterpart of ``liteattention_tpu/training/metrics.py`` on tensors, with
the same update / compute / reset protocol and host-side accumulators:

- :class:`Perplexity`: ``exp`` of the token-weighted average nll (not the
  average of ``exp(nll)``), from the loss a step already computed or from
  logits and targets;
- :class:`Accuracy` and :func:`token_accuracy`: top-1 accuracy over the
  positions whose target is not ``ignore_index``; soft targets (a trailing
  class dim) are argmaxed first;
- :class:`NumTokens`: a token counter whose count survives ``reset()``
  (``hard_reset()`` zeroes it).

Each update reads its per-batch sums back from the device once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["Perplexity", "Accuracy", "NumTokens", "token_accuracy"]

IGNORE_INDEX = -100


def _count_valid(target: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return (target != ignore_index).sum()


def token_accuracy(logits: torch.Tensor, target: torch.Tensor,
                   ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Top-1 token accuracy over the non-ignored positions (a 0-d fp32
    tensor)."""
    if target.dim() == logits.dim():  # soft / one-hot targets
        target = target.argmax(-1)
    pred = logits.argmax(-1)
    valid = target != ignore_index
    hits = ((pred == target) & valid).sum()
    return hits.float() / valid.sum().clamp_min(1).float()


class Perplexity:
    """``exp(sum(nll * count) / sum(count))`` over the updates.

    ``update(loss=..., target=...)`` takes the mean loss a step computed
    (counted over ``target``'s valid positions, or as one token without
    ``target``); ``update(logits, target)`` computes the nll here."""

    def __init__(self, ignore_index: int = IGNORE_INDEX):
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.total_log_probs = 0.0
        self.count = 0

    def update(self, logits: Optional[torch.Tensor] = None,
               target: Optional[torch.Tensor] = None,
               loss: Optional[torch.Tensor] = None) -> None:
        if loss is None:
            if logits is None or target is None:
                raise ValueError("pass either loss= or (logits, target)")
            logp = torch.log_softmax(logits.float(), dim=-1)
            tgt = torch.where(target == self.ignore_index, 0, target)
            nll = -logp.gather(-1, tgt[..., None].long())[..., 0]
            valid = (target != self.ignore_index).float()
            count = valid.sum()
            loss = (nll * valid).sum() / count.clamp_min(1.0)
        elif target is not None:
            count = _count_valid(target, self.ignore_index)
        else:
            count = 1
        self.total_log_probs += float(loss) * int(count)
        self.count += int(count)

    def compute(self) -> float:
        if self.count == 0:
            return float("nan")
        return math.exp(self.total_log_probs / self.count)


class Accuracy:
    """Running top-1 accuracy."""

    def __init__(self, ignore_index: int = IGNORE_INDEX):
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.hits = 0
        self.total = 0

    def update(self, logits: torch.Tensor, target: torch.Tensor) -> None:
        if target.dim() == logits.dim():
            target = target.argmax(-1)
        pred = logits.argmax(-1)
        valid = target != self.ignore_index
        self.hits += int(((pred == target) & valid).sum())
        self.total += int(valid.sum())

    def compute(self) -> float:
        return self.hits / self.total if self.total else float("nan")


class NumTokens:
    """Monotone token counter. ``reset()`` does not zero the count (it
    persists across epochs); ``hard_reset()`` does."""

    def __init__(self, ignore_index: int = IGNORE_INDEX):
        self.ignore_index = ignore_index
        self.count = 0

    def update(self, target: torch.Tensor) -> None:
        self.count += int(_count_valid(target, self.ignore_index))

    def compute(self) -> int:
        return self.count

    def reset(self) -> None:  # persists, by design
        pass

    def hard_reset(self) -> None:
        self.count = 0

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
