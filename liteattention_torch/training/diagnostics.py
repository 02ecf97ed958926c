"""Model diagnostics: the causality monitor and parameter counts.

Counterpart of ``liteattention_tpu/training/diagnostics.py`` through
``torch.autograd``:

- :func:`causality_leakage` / :func:`check_causal`: the gradient that
  leaks from future positions into earlier outputs of a ``[B, L, D] ->
  [B, L, *]`` function (0 for a causal model);
- :func:`param_stats`: total, trainable and per-top-level-module parameter
  counts.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch
import torch.nn as nn

__all__ = ["causality_leakage", "check_causal", "param_stats"]


def causality_leakage(fn: Callable[[torch.Tensor], torch.Tensor], seq_len: int = 10,
                      input_dim: int = 16, batch: int = 2,
                      rng: Optional[torch.Generator] = None,
                      x: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Per-position future-gradient leakage of ``fn``: a ``[seq_len]``
    tensor whose entry k is ``mean_{s > k} |d mean(y[0, k]) / d x[0, s, :]|``
    (the last entry is 0: no future). The probe input is ``x`` or, without
    it, ``N(0, 1)`` of shape ``[batch, seq_len, input_dim]`` drawn from
    ``rng`` (default: seed 0) on ``device`` (default: the CPU). Probe a
    model's trunk on float inputs (token ids carry no gradient)."""
    if x is None:
        rng = rng or torch.Generator(device=device or "cpu").manual_seed(0)
        x = torch.randn(batch, seq_len, input_dim, generator=rng, device=device or "cpu")
    x = x.detach().float().requires_grad_(True)
    y = fn(x)
    leaks = []
    for k in range(x.shape[1]):
        (g,) = torch.autograd.grad(y[0, k].float().mean(), x, retain_graph=True)
        future = g[0, k + 1 :, :]
        leaks.append(future.abs().mean() if future.numel() else g.new_zeros(()))
    return torch.stack(leaks)


def check_causal(fn: Callable[[torch.Tensor], torch.Tensor], seq_len: int = 10,
                 input_dim: int = 16, tol: float = 1e-6, **kwargs) -> bool:
    """True iff ``fn`` leaks no gradient from the future (largest leak
    below ``tol``); ``kwargs`` go to :func:`causality_leakage`."""
    return bool(causality_leakage(fn, seq_len, input_dim, **kwargs).max() < tol)


def param_stats(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                trainable_mask: Optional[Mapping[str, bool]] = None) -> Dict[str, float]:
    """Parameter counts: ``model/params_total``, ``model/params_trainable``,
    ``model/params_not_trainable`` and ``model/params/<module>`` for each
    top-level module (the first part of a dotted name). ``params``: a
    module (trainable = ``requires_grad`` unless ``trainable_mask`` says)
    or a mapping of dotted names to tensors (all trainable unless
    ``trainable_mask`` says)."""
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        if trainable_mask is None:
            trainable_mask = {n: p.requires_grad for n, p in named.items()}
    else:
        named = dict(params)
    total = sum(int(p.numel()) for p in named.values())
    out: Dict[str, float] = {"model/params_total": total}
    if trainable_mask is not None:
        trainable = sum(int(p.numel()) for n, p in named.items() if trainable_mask.get(n, False))
        out["model/params_trainable"] = trainable
        out["model/params_not_trainable"] = total - trainable
    else:
        out["model/params_trainable"] = total
        out["model/params_not_trainable"] = 0
    per_module: Dict[str, int] = {}
    for n, p in named.items():
        key = n.split(".")[0] or "root"
        per_module[key] = per_module.get(key, 0) + int(p.numel())
    for k, v in sorted(per_module.items()):
        out[f"model/params/{k}"] = v
    return out
