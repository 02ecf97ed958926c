"""Trainer on one device: AdamW with warmup-cosine, clipping, checkpoints.

Counterpart of ``liteattention_tpu/training/trainer.py`` (``TrainConfig``
and ``Trainer`` without a mesh). The optimizer arithmetic is optax's:

* the learning rate follows ``warmup_cosine_decay_schedule(0, lr, warmup,
  max(total, warmup + 1))`` evaluated at the update count *before* it is
  incremented, so the first update has lr 0;
* gradients are clipped by global norm as ``optax.clip_by_global_norm``
  does (scale ``max_norm / |g|`` when ``|g| >= max_norm``; no epsilon);
* AdamW decays every parameter (optax's default mask), with decoupled
  decay, eps 1e-8 and bias correction; ``torch.optim.AdamW`` computes the
  same update.

Checkpoints are ``torch.save`` files ``step_<n>.pt`` (model, optimizer,
step, EMA); ``restore_or_init`` resumes from the newest and only the
newest ``max_checkpoints`` are kept. Data parallelism and ZeRO sharding
(``mesh``, ``shard_opt_state``, ``shard_grads``, ``grad_comm_dtype``)
are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn as nn

from liteattention_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Flat training config (the JAX ``TrainConfig``'s fields)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    max_checkpoints: int = 3
    shard_opt_state: bool = False
    shard_grads: bool = False
    # EMA of the params (decay 0 disables); checkpointed with the state.
    ema_decay: float = 0.0
    # Per-top-level-module parameter and gradient norms in the metrics.
    norm_monitor: bool = False
    grad_comm_dtype: Optional[str] = None


def TrainState(**kwargs) -> Dict[str, Any]:
    """The train state as JAX's ``TrainState`` builds it: a plain dict of
    ``params``, ``opt_state`` and ``step`` (and ``ema_params`` with an
    EMA)."""
    return dict(**kwargs)


def warmup_cosine_lr(cfg: TrainConfig, count: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, decay)`` at
    ``count``: linear from 0, then cosine to 0 at ``decay`` steps."""
    warmup = cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1)
    if count < warmup:
        return cfg.learning_rate * count / warmup
    frac = min(count - warmup, decay - warmup) / (decay - warmup)
    return cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))


class Trainer:
    """Trainer around ``loss_fn(model, batch) -> scalar loss``.

    The model's parameters must already lie on ``device`` (default
    ``cuda``); batches (numpy int arrays) are moved there each step.
    """

    def __init__(
        self,
        model: nn.Module,
        loss_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
        config: TrainConfig,
        device=None,
        mesh=None,
    ):
        if (mesh is not None or config.shard_opt_state or config.shard_grads
                or config.grad_comm_dtype is not None):
            raise NotImplementedError(
                "Trainer: mesh, shard_opt_state, shard_grads and grad_comm_dtype "
                "(data parallelism, ZeRO) are not ported yet (ROADMAP A15b)"
            )
        self.device = resolve_device(device)
        params = dict(model.named_parameters())
        off = [n for n, p in params.items() if p.device != self.device]
        if off:
            raise ValueError(f"parameters not on {self.device}: {off[:3]}")
        self.cfg = config
        self.model = model
        self._loss_fn = loss_fn
        self._params = params
        self.opt = torch.optim.AdamW(
            params.values(), lr=0.0, betas=(config.beta1, config.beta2),
            eps=1e-8, weight_decay=config.weight_decay,
        )
        self.step = 0
        self.ema = None
        if config.ema_decay > 0.0:
            self.ema = {n: p.detach().float().clone() for n, p in params.items()}

    # -- one update -----------------------------------------------------

    def train_step(self, batch: torch.Tensor) -> Dict[str, Any]:
        """One optimizer update; returns device tensors (no host sync)."""
        self.opt.zero_grad(set_to_none=False)
        loss = self._loss_fn(self.model, batch)
        loss.backward()
        for p in self._params.values():
            if p.grad is None:  # an unused parameter: optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params.values()]
        metrics = {"loss": loss.detach(), "grad_norm": _global_norm(grads)}
        if self.cfg.norm_monitor:
            metrics["grad_norms"] = self._module_norms(lambda p: p.grad)
        clip = torch.clamp(self.cfg.grad_clip / metrics["grad_norm"], max=1.0)
        torch._foreach_mul_(grads, clip)
        for group in self.opt.param_groups:
            group["lr"] = warmup_cosine_lr(self.cfg, self.step)
        self.opt.step()
        self.step += 1
        if self.ema is not None:
            d = self.cfg.ema_decay
            with torch.no_grad():
                for n, p in self._params.items():
                    self.ema[n].mul_(d).add_(p.float(), alpha=1.0 - d)
        if self.cfg.norm_monitor:
            metrics["param_norms"] = self._module_norms(lambda p: p.detach())
        return metrics

    def _module_norms(self, get) -> Dict[str, torch.Tensor]:
        groups: Dict[str, list] = {}
        for n, p in self._params.items():
            groups.setdefault(n.split(".")[0], []).append(get(p))
        return {k: _global_norm(v) for k, v in groups.items()}

    # -- checkpoints ----------------------------------------------------

    def _checkpoints(self):
        root = Path(self.cfg.checkpoint_dir)
        found = [(int(p.stem[len("step_"):]), p) for p in root.glob("step_*.pt")]
        return sorted(found)

    def save_checkpoint(self) -> None:
        root = Path(self.cfg.checkpoint_dir)
        root.mkdir(parents=True, exist_ok=True)
        path = root / f"step_{self.step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save({
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.opt.state_dict(),
            "ema": self.ema,
        }, tmp)
        os.replace(tmp, path)  # a crash never leaves half a checkpoint
        for _, old in self._checkpoints()[: -self.cfg.max_checkpoints]:
            old.unlink()

    def maybe_checkpoint(self) -> None:
        if self.cfg.checkpoint_dir and self.step % self.cfg.checkpoint_every == 0:
            self.save_checkpoint()

    def restore_or_init(self) -> int:
        """Resume from the newest checkpoint if one exists; returns the
        step the state is at (0 for a fresh start)."""
        if self.cfg.checkpoint_dir and Path(self.cfg.checkpoint_dir).is_dir():
            found = self._checkpoints()
            if found:
                state = torch.load(found[-1][1], map_location=self.device, weights_only=True)
                self.model.load_state_dict(state["model"])
                self.opt.load_state_dict(state["optimizer"])
                self.step = int(state["step"])
                self.ema = state["ema"]
        return self.step

    # -- loop -----------------------------------------------------------

    def fit(
        self,
        batches: Iterator[np.ndarray],
        num_steps: int,
        log_every: int = 10,
        tokens_per_batch: Optional[int] = None,
        flops_per_batch: Optional[float] = None,
        peak_flops: Optional[float] = None,
        log_fn: Callable[[Dict[str, Any]], None] = lambda m: None,
    ) -> int:
        """Run ``num_steps`` updates; every ``log_every`` steps hand
        ``log_fn`` a record of loss, grad norm, steps/s and, when given,
        tokens/s, FLOP/s (``flops_per_batch``: forward + backward FLOPs of
        one batch) and MFU (only against a ``peak_flops`` the caller
        names: the port assumes no card's peak). Returns the step."""
        t0 = time.perf_counter()
        for i in range(num_steps):
            batch = torch.as_tensor(np.asarray(next(batches)), device=self.device)
            metrics = self.train_step(batch)
            self.maybe_checkpoint()
            if (i + 1) % log_every:
                continue
            rec = {
                "step": self.step,
                "loss": float(metrics["loss"]),  # waits for the device
                "grad_norm": float(metrics["grad_norm"]),
            }
            dt = time.perf_counter() - t0
            rec["steps_per_s"] = log_every / dt
            if tokens_per_batch:
                rec["tokens_per_s"] = tokens_per_batch * log_every / dt
            if flops_per_batch:
                rec["flops_per_s"] = flops_per_batch * log_every / dt
                if peak_flops:
                    rec["mfu"] = rec["flops_per_s"] / peak_flops
            for key in ("param_norms", "grad_norms"):
                if key in metrics:
                    rec[key] = {k: float(v) for k, v in metrics[key].items()}
            log_fn(rec)
            t0 = time.perf_counter()
        return self.step


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


__all__ = ["TrainConfig", "Trainer", "TrainState", "warmup_cosine_lr"]
