"""Trainer: AdamW with warmup-cosine, clipping, checkpoints, on one device
or data-parallel over a ``torch.distributed`` mesh dim with ZeRO-1/2.

Counterpart of ``liteattention_tpu/training/trainer.py``. The optimizer
arithmetic is optax's:

* the learning rate follows ``warmup_cosine_decay_schedule(0, lr, warmup,
  max(total, warmup + 1))`` evaluated at the update count *before* it is
  incremented, so the first update has lr 0;
* gradients are clipped by global norm as ``optax.clip_by_global_norm``
  does (scale ``max_norm / |g|`` when ``|g| >= max_norm``; no epsilon);
* AdamW decays every parameter (optax's default mask), with decoupled
  decay, eps 1e-8 and bias correction; ``torch.optim.AdamW`` computes the
  same update.

With ``mesh`` (a ``DeviceMesh``) and its dim ``dp_dim`` of ``n`` ranks,
each rank takes its ``1 / n`` slice of the global batch's leading axis
(JAX's ``P(dp_axis)``), the loss is averaged over the ranks and so are
the gradients, before the global norm, the clip and AdamW; every rank then
computes the same update. MoE layers route each rank's tokens as one
device routes the global batch (``modules/moe.py:data_parallel_routing``),
so the step is the one-device step, as JAX's one ``jit`` over the batch is. The config's mesh options, which without a mesh
change nothing (as in JAX):

* ``grad_comm_dtype``: JAX's fp16-compress order, each gradient divided by
  ``n``, cast, all-reduced in that dtype and cast back;
* ``shard_opt_state`` (ZeRO-1): each AdamW state tensor is split over the
  ranks on its first dim that divides by ``n`` and is at least ``n`` (JAX's
  ``leaf_sharding`` rule; a tensor with no such dim stays whole). A rank
  updates its slice of each such parameter, and the parameters are
  all-gathered after the update;
* ``shard_grads`` (ZeRO-2): implies ZeRO-1; the gradients of split tensors
  are reduce-scattered instead of all-reduced, unless ``grad_comm_dtype``
  asks for the compressed all-reduce, as in JAX.

The global norm and the clip read the whole gradient: the slices' squared
norms summed over the ranks, each whole tensor counted once.

Checkpoints are ``torch.save`` files ``step_<n>.pt`` (model, optimizer,
step, EMA); ``restore_or_init`` resumes from the newest and only the
newest ``max_checkpoints`` are kept. Under a mesh rank 0 writes the whole
state (the optimizer's slices gathered) in the one-rank format, and
``restore_or_init`` slices it again.
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
import torch.distributed as dist
import torch.nn as nn

from liteattention_torch.device import resolve_device
from liteattention_torch.modules.moe import data_parallel_routing
from liteattention_torch.parallel._collectives import all_gather_dim, reduce_scatter_dim, shard_dim


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
    ``cuda``); batches (numpy int arrays) are moved there each step. With
    ``mesh``, every rank of its dim ``dp_dim`` builds the same model and
    calls with the same global batches (see the module's note).
    """

    def __init__(
        self,
        model: nn.Module,
        loss_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
        config: TrainConfig,
        device=None,
        mesh=None,
        dp_dim: str = "dp",
    ):
        self.device = resolve_device(device)
        params = dict(model.named_parameters())
        off = [n for n, p in params.items() if p.device != self.device]
        if off:
            raise ValueError(f"parameters not on {self.device}: {off[:3]}")
        self.cfg = config
        self.model = model
        self._loss_fn = loss_fn
        self._params = params
        self.comm_dtype = None
        if config.grad_comm_dtype is not None:
            dtype = getattr(torch, str(config.grad_comm_dtype), None)
            if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
                raise ValueError(f"grad_comm_dtype {config.grad_comm_dtype!r} names no float "
                                 "dtype")
            self.comm_dtype = dtype
        self.group = None if mesh is None else mesh.get_group(dp_dim)
        self.world = 1 if self.group is None else dist.get_world_size(self.group)
        self.rank = 0 if self.group is None else dist.get_rank(self.group)
        # ZeRO: the dim each parameter's optimizer state is split on (None:
        # whole), and the tensors AdamW updates (a slice or the parameter).
        self.shard_dims: Dict[str, Optional[int]] = {}
        opt_params = params
        if self.group is not None and (config.shard_opt_state or config.shard_grads):
            self.shard_dims = {n: _shard_dim(p.shape, self.world) for n, p in params.items()}
            opt_params = {n: p if self.shard_dims[n] is None else
                          shard_dim(p.detach(), self.shard_dims[n], self.group).clone()
                          for n, p in params.items()}
        self._opt_params = opt_params
        self.opt = torch.optim.AdamW(
            opt_params.values(), lr=0.0, betas=(config.beta1, config.beta2),
            eps=1e-8, weight_decay=config.weight_decay,
        )
        self.step = 0
        self.ema = None
        if config.ema_decay > 0.0:
            self.ema = {n: p.detach().float().clone() for n, p in params.items()}

    # -- one update -----------------------------------------------------

    def train_step(self, batch: torch.Tensor) -> Dict[str, Any]:
        """One optimizer update on the global ``batch`` (under a mesh, this
        rank's slice of it); returns device tensors (no host sync)."""
        if self.group is not None:
            b = batch.shape[0]
            if b % self.world:
                raise ValueError(f"a batch of {b} does not split over {self.world} "
                                 "data-parallel ranks")
            batch = batch[self.rank * b // self.world:(self.rank + 1) * b // self.world]
        self.model.zero_grad(set_to_none=False)
        with data_parallel_routing(self.model, self.group):
            loss = self._loss_fn(self.model, batch)
            loss.backward()
        for p in self._params.values():
            if p.grad is None:  # an unused parameter: optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if self.group is None:
            grads = {n: p.grad for n, p in self._params.items()}
        else:
            loss = _flat_all_reduce([loss], self.group)[0] / self.world
            grads = self._reduce_grads()
        metrics = {"loss": loss, "grad_norm": self._norms({"": list(grads)}, grads)[""]}
        if self.cfg.norm_monitor:
            metrics["grad_norms"] = self._norms(self._by_module(), grads)
        clip = torch.clamp(self.cfg.grad_clip / metrics["grad_norm"], max=1.0)
        torch._foreach_mul_(list(grads.values()), clip)
        for n, g in grads.items():
            self._opt_params[n].grad = g
        for group in self.opt.param_groups:
            group["lr"] = warmup_cosine_lr(self.cfg, self.step)
        self.opt.step()
        with torch.no_grad():
            for n, d in self.shard_dims.items():
                if d is not None:
                    self._params[n].copy_(all_gather_dim(self._opt_params[n], d, self.group))
        self.step += 1
        if self.ema is not None:
            d = self.cfg.ema_decay
            with torch.no_grad():
                for n, p in self._params.items():
                    self.ema[n].mul_(d).add_(p.float(), alpha=1.0 - d)
        if self.cfg.norm_monitor:
            whole = {n: p.detach() for n, p in self._params.items()}
            metrics["param_norms"] = {k: _global_norm([whole[n] for n in names])
                                      for k, names in self._by_module().items()}
        return metrics

    def _reduce_grads(self) -> Dict[str, torch.Tensor]:
        """The gradients averaged over the ranks: whole, or this rank's
        slice where ZeRO splits the parameter."""
        n, group = self.world, self.group
        local = {k: p.grad for k, p in self._params.items()}
        split = {k for k, d in self.shard_dims.items() if d is not None}
        # ZeRO-2 reduce-scatters the split gradients (in the same order on
        # every rank), unless the wire is compressed (an all-reduce, as in
        # JAX).
        zero2 = self.cfg.shard_grads and self.comm_dtype is None
        scattered = [k for k in local if k in split] if zero2 else []
        out = {k: reduce_scatter_dim(local[k], self.shard_dims[k], group) / n for k in scattered}
        rest = [k for k in local if k not in scattered]
        if self.comm_dtype is not None:
            # fp16_compress_hook's order: / world size, cast, reduce, cast back.
            wire = _flat_all_reduce([(local[k] / n).to(self.comm_dtype) for k in rest], group)
            out.update({k: w.to(local[k].dtype) for k, w in zip(rest, wire)})
        else:
            summed = _flat_all_reduce([local[k] for k in rest], group)
            out.update({k: s / n for k, s in zip(rest, summed)})
        return {k: shard_dim(out[k], self.shard_dims[k], group).clone()
                if k in split and k not in scattered else out[k] for k in local}

    def _by_module(self) -> Dict[str, list]:
        groups: Dict[str, list] = {}
        for n in self._params:
            groups.setdefault(n.split(".")[0], []).append(n)
        return groups

    def _norms(self, groups: Dict[str, list], grads: Dict[str, torch.Tensor]):
        """The global norm of each group of gradients (by name): where ZeRO
        split a tensor, the ranks' slices' squares summed over the group."""
        split = {k for k, d in self.shard_dims.items() if d is not None}
        if not split:
            return {key: _global_norm([grads[n] for n in names]) for key, names in groups.items()}
        keys, zero = list(groups), torch.zeros((), device=self.device)

        def squares(names):
            return sum((grads[n].float().square().sum() for n in names), zero)

        parts = torch.stack([squares([n for n in groups[k] if n in split]) for k in keys])
        parts = _flat_all_reduce([parts], self.group)[0]
        whole = torch.stack([squares([n for n in groups[k] if n not in split]) for k in keys])
        return dict(zip(keys, (parts + whole).sqrt()))

    # -- checkpoints ----------------------------------------------------

    def _checkpoints(self):
        root = Path(self.cfg.checkpoint_dir)
        found = [(int(p.stem[len("step_"):]), p) for p in root.glob("step_*.pt")]
        return sorted(found)

    def _reshard_state(self, state, cut):
        """An AdamW ``state_dict`` with each split parameter's state tensors
        passed through ``cut(tensor, dim)`` (new dicts; the optimizer's own
        are left alone)."""
        dims = [self.shard_dims[n] for n in self._params]
        return {"param_groups": state["param_groups"],
                "state": {i: {k: cut(v, dims[i]) if dims[i] is not None and v.dim() else v
                              for k, v in st.items()}
                          for i, st in state["state"].items()}}

    def save_checkpoint(self) -> None:
        """Write ``step_<n>.pt`` (under a mesh: every rank gathers, rank 0
        writes, and all wait for it)."""
        optimizer = self.opt.state_dict()
        if self.shard_dims:
            optimizer = self._reshard_state(
                optimizer, lambda v, d: all_gather_dim(v, d, self.group))
        if self.rank == 0:
            root = Path(self.cfg.checkpoint_dir)
            root.mkdir(parents=True, exist_ok=True)
            path = root / f"step_{self.step}.pt"
            tmp = path.with_suffix(".tmp")
            torch.save({
                "step": self.step,
                "model": self.model.state_dict(),
                "optimizer": optimizer,
                "ema": self.ema,
            }, tmp)
            os.replace(tmp, path)  # a crash never leaves half a checkpoint
            for _, old in self._checkpoints()[: -self.cfg.max_checkpoints]:
                old.unlink()
        if self.group is not None:
            dist.barrier(group=self.group)

    def maybe_checkpoint(self) -> None:
        if self.cfg.checkpoint_dir and self.step % self.cfg.checkpoint_every == 0:
            self.save_checkpoint()

    def restore_or_init(self) -> int:
        """Resume from the newest checkpoint if one exists; returns the
        step the state is at (0 for a fresh start). Under ZeRO each rank
        keeps its slice of the optimizer state."""
        if self.cfg.checkpoint_dir and Path(self.cfg.checkpoint_dir).is_dir():
            found = self._checkpoints()
            if found:
                state = torch.load(found[-1][1], map_location=self.device, weights_only=True)
                self.model.load_state_dict(state["model"])
                optimizer = state["optimizer"]
                if self.shard_dims:
                    optimizer = self._reshard_state(
                        optimizer, lambda v, d: shard_dim(v, d, self.group).clone())
                    with torch.no_grad():
                        for n, d in self.shard_dims.items():
                            if d is not None:
                                self._opt_params[n].copy_(
                                    shard_dim(self._params[n], d, self.group))
                self.opt.load_state_dict(optimizer)
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


def _shard_dim(shape, n: int) -> Optional[int]:
    """JAX's ``leaf_sharding`` rule: the first dim that divides by ``n``
    and is at least ``n`` (None: the tensor stays whole)."""
    for dim, size in enumerate(shape):
        if size % n == 0 and size >= n:
            return dim
    return None


def _flat_all_reduce(tensors, group):
    """The sums over ``group`` of ``tensors``, with one ``all_reduce`` a
    dtype (the tensors packed flat)."""
    out = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


__all__ = ["TrainConfig", "Trainer", "TrainState", "warmup_cosine_lr"]
