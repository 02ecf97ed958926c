"""The few collectives the parallel modules share, along a tensor dim.

Each runs on the tensor's own device over ``group``; the group's backend
carries it. ``all_gather_single`` / ``reduce_scatter_single`` are the
newer names of ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
(the older ones warn on newer PyTorch); either is taken.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) over ``group`` of every rank's ``x``, in a new
    tensor."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group``, keeping this rank's slice of ``dim``."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"{xs.shape[0]} positions do not split into {n} shards")
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def shard_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``dim`` (a view), the dim split in
    ``group``'s size equal parts in rank order."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} positions do not split into {n} shards")
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)
