"""The collectives the parallel modules share, along a tensor dim, with
gradients.

Each runs on the tensor's own device over ``group``; the group's backend
carries it. ``all_gather_single`` / ``reduce_scatter_single`` are the
newer names of ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
(the older ones warn on newer PyTorch); either is taken.

The gradients follow Megatron's conventions, in conjugate pairs:

* :func:`all_reduce` sums, and passes the cotangent through unchanged;
  :func:`copy_to_group` passes the tensor through unchanged, and sums the
  cotangent (a tensor every rank holds whole, used by each rank for its
  part of the work);
* :func:`all_gather_dim` and :func:`reduce_scatter_dim`, each the other's
  backward (the gathered tensor feeds each rank's partial products);
* :func:`gather_dim` and :func:`scatter_dim`, each the other's backward
  (a whole tensor that every rank holds alike, and its rank slices);
* :func:`all_to_all`, whose backward is itself with the dims swapped;
* :func:`ring_hop`, JAX's ``ppermute`` by ``perm = [(i, (i + shift) %
  n)]``, whose backward is the reverse hop. It is one
  ``all_to_all_single`` whose split sizes send the whole tensor to one
  rank and nothing to the rest, since gloo aborts a rank on CUDA
  point-to-point calls (``send`` / ``recv`` / ``batch_isend_irecv``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _sum(x, group):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def _gather(x, dim, group):
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, dim, group):
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"{xs.shape[0]} positions do not split into {n} shards")
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def shard_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``dim`` (a view, no gradient rule of its own),
    the dim split in ``group``'s size equal parts in rank order."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} positions do not split into {n} shards")
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


def _to_all(x, split_dim, concat_dim, group):
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"{x.shape[split_dim]} positions do not split into {n} shards")
    xs = x.movedim(split_dim, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:]).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return torch.cat([c.movedim(0, split_dim) for c in out.unbind(0)], dim=concat_dim)


def _hop(x, shift, group):
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r, size = dist.get_rank(group), x.numel()
    send_sizes, recv_sizes = [0] * n, [0] * n
    send_sizes[(r + shift) % n] = recv_sizes[(r - shift) % n] = size
    recv = torch.empty(size, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(recv, x.reshape(-1).contiguous(), recv_sizes, send_sizes, group=group)
    return recv.view(x.shape)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return shard_dim(g, ctx.dim, ctx.group).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return shard_dim(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _to_all(g, concat_dim, split_dim, ctx.group), None, None, None


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _hop(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, -ctx.shift, ctx.group), None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, in a new tensor; the
    gradient passes through unchanged."""
    return _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` (each rank's
    use of a tensor they all hold adds its part)."""
    return _CopyToGroup.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order; the
    gradient is reduce-scattered back along ``dim``."""
    return _AllGather.apply(x, dim, group)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group``, keeping this rank's slice of ``dim``; the
    gradient is all-gathered."""
    return _ReduceScatter.apply(x, dim, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` into a whole that each
    rank holds alike; the gradient of that whole is sliced back to the
    rank's part."""
    return _Gather.apply(x, dim, group)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``dim`` of a tensor every rank holds alike (a
    copy); the gradient is all-gathered, so it is whole on every rank."""
    return _Scatter.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split in ``n`` chunks along
    ``split_dim``, chunk ``j`` sent to rank ``j``, the chunks received
    concatenated along ``concat_dim`` in rank order. The gradient is the
    inverse exchange (the dims swapped)."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def ring_hop(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``r``'s ``x`` moves to rank ``(r + shift) % n``: each rank
    returns the tensor of rank ``(r - shift) % n`` (same shape and dtype on
    every rank). The gradient hops back."""
    return _RingHop.apply(x, shift, group)
