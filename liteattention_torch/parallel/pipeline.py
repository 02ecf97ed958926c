"""Pipeline parallelism: a GPipe microbatch pipeline over a
``torch.distributed`` group.

Counterpart of ``liteattention_tpu/parallel/pipeline.py``. The layer stack
is split into ``n`` stages, one a rank. The batch is split into ``m``
microbatches, which stream through the stages in ``m + n - 1`` ticks. At
tick ``t`` stage 0 takes microbatch ``t`` and every other stage the
activation its left neighbour sent at tick ``t - 1``. Each stage's output
then hops one rank on around the ring (:func:`~liteattention_torch.
parallel._collectives.ring_hop`, JAX's ``ppermute``), so after the hop of
tick ``t`` stage 0 holds finished microbatch ``t - (n - 1)`` from the last
stage. At the end an ``all_reduce`` of (stage 0's outputs, zeros
elsewhere) gives every rank the whole output batch. A stage holding no
microbatch on a tick (the fill and the drain, ``(n - 1) / (m + n - 1)``
of the ticks) skips its compute; the hop runs on every rank every tick.

The backward pass runs the same ticks in reverse: the cotangent hops back
around the ring once a tick and each stage runs its own backward through
the graph its forward kept. It is written out
(``torch.autograd.Function``) rather than left to autograd's own order,
so that every rank makes the same reverse hops in the same order. A
rank's stage parameters get exactly the sequential model's gradients for
that stage.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call
from torch.utils._pytree import tree_flatten, tree_unflatten

from liteattention_torch.parallel._collectives import (
    all_reduce,
    copy_to_group,
    ring_hop,
    scatter_dim,
)


def _stage_call(stage_fn, params_local):
    """``(leaves, run)``: the stage's parameter tensors and ``run(leaves,
    x)``, which applies the stage with those tensors in their place."""
    if isinstance(stage_fn, nn.Module):
        names = [n for n, _ in stage_fn.named_parameters()]
        leaves = [p for _, p in stage_fn.named_parameters()]

        def run(ps, x):
            return functional_call(stage_fn, dict(zip(names, ps)), (x,), strict=False)

        return leaves, run
    leaves, spec = tree_flatten(params_local)
    tensors = [i for i, p in enumerate(leaves) if isinstance(p, torch.Tensor)]

    def run(ps, x):
        full = list(leaves)
        for i, p in zip(tensors, ps):
            full[i] = p
        return stage_fn(tree_unflatten(full, spec), x)

    return [leaves[i] for i in tensors], run


def _schedule(run, params, xs, group, keep_graph):
    """The forward ticks. Returns (stage 0's finished microbatches stacked,
    zeros on other ranks; the kept (tick, input, output) graphs). A stage
    that changes its input's shape or dtype raises ``ValueError`` on every
    rank, after the ticks (a rank that raised alone would leave the others
    waiting in a hop)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m = xs.shape[0]
    buf = torch.zeros_like(xs[0])
    ys = torch.zeros_like(xs)
    bad, kept = False, []
    for t in range(m + n - 1):
        inp = (xs[t] if t < m else torch.zeros_like(xs[0])) if r == 0 else buf
        if r <= t < r + m:  # this stage holds microbatch t - r
            if keep_graph:
                inp = inp.detach().requires_grad_()
            with torch.set_grad_enabled(keep_graph):
                out = run(params, inp)
            if out.shape != inp.shape or out.dtype != inp.dtype:
                bad, out = True, torch.zeros_like(inp)
            elif keep_graph:
                kept.append((t, inp, out))
            out = out.detach()
        else:
            out = torch.zeros_like(inp)
        buf = ring_hop(out, group)
        if r == 0 and t >= n - 1:
            ys[t - (n - 1)] = buf
    flag = torch.tensor(float(bad), device=xs.device)
    dist.all_reduce(flag, group=group)
    if flag.item():
        raise ValueError("pipeline stages must keep their input's shape and dtype "
                         f"(a microbatch is {tuple(xs.shape[1:])} {xs.dtype})")
    return ys, kept


class _Pipeline(torch.autograd.Function):
    """The schedule with its reverse ticks as the backward. Inputs: the
    microbatched ``xs`` and the stage's parameter tensors."""

    @staticmethod
    def forward(ctx, run, group, xs, *params):
        # Each tick's graph runs from detached copies of the inputs, so
        # the backward can take its gradients tick by tick.
        params = [p.detach().requires_grad_(p.requires_grad) for p in params]
        ys, kept = _schedule(run, params, xs, group, keep_graph=True)
        ctx.group, ctx.kept, ctx.m, ctx.params = group, kept, xs.shape[0], params
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        group, params = ctx.group, ctx.params
        n, r, m = dist.get_world_size(group), dist.get_rank(group), ctx.m
        kept = {t: (inp, out) for t, inp, out in ctx.kept}
        g_xs = torch.zeros_like(g_ys)
        g_params: List[Optional[torch.Tensor]] = [None] * len(params)
        wanted = [i for i, p in enumerate(params) if p.requires_grad]
        g_next = None  # the cotangent of this rank's tick-t input, from tick t + 1
        for t in reversed(range(m + n - 1)):
            g_hop = torch.zeros_like(g_ys[0])
            if r == 0 and t >= n - 1:
                g_hop = g_ys[t - (n - 1)]
            elif r > 0 and g_next is not None:
                g_hop = g_next
            g_out = ring_hop(g_hop, group, shift=-1)
            g_next = None
            if t in kept:
                inp, out = kept.pop(t)
                sources = [inp] + [params[i] for i in wanted]
                grads = torch.autograd.grad(out, sources, g_out, allow_unused=True)
                g_next = grads[0]
                for i, gp in zip(wanted, grads[1:]):
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None else g_params[i] + gp
                if r == 0 and g_next is not None:
                    g_xs[t] = g_next
        return (None, None, g_xs, *g_params)


def pipeline_apply_local(
    stage_fn: Callable,
    params_local,
    x: torch.Tensor,
    group,
    num_microbatches: int,
) -> torch.Tensor:
    """This rank's part of the pipeline (JAX's ``shard_map`` body): rank
    ``r`` of ``group`` runs stage ``r``, ``stage_fn(params_local, x)``, or,
    when ``stage_fn`` is an ``nn.Module`` (a stack of blocks),
    ``stage_fn(x)`` with ``params_local`` unused. Every rank passes the
    whole batch ``x``, split into ``num_microbatches`` along dim 0; stage 0
    reads it (its gradient lands on rank 0). Returns the whole output
    batch on every rank. A stage must keep its input's shape and dtype
    (``ValueError`` on every rank otherwise)."""
    m = num_microbatches
    b = x.shape[0]
    if m < 1 or b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    xs = x.reshape(m, b // m, *x.shape[1:])
    params, run = _stage_call(stage_fn, params_local)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        ys = _Pipeline.apply(run, group, xs, *params)
    else:
        ys, _ = _schedule(run, params, xs, group, keep_graph=False)
    return all_reduce(ys, group).reshape(b, *ys.shape[2:])


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh,
    dim: str = "pp",
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """The pipeline over the dim ``dim`` of ``mesh`` (JAX ``pipeline_apply``):
    ``stage_params``' tensors are stacked on a leading axis of one stage a
    rank (``ValueError`` unless its length is the dim's size), and rank
    ``r`` runs ``stage_fn(stage r's params, x)``. ``x``, the whole batch,
    and the result are whole on every rank: ``stage_{n-1}(... stage_0(x))``
    by microbatches (``num_microbatches`` defaults to ``n``). The gradients
    with respect to ``x`` and to the stacked parameters are whole on every
    rank."""
    group = mesh.get_group(dim)
    n = dist.get_world_size(group)
    leaves, spec = tree_flatten(stage_params)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.shape[0] != n:
            raise ValueError(f"a stage_params tensor has {leaf.shape[0]} stages but the "
                             f"{dim!r} dim has {n} ranks")
    local = [scatter_dim(p, 0, group)[0] if isinstance(p, torch.Tensor) else p for p in leaves]
    return pipeline_apply_local(stage_fn, tree_unflatten(local, spec), copy_to_group(x, group),
                                group, n if num_microbatches is None else num_microbatches)


__all__ = ["pipeline_apply", "pipeline_apply_local"]
