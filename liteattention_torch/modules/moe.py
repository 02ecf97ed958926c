"""Mixture-of-Experts FFN with top-k routing into a fixed capacity.

Counterpart of ``liteattention_tpu/modules/moe.py`` (GShard / Switch
routing): each token picks its ``top_k`` experts by router probability,
takes a position in each expert's buffer of ``capacity`` slots in
slot-major order (every first choice before any second choice), and a
token whose position falls past the capacity passes that slot with zero
expert output. The expert FFN is ``gelu_tanh(x @ wi) @ wo`` with no
biases, the output the gate-weighted sum over the kept slots, and the
Switch load-balance loss ``E * sum_e f_e * p_e`` comes back beside it.

Where JAX dispatches and combines by one-hot einsums over ``[T, E, C]``
(the MXU's form), the port gathers the kept tokens into ``[E, C, D]`` by
index and scatters the experts' outputs back: the same function (each
(expert, slot) holds at most one token, so the einsums add exact zeros),
without the one-hot products, which at GPT-2 small's width with 4 experts
over 8192 tokens would cost more than the experts. :func:`_route` keeps
JAX's dense ``dispatch`` / ``combine`` / ``aux`` for the tests.

Precision as in JAX: the router product runs in true fp32 (no TF32; JAX
asks for ``Precision.HIGHEST``), the top-k is stable (ties go to the lower
expert index, as ``jax.lax.top_k``), the dispatched tokens are fp32 and
the experts run in the weights' dtype. On the card a bf16 product comes
back bf16, where JAX keeps it fp32 (``preferred_element_type``); the GELU
and the combine run in fp32 either way.

Expert parallelism (``moe_forward_expert_parallel``, ``moe_apply_sharded``)
is JAX's GShard schedule on a ``torch.distributed`` group: each rank routes
its own tokens into ``[E, C, D]``, one ``all_to_all`` sends each expert's
slots to the rank that holds it (``[E / n, n C, D]``), the rank's ``E /
n`` experts run, and a second ``all_to_all`` brings the outputs home for
the combine. Both exchanges are differentiable.

Data parallelism routes as one device routes the global batch (JAX's
data-parallel step is one ``jit`` over it): inside
:func:`data_parallel_routing`, each rank's tokens are its slice of the
global batch in rank order, and :class:`MoEMlp` takes the capacity from
the global token count, each (token, slot)'s position in the global
slot-major order (one ``all_reduce`` of the ranks' per-slot expert
counts), and the load-balance loss's routed fractions over the global
batch, so that the ranks' aux losses average to the global one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from liteattention_torch.device import resolve_device
from liteattention_torch.ops.activations import gelu_approx
from liteattention_torch.parallel._collectives import (
    all_reduce,
    all_to_all,
    copy_to_group,
    gather_dim,
    scatter_dim,
)


@contextlib.contextmanager
def _true_fp32():
    """fp32 matmuls without TF32 inside the block (JAX's HIGHEST)."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def init_moe_params(generator: torch.Generator, dim: int, hidden: int, num_experts: int,
                    dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Random parameters as JAX draws their scales: router ``[D, E]``
    (fp32), ``wi`` ``[E, D, F]`` and ``wo`` ``[E, F, D]`` (``dtype``),
    ``N(0, 1)`` over the square root of each product's fan-in, from
    ``generator`` (on ``device``)."""
    device = resolve_device(device)

    def normal(*shape, fan_in):
        return torch.randn(*shape, generator=generator, device=device) / math.sqrt(fan_in)

    return {"router": normal(dim, num_experts, fan_in=dim),
            "wi": normal(num_experts, dim, hidden, fan_in=dim).to(dtype),
            "wo": normal(num_experts, hidden, dim, fan_in=hidden).to(dtype)}


def capacity_for(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: ``max(1, int(capacity_factor * top_k * T / E))``."""
    return max(1, int(capacity_factor * top_k * tokens / num_experts))


def _route_indices(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int,
                   group=None):
    """Routing of ``x`` ``[T, D]``: (probs ``[T, E]`` fp32, experts ``[T, k]``,
    gates ``[T, k]`` fp32 normalised over the k choices, positions ``[T, k]``
    within each expert's buffer in slot-major order, keep ``[T, k]``
    (position < capacity), aux loss). With ``group``, ``x`` is this rank's
    slice of the batch: keep and the aux loss's routed fractions are the
    whole batch's, the positions this rank's own (each at most the global
    one, so a kept token's is below the capacity and below ``T``)."""
    t = x.shape[0]
    e = router.shape[1]
    with _true_fp32():
        logits = x.float() @ router.float()
    # JAX's softmax, spelled out: exp(l - max) / sum (torch.softmax
    # multiplies by the sum's reciprocal, an ulp away).
    unnorm = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = unnorm / unnorm.sum(-1, keepdim=True)
    # A stable descending sort: equal probabilities keep the lower expert
    # first, as jax.lax.top_k does (torch.topk promises no order).
    vals, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :top_k], experts[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Slot-major positions: for (token t, slot j), the assignments to its
    # expert in slots < j, then in slot j from tokens < t.
    onehot = F.one_hot(experts.T.reshape(-1), e)  # [k T, E], slot-major rows
    before = torch.cumsum(onehot, dim=0) - onehot
    pos = before.gather(1, experts.T.reshape(-1, 1)).reshape(top_k, t).T
    if group is None:
        keep = pos < capacity
        # Switch load balance: routed fraction of first choices times mean prob.
        f = F.one_hot(experts[:, 0], e).float().mean(0)
    else:
        # Every rank's assignments per (slot, expert); a token's global
        # position adds the other ranks' in earlier slots and the lower
        # ranks' in its own slot.
        n, r = dist.get_world_size(group), dist.get_rank(group)
        counts = torch.zeros((n, top_k, e), dtype=torch.float32, device=x.device)
        counts[r] = onehot.view(top_k, t, e).sum(1).float()
        dist.all_reduce(counts, group=group)
        total = counts.sum(0)
        others = total - counts[r]
        offset = (torch.cumsum(others, 0) - others + counts[:r].sum(0)).long()
        keep = pos + offset.gather(1, experts.T).T < capacity
        f = total[0] / (n * t)
    # With group, this rank's part: the ranks' aux losses average to the
    # global batch's.
    aux = e * torch.sum(f * probs.mean(0))
    return probs, experts, gates, pos, keep, aux


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int):
    """JAX's dense routing: (dispatch ``[T, E, C]`` 0/1 fp32, combine ``[T,
    E, C]`` gate-weighted, aux). The forward does not build these (see the
    module's note); they are the routing's plain form."""
    _, experts, gates, pos, keep, aux = _route_indices(x, router, top_k, capacity)
    t, e = x.shape[0], router.shape[1]
    dispatch = x.new_zeros((t, e, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    tok = torch.arange(t, device=x.device)[:, None].expand_as(experts)
    sel = (tok[keep], experts[keep], pos[keep])
    dispatch[sel] = 1.0
    combine = combine.index_put(sel, gates[keep])
    return dispatch, combine, aux


def _experts_apply(wi: torch.Tensor, wo: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: ``xd`` ``[E, C, D]`` -> ``[E, C, D]`` fp32."""
    with _true_fp32():
        h = torch.bmm(xd.to(wi.dtype), wi)
        h = gelu_approx(h.float())
        return torch.bmm(h.to(wo.dtype), wo).float()


def _dispatch(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int,
              group=None):
    """Route ``x`` ``[T, D]`` and gather the kept tokens into the experts'
    buffers: (``xd`` ``[E, C, D]`` fp32, the routing the combine needs,
    keep ``[T, k]``, aux loss). With ``group`` (see :func:`_route_indices`)
    a buffer holds ``min(capacity, T)`` slots: a rank may hold any share of
    an expert's global capacity."""
    t, d = x.shape
    e = router.shape[1]
    _, experts, gates, pos, keep, aux = _route_indices(x, router, top_k, capacity, group)
    slots = capacity if group is None else min(capacity, t)
    slot = experts * slots + pos  # [T, k] flat (expert, position) index
    tok = torch.arange(t, device=x.device)[:, None].expand_as(experts)
    xd = x.new_zeros((e * slots, d), dtype=torch.float32)
    xd = xd.index_copy(0, slot[keep], x.float()[tok[keep]])
    return xd.view(e, slots, d), (slot, gates, keep), aux


def _combine(yd: torch.Tensor, routing) -> torch.Tensor:
    """The gate-weighted sum of each token's kept slots of ``yd`` ``[E, C,
    D]``: ``[T, D]`` fp32."""
    slot, gates, keep = routing
    yd = yd.reshape(-1, yd.shape[-1])
    # Dropped slots read any row and are weighted 0.
    w = torch.where(keep, gates, torch.zeros_like(gates))
    picked = yd[torch.where(keep, slot, torch.zeros_like(slot))]  # [T, k, D]
    return (w[..., None] * picked).sum(1)


def moe_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, top_k: int = 2,
                capacity_factor: float = 1.25, capacity: Optional[int] = None,
                stats: Optional[dict] = None, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE FFN: ``x`` ``[T, D]`` -> ``(y [T, D] in x's dtype,
    aux_loss)``. ``stats``, when given, receives the routing's ``dropped``
    share (of (token, slot) pairs past the capacity, a device tensor) and
    its ``capacity``. With a data-parallel ``group``, ``x`` is this rank's
    slice of the batch, routed as one device routes the whole batch (the
    capacity from its token count); ``aux_loss`` is this rank's part, and
    the ranks' parts average to the whole batch's."""
    router, wi, wo = params["router"], params["wi"], params["wo"]
    if capacity is None:
        tokens = x.shape[0] * (1 if group is None else dist.get_world_size(group))
        capacity = capacity_for(tokens, router.shape[1], top_k, capacity_factor)
    xd, routing, aux = _dispatch(x, router, top_k, capacity, group)
    y = _combine(_experts_apply(wi, wo, xd), routing)
    if stats is not None:
        stats["dropped"] = 1.0 - routing[2].float().mean()
        stats["capacity"] = capacity
    return y.to(x.dtype), aux


def moe_forward_expert_parallel(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    group,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of the expert-parallel MoE (JAX's ``shard_map``
    body): ``x`` ``[T_local, D]`` are the rank's tokens, ``params["router"]``
    ``[D, E]`` is whole on every rank and ``wi`` / ``wo`` hold the rank's
    ``E / n`` experts (rank ``r`` the experts ``[r E / n, (r + 1) E / n)``).
    The capacity comes from the local token count. Returns the rank's
    ``(y [T_local, D], aux)``, the aux loss averaged over the group. The
    gradients of the rank's experts are whole (every rank's tokens
    routed to them); the router's is this rank's tokens' part."""
    n = dist.get_world_size(group)
    router, wi, wo = params["router"], params["wi"], params["wo"]
    e = wi.shape[0] * n
    if router.shape[1] != e:
        raise ValueError(f"the router has {router.shape[1]} experts, the ranks hold {e}")
    if capacity is None:
        capacity = capacity_for(x.shape[0], e, top_k, capacity_factor)
    xd, routing, aux = _dispatch(x, router, top_k, capacity)
    xd = all_to_all(xd, 0, 1, group)  # [E / n, n C, D]: every rank's slots of my experts
    yd = all_to_all(_experts_apply(wi, wo, xd), 1, 0, group)  # [E, C, D], home again
    y = _combine(yd, routing)
    return y.to(x.dtype), all_reduce(aux, group) / n


def moe_apply_sharded(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    dim: str = "ep",
    top_k: int = 2,
    capacity_factor: float = 1.25,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the dim ``dim`` of ``mesh`` (JAX
    ``moe_apply_sharded``): ``params`` and the tokens ``x`` ``[T, D]`` whole
    on every rank; rank ``r`` takes its ``T / n`` tokens and its ``E / n``
    experts. The capacity comes from the local token count, so the result
    equals :func:`moe_forward`'s where no token overflows. Returns ``(y
    [T, D], aux)`` whole on every rank; the gradients with respect to
    ``params`` and ``x`` are whole on every rank. ``ValueError`` where the
    experts or the tokens do not split over the dim."""
    group = mesh.get_group(dim)
    n = dist.get_world_size(group)
    e = params["router"].shape[1]
    if e % n or x.shape[0] % n:
        raise ValueError(f"{e} experts and {x.shape[0]} tokens must both split over the "
                         f"{dim!r} dim's {n} ranks")
    if capacity is None:
        capacity = capacity_for(x.shape[0] // n, e, top_k, capacity_factor)
    local = {"router": copy_to_group(params["router"], group),
             "wi": scatter_dim(params["wi"], 0, group),
             "wo": scatter_dim(params["wo"], 0, group)}
    y, aux = moe_forward_expert_parallel(local, scatter_dim(x, 0, group), group, top_k=top_k,
                                         capacity=capacity)
    return gather_dim(y, 0, group), aux


class MoEMlp(nn.Module):
    """Drop-in for ``Mlp``: ``[..., dim]`` -> ``[..., dim]`` over all the
    leading positions as one token set. Parameters ``moe.router`` (fp32),
    ``moe.wi`` and ``moe.wo`` (``dtype``), the names of JAX's
    ``mlp/moe/{router,wi,wo}``. After a forward, ``aux_loss`` holds the
    Switch load-balance loss (JAX sows it as ``losses/moe_aux``) and
    ``dropped`` the share of (token, slot) pairs past the capacity (this
    rank's, inside :func:`data_parallel_routing`)."""

    def __init__(self, dim: int, hidden: int, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.moe = nn.ParameterDict({
            "router": nn.Parameter(torch.empty(dim, num_experts, device=device)),
            "wi": nn.Parameter(torch.empty(num_experts, dim, hidden, dtype=dtype, device=device)),
            "wo": nn.Parameter(torch.empty(num_experts, hidden, dim, dtype=dtype, device=device)),
        })
        self.aux_loss: Optional[torch.Tensor] = None
        self.dropped: Optional[torch.Tensor] = None
        self.capacity: Optional[int] = None
        # The data-parallel group to route over (data_parallel_routing).
        self.route_group = None
        self.reset_parameters(torch.Generator(device=device).manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's initializer scales (:func:`init_moe_params`)."""
        router = self.moe["router"]
        e, d, f = self.moe["wi"].shape
        fresh = init_moe_params(generator, d, f, e, self.moe["wi"].dtype, router.device)
        for name, p in self.moe.items():
            p.copy_(fresh[name])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats: dict = {}
        y, self.aux_loss = moe_forward(dict(self.moe.items()), x.reshape(-1, x.shape[-1]),
                                       self.top_k, self.capacity_factor, stats=stats,
                                       group=self.route_group)
        self.dropped, self.capacity = stats["dropped"], stats["capacity"]
        return y.reshape(x.shape)


@contextlib.contextmanager
def data_parallel_routing(model: nn.Module, group):
    """Inside the block (forward and backward, since a recomputed block
    routes again), every :class:`MoEMlp` of ``model`` takes its tokens as
    this rank's slice of a batch split over ``group`` in rank order, and
    routes as one device routes that whole batch (see the module's note).
    With ``group`` None nothing changes."""
    moes = [m for m in model.modules() if isinstance(m, MoEMlp)] if group is not None else []
    for m in moes:
        m.route_group = group
    try:
        yield
    finally:
        for m in moes:
            m.route_group = None


__all__ = [
    "MoEMlp",
    "data_parallel_routing",
    "init_moe_params",
    "moe_forward",
    "moe_forward_expert_parallel",
    "moe_apply_sharded",
]
