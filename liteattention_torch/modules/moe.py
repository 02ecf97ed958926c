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

The expert-parallel forms (``moe_forward_expert_parallel``,
``moe_apply_sharded``) wait for the training half of the port's
``parallel/`` (ROADMAP A15b) and raise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from liteattention_torch.device import resolve_device
from liteattention_torch.ops.activations import gelu_approx


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


def _route_indices(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int):
    """Routing of ``x`` ``[T, D]``: (probs ``[T, E]`` fp32, experts ``[T, k]``,
    gates ``[T, k]`` fp32 normalised over the k choices, positions ``[T, k]``
    within each expert's buffer in slot-major order, keep ``[T, k]``
    (position < capacity), aux loss)."""
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
    keep = pos < capacity
    # Switch load balance: routed fraction of first choices times mean prob.
    f = F.one_hot(experts[:, 0], e).float().mean(0)
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


def moe_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, top_k: int = 2,
                capacity_factor: float = 1.25, capacity: Optional[int] = None,
                stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE FFN: ``x`` ``[T, D]`` -> ``(y [T, D] in x's dtype,
    aux_loss)``. ``stats``, when given, receives the routing's ``dropped``
    share (of (token, slot) pairs past the capacity, a device tensor) and
    its ``capacity``."""
    t, d = x.shape
    router, wi, wo = params["router"], params["wi"], params["wo"]
    e = router.shape[1]
    if capacity is None:
        capacity = capacity_for(t, e, top_k, capacity_factor)
    _, experts, gates, pos, keep, aux = _route_indices(x, router, top_k, capacity)
    slot = experts * capacity + pos  # [T, k] flat (expert, position) index
    tok = torch.arange(t, device=x.device)[:, None].expand_as(experts)
    kept_slot, kept_tok = slot[keep], tok[keep]
    xd = x.new_zeros((e * capacity, d), dtype=torch.float32)
    xd = xd.index_copy(0, kept_slot, x.float()[kept_tok])
    yd = _experts_apply(wi, wo, xd.view(e, capacity, d)).reshape(e * capacity, d)
    # Dropped slots read any row and are weighted 0.
    w = torch.where(keep, gates, torch.zeros_like(gates))
    picked = yd[torch.where(keep, slot, torch.zeros_like(slot))]  # [T, k, D]
    y = (w[..., None] * picked).sum(1)
    if stats is not None:
        stats["dropped"] = 1.0 - keep.float().mean()
        stats["capacity"] = capacity
    return y.to(x.dtype), aux


def moe_forward_expert_parallel(*args, **kwargs):
    """Expert parallelism (two all_to_all hops a layer in JAX) is not
    ported yet (ROADMAP A15b)."""
    raise NotImplementedError(
        "moe_forward_expert_parallel: expert parallelism is not ported yet (ROADMAP A15b)")


def moe_apply_sharded(*args, **kwargs):
    """The sharded MoE entry is not ported yet (ROADMAP A15b)."""
    raise NotImplementedError(
        "moe_apply_sharded: expert parallelism is not ported yet (ROADMAP A15b)")


class MoEMlp(nn.Module):
    """Drop-in for ``Mlp``: ``[..., dim]`` -> ``[..., dim]`` over all the
    leading positions as one token set. Parameters ``moe.router`` (fp32),
    ``moe.wi`` and ``moe.wo`` (``dtype``), the names of JAX's
    ``mlp/moe/{router,wi,wo}``. After a forward, ``aux_loss`` holds the
    Switch load-balance loss (JAX sows it as ``losses/moe_aux``) and
    ``dropped`` the share of (token, slot) pairs past the capacity."""

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
                                       self.top_k, self.capacity_factor, stats=stats)
        self.dropped, self.capacity = stats["dropped"], stats["capacity"]
        return y.reshape(x.shape)


__all__ = [
    "MoEMlp",
    "init_moe_params",
    "moe_forward",
    "moe_forward_expert_parallel",
    "moe_apply_sharded",
]
