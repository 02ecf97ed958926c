"""Ring and Ulysses attention: exact attention with the sequence split
over a ``torch.distributed`` group (context parallelism).

Counterpart of ``liteattention_tpu/parallel/ring_attention.py``.

**Ring.** q, k and v are split on the sequence into the group's ``n``
ranks, in rank order. Each rank runs the dense kernel B1 of its q shard
against one K/V shard a step, with its lse, and merges the partials in
fp32 (:func:`_merge`, the pairwise form of
:func:`~liteattention_torch.ops.combine.combine_attention`); the K/V
shards pass to the next rank between steps (``batch_isend_irecv``, posted
before the step's kernel so the hop can overlap it), so after ``n - 1``
hops every q shard has seen every key while a rank holds two K/V shards
at a time. Causal masking is exact at the block level: a shard left of
the q shard runs the full kernel, the diagonal one the causal kernel, and
a shard to the right is skipped (no launch).

The gradient is a ``torch.autograd.Function`` (JAX's ``custom_vjp``): the
merged output is the global attention, so B7 per visiting shard with the
global (out, lse, dout) gives that block's exact dQ, dK, dV; the dK / dV
accumulators travel the ring with their shard and are home after ``n``
hops, dQ adds up where it is. The lse cotangent is ignored, as the
kernels' own gradient ignores it.

**Ulysses.** One ``all_to_all_single`` re-splits ``[B, H, S / n, D]``
(sequence-split) into ``[B, H / n, S, D]`` (head-split), B1 runs the whole
sequence for the rank's heads (causality needs no block schedule), and a
second ``all_to_all_single`` splits the sequence again. It needs ``H`` and
``Hk`` divisible by ``n``; the all-to-all's gradient is the inverse
all-to-all.

The ``*_local`` functions take the rank's shards (JAX's ``shard_map``
bodies); :func:`ring_self_attention` and :func:`ulysses_self_attention`
take the whole tensors on every rank, a ``DeviceMesh`` and a dim name,
run the rank's shard and all-gather the output (``shard_map``'s in and out
specs); their gradient with respect to the whole inputs is the whole
gradient on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from liteattention_torch.ops.flash_bwd import flash_attention_bwd
from liteattention_torch.ops.flash_fwd import flash_attention
from liteattention_torch.parallel._collectives import gather_dim, scatter_dim

_FULL, _DIAG, _SKIP = 0, 1, 2


def _merge(acc: Tuple[torch.Tensor, torch.Tensor], new):
    """Online-softmax merge of two normalized partials (fp32 out, lse)."""
    ao, al = acc
    no, nl = new
    nl = nl.float()
    m = torch.maximum(al, nl)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.exp(al - m_safe)
    w2 = torch.exp(nl - m_safe)
    den = w1 + w2
    tiny = torch.finfo(torch.float32).tiny
    out = (ao * w1[..., None] + no.float() * w2[..., None]) / den.clamp_min(tiny)[..., None]
    lse = torch.where(den == 0.0, -torch.inf, m_safe + torch.log(den))
    return out, lse


def _block_kind(causal: bool, owner: int, my: int) -> int:
    if not causal or owner < my:
        return _FULL
    return _DIAG if owner == my else _SKIP


def _shift(tensors, group, wait=True):
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's into new buffers (JAX's ``ppermute`` by one). Returns
    (received tensors, the requests, which ``wait=False`` leaves pending)."""
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    reqs = dist.batch_isend_irecv(ops)
    if wait:
        for r in reqs:
            r.wait()
        reqs = []
    return recv, reqs


def _ring_fwd(group, causal, scale, q, k, v):
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    b, h, sl, d = q.shape
    acc = (torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device),
           torch.full((b, h, sl), -torch.inf, dtype=torch.float32, device=q.device))
    kv = (k, v)
    for step in range(n):
        # After `step` hops the resident shard is the one rank my - step owns.
        owner = (my - step) % n
        reqs = []
        nxt = None
        if step < n - 1:
            nxt, reqs = _shift(kv, group, wait=False)
        kind = _block_kind(causal, owner, my)
        if kind != _SKIP:
            o, lse = flash_attention(q, kv[0], kv[1], scale=scale, causal=kind == _DIAG,
                                     return_lse=True)
            acc = _merge(acc, (o, lse))
        for r in reqs:
            r.wait()
        if nxt is not None:
            kv = tuple(nxt)
    return acc[0].to(q.dtype), acc[1]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _ring_fwd(group, causal, scale, q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n = dist.get_world_size(group)
        my = dist.get_rank(group)
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            kind = _block_kind(causal, (my - step) % n, my)
            if kind != _SKIP:
                dq_c, dk_c, dv_c = flash_attention_bwd(q, kb, vb, out, lse, dout, scale,
                                                      kind == _DIAG)
                dq += dq_c.float()
                dkb = dkb + dk_c.float()
                dvb = dvb + dv_c.float()
            # The accumulators go round all n hops (home after the last);
            # the K/V shards are not needed after the last step.
            if n > 1:
                moving = (kb, vb, dkb, dvb) if step < n - 1 else (dkb, dvb)
                moved, _ = _shift(moving, group)
                if step < n - 1:
                    kb, vb, dkb, dvb = moved
                else:
                    dkb, dvb = moved
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None, None


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: dist.ProcessGroup,
    causal: bool = False,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """This rank's part of ring attention: ``q`` ``[B, H, S / n, D]`` and
    ``k`` / ``v`` ``[B, Hk, S / n, D]``, the rank's shard of the sequence
    (rank ``r`` of ``group`` holds positions ``[r S / n, (r + 1) S / n)``).

    Returns out ``[B, H, S / n, D]`` (and the natural-log lse ``[B, H, S /
    n]`` fp32 with ``return_lse``), differentiable in q, k, v.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    out, lse = _RingAttention.apply(q, k, v, group, bool(causal), float(scale))
    if return_lse:
        return out, lse
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 (split in ``n`` equal chunks)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_head(x, group):
    """[B, H, S / n, D] sequence shard -> [B, H / n, S, D] head shard."""
    n = dist.get_world_size(group)
    b, h, sl, d = x.shape
    y = _all_to_all(x.reshape(b, n, h // n, sl, d).transpose(0, 1), group)
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * sl, d)


def _head_to_seq(x, group):
    """[B, H / n, S, D] head shard -> [B, H, S / n, D] sequence shard."""
    n = dist.get_world_size(group)
    b, hl, s, d = x.shape
    y = _all_to_all(x.reshape(b, hl, n, s // n, d).permute(2, 0, 1, 3, 4), group)
    return y.transpose(0, 1).reshape(b, n * hl, s // n, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g, ctx.group), None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g, ctx.group), None


def ulysses_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: dist.ProcessGroup,
    causal: bool = False,
    scale: Optional[float] = None,
):
    """This rank's part of Ulysses attention: ``q`` ``[B, H, S / n, D]``,
    ``k`` / ``v`` ``[B, Hk, S / n, D]`` (the rank's sequence shard, as
    :func:`ring_attention_local`); ``H`` and ``Hk`` divisible by ``n``
    (``ValueError`` otherwise). Returns out ``[B, H, S / n, D]``,
    differentiable."""
    n = dist.get_world_size(group)
    for name, x in (("heads", q), ("kv heads", k)):
        if x.shape[1] % n:
            raise ValueError(f"{name} {x.shape[1]} not divisible by the group's {n} ranks")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    qh, kh, vh = (_SeqToHead.apply(x, group) for x in (q, k, v))
    out = flash_attention(qh, kh, vh, scale=scale, causal=causal)
    return _HeadToSeq.apply(out, group)


def _global(local_fn, q, k, v, mesh, axis_name, **kw):
    group = mesh.get_group(axis_name)
    qs, ks, vs = (scatter_dim(x, 2, group) for x in (q, k, v))
    return gather_dim(local_fn(qs, ks, vs, group, **kw), 2, group)


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "sp",
    causal: bool = False,
    scale: Optional[float] = None,
):
    """Ring attention over the dim ``axis_name`` of ``mesh``: ``q`` / ``k``
    / ``v`` ``[B, H(k), S, D]`` whole on every rank, ``S`` divisible by the
    dim's size; returns the whole output on every rank."""
    return _global(ring_attention_local, q, k, v, mesh, axis_name, causal=causal, scale=scale)


def ulysses_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "sp",
    causal: bool = False,
    scale: Optional[float] = None,
):
    """Ulysses attention over the dim ``axis_name`` of ``mesh``, with the
    whole tensors on every rank (as :func:`ring_self_attention`); ``S``,
    ``H`` and ``Hk`` divisible by the dim's size."""
    return _global(ulysses_attention_local, q, k, v, mesh, axis_name, causal=causal,
                   scale=scale)


__all__ = ["ring_attention_local", "ring_self_attention",
           "ulysses_attention_local", "ulysses_self_attention"]
