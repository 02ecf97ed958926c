"""Sparse attention forwards with fused votes (kernels B3, B4, B5).

Counterpart of ``liteattention_tpu/ops/lite_flash_fwd.py:lite_flash_attention``
in its three schedule modes:

* **Gather** (``fine_schedule=True``, the engine's path; kernel B3): the
  schedule lists each fine q-row's live 128-key tiles. Replaces the Pallas
  kernel ``_lite_gather_kernel`` at ``block_q = 128``. With ``fold_h`` the
  same walk runs ``fold_h`` heads per CTA (kernel B5, replacing
  ``_lite_gather_kernel_hfold``), bit-identical to B3. With ``cidx`` the
  K/V tiles come from a union-compacted buffer
  (:mod:`liteattention_torch.ops.kv_compact`).
* **Coarse** (``fine_schedule=False``, no ``kv_bits``; kernel B4): the
  mask and the votes are at compute-tile granularity ``block_q x block_k``
  (the original's own model and static block-sparse masks). Replaces
  ``_lite_kernel``.
* **Super-tile** (``fine_schedule=False`` with ``kv_bits`` from
  :func:`~liteattention_torch.ops.mask.compact_mask_fine`; kernel B4): the
  schedule lists compute tiles, dead fine tiles inside them are skipped,
  and every live fine tile votes on its own.

Kernels: all three are the dense kernel B1 itself,
``csrc/flash_fwd.cu:flash_fwd_kernel`` (two wgmma warpgroups fed by TMA
through a three-stage mbarrier ring), walking the row's live-tile list
(B3, B5; entry ``lite_flash_fwd_gather``) or the coarse schedule's entries
in the order :func:`_coarse_walk` gives (B4; entry
``lite_flash_fwd_coarse``). One CTA per (b, h, 128-row q-tile) -- or
``fold_h`` heads in turn -- walks its schedule row, so a skipped tile
costs no load and no math; a coarse row of ``block_q = 128 * qsub`` rows
is walked by its ``qsub`` CTAs. What bounds them on the H100: tensor-core
issue on the visited tiles. A vote adds one row-max compare per tile and,
per warp with a passing row, one store of 0 into the votes the wrapper
fills with 1 (no barrier, no atomic: the coarse stores of a coarse row's
``qsub`` CTAs are the AND of their votes).

Vote contract (kept exactly from the JAX kernels):

* scores are compared in log2 space, ``s * scale * log2(e)``;
* tiles are visited in increasing k order; a vote step is ``gsize``
  consecutive gather entries, or one coarse entry, and every tile of a
  step is tested against ``m_prev``, the running row max from before the
  step: ``(s - m_prev) > thr`` (strict) for some valid q row means "do"
  (0);
* a tile votes "skip" (1) only if no valid row passes;
* the first entry votes 0 (all of it in coarse mode; in super-tile mode
  the lowest live fine tile of each fine q-row);
* padded q rows and k columns past ``seqlen_k`` never vote or contribute;
* in the coarse modes the JAX kernel masks with the finite
  ``-0.7 * f32max``, so a fully masked fine tile's max and every running
  max after the first entry are at least that value; the vote clamps both
  the same way.

Votes are written straight into an int32 array at the mask's granularity
pre-filled with 1, so unvisited tiles keep the neutral 1. K and V stay
separate ``[B, Hk, S, D]`` tensors: the TPU's K|V lane interleave, lane
padding and three-section schedule format are not carried over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from liteattention_torch.ops import _build
from liteattention_torch.ops.attention_ref import DEFAULT_MASK_VALUE
from liteattention_torch.ops.mask import cdiv
from liteattention_torch.ops.tile_sizes import VOTE_TILE, BlockSizes

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# q-tiles per chunk of the plain versions (bounds their score matrix).
PLAIN_Q_TILES = 4


def _chunk_scores(q, kf, scale):
    return torch.matmul(q.float(), kf.transpose(-1, -2)) * (scale * LOG2E)


def _chunk_headroom(s, fidx, count, seqlen_q_rows, gsize):
    """Per schedule entry j: max over the tile's valid q rows of
    ``max_col s - m_prev`` (log2 space; -inf at entries past count).

    ``s``: log2 scores ``[B, H, R, Sk]`` of ``fidx.shape[2]`` q-tiles,
    the first ``seqlen_q_rows`` rows valid.
    """
    b, h, rows, sk = s.shape
    qc, kt = fidx.shape[2], fidx.shape[3]
    neg = float("-inf")
    lm = F.pad(s, (0, kt * VOTE_TILE - sk, 0, qc * VOTE_TILE - rows), value=neg)
    lm = lm.reshape(b, h, qc * VOTE_TILE, kt, VOTE_TILE).amax(-1)
    idx = fidx.long().repeat_interleave(VOTE_TILE, dim=2)
    lm_sched = torch.gather(lm, -1, idx)  # [B, H, R', Kt] schedule order
    pos = torch.arange(kt, device=s.device)
    valid_j = (pos < count[..., None]).repeat_interleave(VOTE_TILE, dim=2)
    lm_sched = lm_sched.masked_fill(~valid_j, neg)
    steps = cdiv(kt, gsize)
    step_max = F.pad(lm_sched, (0, steps * gsize - kt), value=neg)
    step_max = step_max.reshape(b, h, qc * VOTE_TILE, steps, gsize).amax(-1)
    running = torch.cummax(step_max, dim=-1).values
    m_prev = F.pad(running[..., :-1], (1, 0), value=neg)
    m_prev = m_prev.repeat_interleave(gsize, dim=-1)[..., :kt]
    diff = (lm_sched - m_prev).masked_fill(~valid_j, neg)
    row_ok = torch.arange(qc * VOTE_TILE, device=s.device) < seqlen_q_rows
    diff = diff.masked_fill(~row_ok[:, None], neg)
    return diff.reshape(b, h, qc, VOTE_TILE, kt).amax(dim=3)


def vote_headroom(q, k, fidx, count, scale=None, gsize=1):
    """Vote headroom ``[B, H, Qt, Kt]`` in schedule order (plain torch).

    Entry j of a row is ``max over valid rows (max_col s - m_prev)`` for
    tile ``fidx[j]``: the tile votes "do" iff it exceeds the threshold.
    ``|headroom - thr|`` is the fp32 margin of each vote.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    out = []
    step = PLAIN_Q_TILES * VOTE_TILE
    for c, q0 in enumerate(range(0, q.shape[2], step)):
        qs = q[:, :, q0 : q0 + step]
        tiles = slice(c * PLAIN_Q_TILES, (c + 1) * PLAIN_Q_TILES)
        out.append(_chunk_headroom(
            _chunk_scores(qs, kf, scale), fidx[:, :, tiles],
            count[:, :, tiles], qs.shape[2], gsize,
        ))
    return torch.cat(out, dim=2)


def votes_from_headroom(headroom, fidx, count, threshold):
    """Fine-indexed votes ``[B, H, Qt, Kt]`` from schedule-order headroom:
    0 = do, 1 = skip; the first entry votes 0; unvisited tiles keep 1."""
    kt = fidx.shape[-1]
    pos = torch.arange(kt, device=fidx.device)
    sched = (headroom <= threshold) | torch.isnan(headroom)
    sched = sched & (pos > 0)
    sched = sched | (pos >= count[..., None])  # past count: neutral 1
    votes = torch.ones_like(fidx, dtype=torch.int32)
    votes.scatter_reduce_(-1, fidx.long(), sched.int(), reduce="amin")
    return votes


def _masked_softmax(s, live, v, dtype):
    """out (in ``dtype``) and natural-log lse of log2 scores ``s`` over the
    ``live`` columns; a row with no live column gives out 0, lse -inf."""
    neg = float("-inf")
    sm = s.masked_fill(~live, neg)
    m = sm.amax(-1, keepdim=True)
    p = torch.exp2(sm - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    empty = l == 0
    o = torch.matmul(p, v) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, neg, m * LN2 + torch.log(l))
    return o.to(dtype), lse[..., 0]


def _uncompact(x, fidx, count, cidx, do_mask):
    """K or V ``[B, Hk, S, D]`` at fine tile positions, rebuilt from the
    union-compacted buffer ``x``: tile ``fidx[j]`` of every live entry j of
    a row is tile ``cidx[j]`` of ``x``. Tiles no row uses stay 0."""
    b, hk, s, d = x.shape
    group = fidx.shape[1] // hk
    tiles = x.reshape(b, hk, s // VOTE_TILE, VOTE_TILE, d)
    pos = torch.arange(fidx.shape[-1], device=x.device)
    live = (pos < count[..., None]) & do_mask.any(-1, keepdim=True)
    bi, hi, qi, ji = live.nonzero(as_tuple=True)
    out = torch.zeros_like(tiles)
    out[bi, hi // group, fidx[bi, hi, qi, ji].long()] = (
        tiles[bi, hi // group, cidx[bi, hi, qi, ji].long()]
    )
    return out.reshape(x.shape)


def lite_flash_attention_plain(
    q, k, v, fidx, count, threshold, do_mask, scale=None, gsize=1,
    emit_votes=True, cidx=None,
):
    """Plain PyTorch version of the gather kernel (same arguments as
    :func:`lite_flash_attention` after validation; ``gsize`` is the vote
    step width in fine tiles; with ``cidx``, ``k``/``v`` are the
    union-compacted buffers)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if cidx is not None:
        k = _uncompact(k, fidx, count, cidx, do_mask)
        v = _uncompact(v, fidx, count, cidx, do_mask)
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    sk = k.shape[2]
    outs, lses, heads = [], [], []
    step = PLAIN_Q_TILES * VOTE_TILE
    for c, q0 in enumerate(range(0, q.shape[2], step)):
        qs = q[:, :, q0 : q0 + step]
        rows = qs.shape[2]
        tiles = slice(c * PLAIN_Q_TILES, (c + 1) * PLAIN_Q_TILES)
        s = _chunk_scores(qs, kf, scale)
        # A tile contributes iff it is live in the mask (a row with no
        # live tile, listed as a dead anchor, contributes nothing).
        live = do_mask[:, :, tiles].repeat_interleave(VOTE_TILE, dim=2)[:, :, :rows]
        live = live.repeat_interleave(VOTE_TILE, dim=3)[..., :sk]
        o, lse = _masked_softmax(s, live, vf, q.dtype)
        outs.append(o)
        lses.append(lse)
        if emit_votes:
            heads.append(_chunk_headroom(
                s, fidx[:, :, tiles], count[:, :, tiles], rows, gsize
            ))
    out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
    if not emit_votes:
        return out, lse, None
    headroom = torch.cat(heads, dim=2)
    return out, lse, votes_from_headroom(headroom, fidx, count, threshold)


def _coarse_walk(kv_idx, count, kv_bits, qsub, ksub, qtf):
    """Per fine q-tile: the fine k-tiles of each coarse entry ``[B, H, Qtf,
    E, ksub]`` and whether the q-tile visits them (entries in order, sub-tiles
    in order within each: the kernel's walk, which skips as well the tiles
    at or past the fine k-tile count; those hold no key)."""
    dev = kv_idx.device
    fq = torch.arange(qtf, device=dev)
    crow = fq // qsub
    idx = kv_idx[:, :, crow].long()  # [B, H, Qtf, E]
    tiles = idx[..., None] * ksub + torch.arange(ksub, device=dev)
    valid = torch.arange(idx.shape[-1], device=dev) < count[:, :, crow][..., None]
    live = valid[..., None].expand(tiles.shape)
    if kv_bits is not None:
        shift = ((fq % qsub) * ksub)[:, None, None] + torch.arange(ksub, device=dev)
        bits = kv_bits[:, :, crow].long()[..., None]
        live = live & (((bits >> shift) & 1) == 1)
    return tiles, live


def lite_flash_attention_coarse_plain(
    q, k, v, kv_idx, count, threshold, kv_bits=None, scale=None, qsub=1, ksub=1,
    return_headroom=False,
):
    """Plain PyTorch version of the coarse / super-tile kernel (B4): the
    schedule at ``block_q = 128 * qsub``, ``block_k = 128 * ksub``; votes at
    the coarse grid, or at the fine grid with ``kv_bits``.

    With ``return_headroom`` also the vote headroom at the vote grid: the
    max over a vote's valid rows (and, coarse, its fine tiles) of
    ``max_col s - m_prev`` as the kernel clamps them; a visited tile votes
    0 iff it exceeds the threshold or it is an anchor (headroom +inf);
    -inf where unvisited. ``|headroom - thr|`` is the fp32 margin of a vote.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    qtc, ktc = kv_idx.shape[2], kv_idx.shape[3]
    qtf, ktf = cdiv(sq, VOTE_TILE), ktc * ksub
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    tiles, live = _coarse_walk(kv_idx, count, kv_bits, qsub, ksub, qtf)
    e_pos = torch.arange(tiles.shape[3], device=q.device)
    neg, inf = float("-inf"), float("inf")
    outs, lses, heads = [], [], []
    step = PLAIN_Q_TILES * VOTE_TILE
    for c, q0 in enumerate(range(0, sq, step)):
        qs = q[:, :, q0 : q0 + step]
        rows = qs.shape[2]
        ft = slice(c * PLAIN_Q_TILES, (c + 1) * PLAIN_Q_TILES)
        t_c, l_c = tiles[:, :, ft], live[:, :, ft]  # [B, H, Qc, E, ksub]
        qc = t_c.shape[2]
        s = _chunk_scores(qs, kf, scale)
        live_fine = torch.zeros((b, h, qc, ktf), dtype=torch.int32, device=q.device)
        live_fine.scatter_add_(-1, t_c.flatten(3), l_c.flatten(3).int())
        live_el = (live_fine > 0).repeat_interleave(VOTE_TILE, dim=2)[:, :, :rows]
        live_el = live_el.repeat_interleave(VOTE_TILE, dim=3)[..., :sk]
        o, lse = _masked_softmax(s, live_el, vf, q.dtype)
        outs.append(o)
        lses.append(lse)
        # Votes: per row, each fine tile's max against m_prev of its entry.
        lm = F.pad(s, (0, ktf * VOTE_TILE - sk), value=neg)
        lm = lm.reshape(b, h, rows, ktf, VOTE_TILE).amax(-1)  # [B, H, R, Ktf]
        t_r = t_c.repeat_interleave(VOTE_TILE, dim=2)[:, :, :rows]
        l_r = l_c.repeat_interleave(VOTE_TILE, dim=2)[:, :, :rows]
        lm_e = torch.gather(lm, -1, t_r.flatten(3)).reshape(t_r.shape)
        entry_max = lm_e.masked_fill(~l_r, neg).amax(-1)  # [B, H, R, E]
        m_prev = F.pad(torch.cummax(entry_max, dim=-1).values[..., :-1], (1, 0), value=neg)
        m_prev = torch.where(e_pos > 0, m_prev.clamp(min=DEFAULT_MASK_VALUE), neg)
        diff = lm_e.clamp(min=DEFAULT_MASK_VALUE) - m_prev[..., None]
        diff = F.pad(diff.masked_fill(~l_r, neg), (0, 0, 0, 0, 0, qc * VOTE_TILE - rows),
                     value=neg)
        heads.append(diff.reshape(b, h, qc, VOTE_TILE, *diff.shape[3:]).amax(3))
    out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
    head = torch.cat(heads, dim=2)  # [B, H, Qtf, E, ksub]
    first = e_pos == 0
    if kv_bits is None:
        # A coarse tile passes iff one of its fine q-tiles passes on one of
        # its fine tiles; the first entry votes 0.
        head_c = torch.full((b, h, qtc * qsub, head.shape[3]), neg, device=q.device)
        head_c[:, :, :qtf] = head.amax(-1)
        head_c = head_c.reshape(b, h, qtc, qsub, -1).amax(3)
        head_c = torch.where(first, inf, head_c)
        head_c = torch.where(e_pos < count[..., None], head_c, neg)
        headroom = torch.full((b, h, qtc, ktc), neg, device=q.device)
        headroom.scatter_reduce_(-1, kv_idx.long(), head_c, reduce="amax")
        anchor = headroom == inf
    else:
        # Super-tile: the lowest live fine tile of the first entry votes 0.
        first_live = first[:, None] & (torch.cumsum(live.int(), dim=-1) == 1) & live
        head = torch.where(first_live, inf, head)
        headroom = torch.full((b, h, qtc * qsub, ktf), neg, device=q.device)
        headroom[:, :, :qtf].scatter_reduce_(-1, tiles.flatten(3), head.flatten(3),
                                             reduce="amax")
        anchor = torch.zeros_like(headroom, dtype=torch.int32)
        anchor[:, :, :qtf].scatter_reduce_(-1, tiles.flatten(3), first_live.flatten(3).int(),
                                           reduce="amax")
        anchor = anchor > 0
    votes = torch.where((headroom > threshold) | anchor, 0, 1).int()
    if return_headroom:
        return out, lse, votes, headroom
    return out, lse, votes


def _check_qkv(q, k, v):
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"incompatible shapes {q.shape} / {k.shape}")


def _check_kernel_inputs(q, k, v, *int_tensors):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the CUDA kernel takes bf16 q, k, v")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim {q.shape[-1]} not built (64 or 128; the lite walks at 80, "
                         "96 and 256 are ROADMAP B-iii 4)")
    if any(x.dtype != torch.int32 for x in int_tensors):
        raise TypeError("schedule tensors must be int32")


def lite_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_idx: torch.Tensor,
    count: torch.Tensor,
    threshold,
    do_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    emit_votes: bool = True,
    kv_bits: Optional[torch.Tensor] = None,
    fine_schedule: bool = True,
    cidx: Optional[torch.Tensor] = None,
    fold_h: Optional[int] = None,
):
    """Sparse flash attention over a compacted skip mask, with votes.

    Args:
      q: ``[B, H, Sq, D]``; k, v: ``[B, Hk, Sk, D]`` (``H % Hk == 0``).
      kv_idx, count: the schedule. Gather: ``pack_schedule(do_mask)``, fine
        ``[B, H, Qt, Kt]`` / ``[B, H, Qt]``. Coarse: ``compact_mask`` of a
        mask at ``block_sizes`` granularity; super-tile:
        ``compact_mask_fine(fine_mask, block_q // 128, block_k // 128)``.
      threshold: log2-space vote threshold (float or 0-d tensor).
      do_mask: gather only, bool ``[B, H, Qt, Kt]``, the mask the schedule
        came from.
      block_sizes: gather: ``block_q`` 128 and ``block_k = 128 * gsize``
        (the vote step width, default 1). Coarse: the compute tile
        (clamped to the 128-padded lengths as in JAX).
      emit_votes: gather only; False compiles the vote chain out and votes
        return None (the coarse modes always vote, as in JAX).
      kv_bits: super-tile liveness bitmaps aligned with ``kv_idx``.
      fine_schedule: True for the gather path, False for coarse/super-tile.
      cidx: gather only, int32 like ``kv_idx``: each entry's tile in
        union-compacted ``k``/``v`` (``compact_kv``;
        ``pack_schedule(kv_map=...)``). Needs ``Sk % 128 == 0``.
      fold_h: gather only: heads per CTA (kernel B5); must divide H.
        (JAX rounds a ``fold_h`` that does not divide H down silently;
        the port raises.)

    Returns:
      out ``[B, H, Sq, D]`` (q's dtype), lse fp32 ``[B, H, Sq]``, votes
      int32 at the mask's granularity (1 = skippable next step; gather and
      super-tile ``[B, H, Qtf, Ktf]`` fine, coarse ``[B, H, Qt, Kt]``) or
      None.
    """
    _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    thr = float(threshold)
    if fine_schedule:
        return _gather(q, k, v, kv_idx, count, thr, do_mask, scale, block_sizes,
                       emit_votes, cidx, fold_h)
    if do_mask is not None or cidx is not None or fold_h is not None:
        raise ValueError("do_mask, cidx and fold_h are gather-path arguments")
    return _coarse(q, k, v, kv_idx, count, thr, kv_bits, scale, block_sizes)


def _gather(q, k, v, fidx, count, thr, do_mask, scale, block_sizes, emit_votes, cidx,
            fold_h):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qt, kt = cdiv(sq, VOTE_TILE), cdiv(sk, VOTE_TILE)
    if tuple(fidx.shape) != (b, h, qt, kt) or tuple(count.shape) != (b, h, qt):
        raise ValueError("fidx/count do not match the q/k geometry")
    if do_mask is None or tuple(do_mask.shape) != (b, h, qt, kt) or do_mask.dtype != torch.bool:
        raise ValueError("do_mask must be bool [B, H, Qt, Kt]")
    if cidx is not None:
        if tuple(cidx.shape) != tuple(fidx.shape):
            raise ValueError("cidx must be aligned with fidx")
        if sk % VOTE_TILE:
            raise ValueError(f"compacted K/V need seqlen_k % {VOTE_TILE} == 0")
    fold = int(fold_h or 1)
    if fold < 1 or h % fold:
        raise ValueError(f"fold_h={fold_h} must divide the {h} heads")
    bs = block_sizes or BlockSizes(VOTE_TILE, VOTE_TILE)
    if bs.block_q != VOTE_TILE:
        raise ValueError("the Hopper gather kernel runs block_q = 128 only")
    gsize = max(1, min(bs.block_k // VOTE_TILE, kt))
    if q.device.type == "cpu":
        return lite_flash_attention_plain(
            q, k, v, fidx, count, thr, do_mask, scale, gsize, emit_votes, cidx
        )
    _check_kernel_inputs(q, k, v, fidx, count, *([] if cidx is None else [cidx]))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    fidx, count, mask = fidx.contiguous(), count.contiguous(), do_mask.contiguous()
    cidx = None if cidx is None else cidx.contiguous()
    _build.check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    votes = torch.ones((b, h, qt, kt), dtype=torch.int32, device=q.device)
    lib = _build.load_kernels()
    err = lib.lite_flash_fwd_gather(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), fidx.data_ptr(), count.data_ptr(),
        None if cidx is None else cidx.data_ptr(), mask.data_ptr(),
        votes.data_ptr(), b, h, k.shape[1], sq, sk, d, gsize, fold, float(scale),
        thr, int(emit_votes), q.device.index,
        _build.stream(q.device),
    )
    _build.check(err, "lite_flash_fwd")
    if fold > 1:
        lite_flash_attention.hfold_launches += 1
    else:
        lite_flash_attention.launches += 1
    return out, lse, (votes if emit_votes else None)


def _coarse(q, k, v, kv_idx, count, thr, kv_bits, scale, block_sizes):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bs = block_sizes or BlockSizes(VOTE_TILE, VOTE_TILE)
    bq = min(bs.block_q, max(VOTE_TILE, cdiv(sq, VOTE_TILE) * VOTE_TILE))
    bk = min(bs.block_k, max(VOTE_TILE, cdiv(sk, VOTE_TILE) * VOTE_TILE))
    qsub, ksub = bq // VOTE_TILE, bk // VOTE_TILE
    qtc, ktc = cdiv(sq, bq), cdiv(sk, bk)
    if tuple(kv_idx.shape) != (b, h, qtc, ktc) or tuple(count.shape) != (b, h, qtc):
        raise ValueError(f"kv_idx/count do not match the ({bq}, {bk}) tile grid")
    if kv_bits is not None:
        if tuple(kv_bits.shape) != tuple(kv_idx.shape):
            raise ValueError("kv_bits must be aligned with kv_idx")
        if qsub * ksub > 32:
            raise ValueError("super-tile bitmaps hold qsubs * ksubs <= 32 fine tiles")
    if ksub > 32:
        raise ValueError("block_k must be at most 4096")
    if q.device.type == "cpu":
        return lite_flash_attention_coarse_plain(
            q, k, v, kv_idx, count, thr, kv_bits, scale, qsub, ksub
        )
    _check_kernel_inputs(q, k, v, kv_idx, count, *([] if kv_bits is None else [kv_bits]))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_idx, count = kv_idx.contiguous(), count.contiguous()
    bits = None if kv_bits is None else kv_bits.contiguous()
    _build.check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    vshape = (qtc, ktc) if bits is None else (qtc * qsub, ktc * ksub)
    votes = torch.ones((b, h, *vshape), dtype=torch.int32, device=q.device)
    lib = _build.load_kernels()
    err = lib.lite_flash_fwd_coarse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        kv_idx.data_ptr(), count.data_ptr(), None if bits is None else bits.data_ptr(),
        votes.data_ptr(), b, h, k.shape[1], sq, sk, d, qsub, ksub, float(scale), thr,
        q.device.index, _build.stream(q.device),
    )
    _build.check(err, "lite_flash_fwd_coarse")
    lite_flash_attention.coarse_launches += 1
    return out, lse, votes


# Launch counts of the three kernel entries: B3, B5 (fold_h > 1), B4.
lite_flash_attention.launches = 0
lite_flash_attention.hfold_launches = 0
lite_flash_attention.coarse_launches = 0

__all__ = [
    "LOG2E",
    "lite_flash_attention",
    "lite_flash_attention_coarse_plain",
    "lite_flash_attention_plain",
    "vote_headroom",
    "votes_from_headroom",
]
