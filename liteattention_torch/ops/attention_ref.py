"""Plain fp32 attention oracles (test references).

Counterpart of ``liteattention_tpu/ops/attention_ref.py``
(``attention_ref``, ``skip_votes_ref``, ``skip_votes_ref_fine``,
``skip_votes_ref_gather``). Everything here is
deliberately naive -- full score matrices in fp32 -- and exists only to
check the kernels; never use it at real sequence lengths.

Layout: ``[B, H, S, D]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    tile_mask: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (optionally tile-masked) attention in fp32.

    Args:
      q, k, v: ``[B, H, S, D]`` (any float dtype; math is fp32).
      scale: softmax scale; default ``1/sqrt(D)``.
      causal: apply a causal mask.
      tile_mask: optional bool ``[B, H, Qt, Kt]``; masked tiles (of
        ``block_q`` x ``block_k``) contribute nothing.
      bias: optional additive bias ``[B, H, Sq, Sk]``.

    Returns:
      (out ``[B, H, Sq, D]`` in q's dtype, lse ``[B, H, Sq]`` fp32,
      natural log).
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    sq, sk = s.shape[-2], s.shape[-1]
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = torch.where(col <= row, s, DEFAULT_MASK_VALUE)
    if tile_mask is not None:
        if block_q is None or block_k is None:
            raise ValueError("tile_mask needs block_q and block_k")
        elem = tile_mask[:, :, row // block_q, col // block_k]
        s = torch.where(elem, s, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


def skip_votes_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    do_mask: torch.Tensor,
    threshold: float,
    block_q: int,
    block_k: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Oracle for the QK-skip vote at one (``block_q``, ``block_k``) tile
    grid, as JAX's ``skip_votes_ref``.

    Per (b, h, q-tile) row, the tiles of ``do_mask`` are walked in
    increasing order with a running per-q-row max ``m``: the first live
    tile votes 0; a later live tile votes 1 iff for every q row of the tile
    ``(local_max - m_prev) * scale * log2(e) <= threshold``; ``m`` then
    absorbs the tile. Positions outside ``do_mask`` vote 1. Returns int32
    ``[B, H, Qt, Kt]``.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / (d**0.5)
    qt, kt = do_mask.shape[-2:]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.nn.functional.pad(s, (0, kt * block_k - sk, 0, qt * block_q - sq),
                                value=-float("inf"))
    local_max = s.reshape(b, h, qt, block_q, kt, block_k).amax(dim=-1)  # [B, H, Qt, bq, Kt]
    do = do_mask.bool().to(q.device).expand(b, h, qt, kt)
    m = torch.full((b, h, qt, block_q), -float("inf"), device=q.device)
    visited = torch.zeros((b, h, qt), dtype=torch.bool, device=q.device)
    votes = []
    for t in range(kt):
        lm, live = local_max[..., t], do[..., t]
        # NaN (-inf - -inf: a row with nothing yet) compares False, as in JAX.
        step = ((lm - m) * LOG2E > threshold).any(dim=-1)
        votes.append(torch.where(live, ~step & visited, True))
        m = torch.where(live[..., None], torch.maximum(m, lm), m)
        visited = visited | live
    return torch.stack(votes, dim=-1).to(torch.int32)


def skip_votes_ref_fine(
    q,
    k,
    do_mask,
    threshold: float,
    block_q: int,
    block_k: int,
    scale: Optional[float] = None,
    vote_tile: int = 128,
) -> np.ndarray:
    """Oracle for sub-tile (fine) skip votes, in numpy, as JAX's
    ``skip_votes_ref_fine``: the compute tiles are (``block_q``,
    ``block_k``) super-tiles, the mask and the votes ``vote_tile`` fine
    tiles. Per (b, h, q-row): super-tiles are visited in increasing order
    iff any fine tile they cover is live; in a visited super-tile each fine
    tile gets ``(local_max_fine - m_prev) * log2(e) > thr`` ANDed over its
    128-row group (dead fine tiles masked out of the local maxes); on the
    first visited super-tile the first live fine tile of each row group
    votes 0; the running max then absorbs the whole super-tile. Returns
    int32 ``[B, H, Qtf, Ktf]``; votes at dead fine positions are
    unspecified."""
    q = np.asarray(q, np.float32)
    k = np.asarray(k, np.float32)
    do_mask = np.asarray(do_mask, bool)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    qsubs, ksubs = block_q // vote_tile, block_k // vote_tile
    _, _, qtf, ktf = do_mask.shape
    qt, kt = -(-qtf // qsubs), -(-ktf // ksubs)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = np.pad(
        s,
        ((0, 0), (0, 0), (0, qt * block_q - sq), (0, kt * block_k - sk)),
        constant_values=-np.inf,
    )
    fine = np.zeros((b, h, qt * qsubs, kt * ksubs), bool)
    fine[:, :, :qtf, :ktf] = do_mask
    live_elem = np.repeat(np.repeat(fine, vote_tile, 2), vote_tile, 3)
    s = np.where(live_elem, s, -np.inf)
    lm = s.reshape(b, h, qt * block_q, kt * ksubs, vote_tile).max(-1)
    votes = np.ones((b, h, qt * qsubs, kt * ksubs), np.int32)
    superlive = fine.reshape(b, h, qt, qsubs, kt, ksubs).any(axis=(3, 5))
    row_ok = np.arange(block_q)
    with np.errstate(invalid="ignore"):
        for bi in range(b):
            for hi in range(h):
                for qi in range(qt):
                    rows = slice(qi * block_q, (qi + 1) * block_q)
                    m = np.full((block_q,), -np.inf, np.float32)
                    valid_r = (row_ok + qi * block_q) < sq
                    for j, t in enumerate(np.nonzero(superlive[bi, hi, qi])[0]):
                        lmt = lm[bi, hi, rows, t * ksubs : (t + 1) * ksubs]
                        diff = (lmt - m[:, None]) * LOG2E
                        do = np.where(np.isnan(diff), False, diff > threshold)
                        do &= valid_r[:, None]
                        for qs in range(qsubs):
                            seg = do[qs * vote_tile : (qs + 1) * vote_tile]
                            live_row = fine[bi, hi, qi * qsubs + qs, t * ksubs : (t + 1) * ksubs]
                            first_ks = int(np.argmax(live_row)) if live_row.any() else -1
                            for ks in range(ksubs):
                                anchor = j == 0 and ks == first_ks
                                votes[bi, hi, qi * qsubs + qs, t * ksubs + ks] = (
                                    0 if anchor else int(not seg[:, ks].any())
                                )
                        m = np.maximum(m, lmt.max(-1))
    return votes[:, :, :qtf, :ktf]


def skip_votes_ref_gather(
    q,
    k,
    do_mask,
    threshold: float,
    block_q: int,
    gsize: int,
    scale: Optional[float] = None,
    vote_tile: int = 128,
) -> np.ndarray:
    """Oracle for gather-schedule votes, in numpy.

    Per (b, h, compute q-row): the live fine k-tiles (union over the
    row's ``block_q // 128`` fine rows) are visited in increasing order
    in groups of ``gsize``; every entry of a group is tested against the
    running max from BEFORE the group; the first entry votes 0; the
    running max then absorbs the group's maxes. Votes at dead fine
    positions are unspecified.
    """
    q = np.asarray(q, np.float32)
    k = np.asarray(k, np.float32)
    do_mask = np.asarray(do_mask, bool)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    qsubs = block_q // vote_tile
    _, _, qtf, ktf = do_mask.shape
    qt = -(-qtf // qsubs)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = np.pad(
        s,
        ((0, 0), (0, 0), (0, qt * block_q - sq), (0, ktf * vote_tile - sk)),
        constant_values=-np.inf,
    )
    fine = np.zeros((b, h, qt * qsubs, ktf), bool)
    fine[:, :, :qtf, :] = do_mask
    live_elem = np.repeat(np.repeat(fine, vote_tile, 2), vote_tile, 3)
    s = np.where(live_elem, s, -np.inf)
    lm = s.reshape(b, h, qt * block_q, ktf, vote_tile).max(-1)
    votes = np.ones((b, h, qt * qsubs, ktf), np.int32)
    union = fine.reshape(b, h, qt, qsubs, ktf).any(axis=3)
    row_ok = np.arange(block_q)
    with np.errstate(invalid="ignore"):
        for bi in range(b):
            for hi in range(h):
                for qi in range(qt):
                    visit = np.nonzero(union[bi, hi, qi])[0]
                    rows = slice(qi * block_q, (qi + 1) * block_q)
                    m = np.full((block_q,), -np.inf, np.float32)
                    valid_r = (row_ok + qi * block_q) < sq
                    for j0 in range(0, len(visit), gsize):
                        chunk = visit[j0 : j0 + gsize]
                        lmt = lm[bi, hi, rows][:, chunk]
                        diff = (lmt - m[:, None]) * LOG2E
                        do = np.where(np.isnan(diff), False, diff > threshold)
                        do &= valid_r[:, None]
                        for e, t in enumerate(chunk):
                            for qs in range(qsubs):
                                seg = do[qs * vote_tile : (qs + 1) * vote_tile, e]
                                anchor = j0 == 0 and e == 0
                                votes[bi, hi, qi * qsubs + qs, t] = (
                                    0 if anchor else int(not seg.any())
                                )
                        m = np.maximum(m, lmt.max(-1))
    return votes[:, :, :qtf, :]


__all__ = [
    "attention_ref",
    "skip_votes_ref",
    "skip_votes_ref_fine",
    "skip_votes_ref_gather",
    "DEFAULT_MASK_VALUE",
]
