"""Skip-mask state operations.

Counterpart of ``liteattention_tpu/ops/mask.py``. The skip state is a
dense boolean tile map ``do_mask[B, H, Qt, Kt]`` (True = compute the
tile) at the fine 128 x 128 granularity. The Hopper kernel walks one
compacted list of live k-tiles per (b, h, q-tile) row
(:func:`liteattention_torch.ops.schedule_pack.pack_schedule`), and
:func:`update_mask` folds the kernel's votes into the next step's mask.

Invariants kept from the JAX package:

* **Monotone shrinkage** -- a tile outside the mask is never re-tested.
* **First-tile anchor** -- a row never goes fully empty.
* **Must-do immunity** -- must-do tiles are never newly skipped.

Everything here is plain torch on the mask's device; none of it is a
kernel in the JAX package either (``update_mask`` is an XLA elementwise
fold there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from liteattention_torch.device import resolve_device


class SkipMaskState(NamedTuple):
    """Skip-mask state carried across denoising timesteps.

    Attributes:
      do_mask: bool ``[B, H, Qt, Kt]``. True = the k-tile is computed for
        this (batch, head, q-tile) row.
      step: number of attention calls folded into the mask.
    """

    do_mask: torch.Tensor
    step: int

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return tuple(self.do_mask.shape)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def init_mask(
    batch: int,
    heads: int,
    seqlen_q: int,
    seqlen_k: int,
    block_q: int,
    block_k: int,
    must_skip_ranges: Optional[Sequence[Tuple[int, int]]] = None,
    device=None,
) -> SkipMaskState:
    """Build the initial (full) skip-mask state.

    ``must_skip_ranges`` are half-open ``[lo, hi)`` sequence-index
    ranges to pre-skip; only k-tiles fully inside a range are skipped,
    and a row that would go empty keeps its first tile. The mask goes on
    ``device`` (default ``cuda``).
    """
    qtiles = cdiv(seqlen_q, block_q)
    ktiles = cdiv(seqlen_k, block_k)
    mask = np.ones((batch, heads, qtiles, ktiles), dtype=bool)
    if must_skip_ranges:
        tile_lo = np.arange(ktiles) * block_k
        tile_hi = np.minimum(tile_lo + block_k, seqlen_k)
        for lo, hi in must_skip_ranges:
            covered = (tile_lo >= lo) & (tile_hi <= hi)
            mask[:, :, :, covered] = False
        empty_rows = ~mask.any(axis=-1)
        if empty_rows.any():
            mask[empty_rows, 0] = True
    return SkipMaskState(
        do_mask=torch.from_numpy(mask).to(resolve_device(device)), step=0
    )


def must_do_mask(
    must_do_ranges: Sequence[Tuple[int, int]],
    seqlen_k: int,
    block_k: int,
    device=None,
) -> torch.Tensor:
    """Expand must-do sequence ranges to a per-k-tile protection mask.

    Any k-tile overlapping a half-open ``[lo, hi)`` range is protected.
    Returns bool ``[Kt]`` on ``device`` (default ``cuda``), broadcastable
    against ``do_mask``.
    """
    ktiles = cdiv(seqlen_k, block_k)
    mask = np.zeros((ktiles,), dtype=bool)
    tile_lo = np.arange(ktiles) * block_k
    tile_hi = np.minimum(tile_lo + block_k, seqlen_k)
    for lo, hi in must_do_ranges:
        mask |= (tile_hi > lo) & (tile_lo < hi)
    return torch.from_numpy(mask).to(resolve_device(device))


def update_mask(
    state: SkipMaskState,
    votes: torch.Tensor,
    must_do: Optional[torch.Tensor] = None,
) -> SkipMaskState:
    """Fold the kernel's skip votes into the next step's mask.

    ``votes`` is int/bool ``[B, H, Qt, Kt]``: nonzero = skip next step.
    The update ANDs with the old mask (monotone shrinkage); ``must_do``
    vetoes new skips; a row whose every surviving tile voted skip keeps
    its first surviving tile.
    """
    keep = ~votes.bool()
    if must_do is not None:
        keep = keep | must_do
    old = state.do_mask
    new_do = old & keep
    empty = ~new_do.any(dim=-1, keepdim=True)
    first_live = old & (torch.cumsum(old.int(), dim=-1) == 1)
    new_do = new_do | (empty & first_live)
    return SkipMaskState(do_mask=new_do, step=state.step + 1)


def compact_mask(do_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact each row into its surviving k-tile indices.

    Returns:
      kv_idx: int32 ``[B, H, Qt, Kt]`` -- surviving indices in increasing
        order in ``[0, count)``; tail positions repeat the last one.
      count: int32 ``[B, H, Qt]`` -- number of survivors, at least 1.
    """
    keep = do_mask.int()
    count = keep.sum(dim=-1).clamp(min=1)
    order = torch.argsort(1 - keep, dim=-1, stable=True).int()
    last = torch.gather(order, -1, (count - 1)[..., None].long())
    pos = torch.arange(do_mask.shape[-1], device=do_mask.device)
    kv_idx = torch.where(pos < count[..., None], order, last)
    return kv_idx.int(), count.int()


def compact_mask_fine(
    do_mask: torch.Tensor, qsubs: int, ksubs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hierarchical compaction of a fine mask for the super-tile schedule.

    A compute tile covers ``qsubs x ksubs`` fine tiles; it is scheduled iff
    any of them is live.

    Args:
      do_mask: bool ``[B, H, Qtf, Ktf]`` fine mask.
      qsubs, ksubs: fine tiles per compute tile along q / k
        (``qsubs * ksubs <= 32``: the sub-mask is one int32 per tile).

    Returns:
      kv_idx: int32 ``[B, H, Qt, Kt]`` live super-tile indices
        (:func:`compact_mask`'s contract).
      count: int32 ``[B, H, Qt]`` live super-tiles (>= 1).
      kv_bits: int32 ``[B, H, Qt, Kt]`` aligned with ``kv_idx``: bit
        ``qs * ksubs + ks`` is the liveness of fine tile (qs, ks) inside
        super-tile ``kv_idx[..., j]``.
    """
    if qsubs * ksubs > 32:
        raise ValueError("qsubs * ksubs must be <= 32 (one int32 per tile)")
    b, h, qtf, ktf = do_mask.shape
    qt, kt = cdiv(qtf, qsubs), cdiv(ktf, ksubs)
    fine = torch.zeros(
        (b, h, qt * qsubs, kt * ksubs), dtype=torch.bool, device=do_mask.device
    )
    fine[:, :, :qtf, :ktf] = do_mask  # padded fine tiles are dead
    fine = fine.reshape(b, h, qt, qsubs, kt, ksubs)
    kv_idx, count = compact_mask(fine.any(dim=5).any(dim=3))
    shifts = (
        torch.arange(qsubs, device=do_mask.device)[:, None] * ksubs
        + torch.arange(ksubs, device=do_mask.device)[None, :]
    )
    weights = torch.ones_like(shifts, dtype=torch.int64) << shifts
    bits = (fine.long() * weights[:, None, :]).sum(dim=(3, 5))
    kv_bits = torch.gather(bits, -1, kv_idx.long())
    # Bit 31 set reads back negative, as JAX's int32 sum wraps.
    return kv_idx, count, kv_bits.to(torch.int32)


def compact_mask_gather(
    do_mask: torch.Tensor, qsubs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fine-granularity compaction for the gather schedule.

    Args:
      do_mask: bool ``[B, H, Qtf, Ktf]`` fine mask.
      qsubs: fine q-tiles per compute q-tile (1 on Hopper).

    Returns:
      fidx: int32 ``[B, H, Qt, Ktf]`` live fine k-tiles of the union over
        each compute q-tile's fine rows, increasing, tail repeats last.
      count: int32 ``[B, H, Qt]`` number of live tiles (>= 1).
      qbits: int32 ``[B, H, Qt, Ktf]`` aligned with ``fidx``: bit qs is
        the liveness of fine tile (qs, fidx[j]).
    """
    if qsubs > 32:
        raise ValueError("qsubs must be <= 32")
    b, h, qtf, ktf = do_mask.shape
    qt = cdiv(qtf, qsubs)
    fine = torch.zeros(
        (b, h, qt * qsubs, ktf), dtype=torch.bool, device=do_mask.device
    )
    fine[:, :, :qtf] = do_mask
    fine = fine.reshape(b, h, qt, qsubs, ktf)
    live_k = fine.any(dim=3)
    fidx, count = compact_mask(live_k)
    weights = 1 << torch.arange(qsubs, device=do_mask.device, dtype=torch.int32)
    bits = (fine.int() * weights[None, None, None, :, None]).sum(dim=3)
    qbits = torch.gather(bits, -1, fidx.long()).int()
    return fidx, count, qbits


def sparsity(do_mask: torch.Tensor) -> torch.Tensor:
    """Fraction of attention tiles skipped, in [0, 1] (a 0-d tensor)."""
    return 1.0 - do_mask.float().mean()


# Range-list interop: the CUDA LiteAttention wire format, int32 rows
# [len, start_0, end_0, ...] of inclusive do-ranges in decreasing order.


def mask_to_range_list(do_mask) -> np.ndarray:
    """Dense bool mask ``[B, H, Qt, Kt]`` -> range-list rows
    ``[B, H, Qt, 1 + 2 * ceil(Kt / 2)]``."""
    do_mask = np.asarray(do_mask, dtype=bool)
    b, h, qt, kt = do_mask.shape
    width = 1 + 2 * ((kt + 1) // 2)
    out = np.zeros((b, h, qt, width), dtype=np.int32)
    flat = do_mask.reshape(-1, kt)
    oflat = out.reshape(-1, width)
    for r in range(flat.shape[0]):
        padded = np.diff(np.concatenate([[0], flat[r].astype(np.int8), [0]]))
        starts = np.nonzero(padded == 1)[0]
        ends = np.nonzero(padded == -1)[0] - 1  # inclusive
        vals = []
        for s, e in zip(starts[::-1], ends[::-1]):
            vals.extend([int(e), int(s)])  # start(high) then end(low)
        oflat[r, 0] = len(vals)
        oflat[r, 1 : 1 + len(vals)] = vals
    return out


def range_list_to_mask(range_list, ktiles: int) -> np.ndarray:
    """Range-list rows -> dense bool mask (inverse converter)."""
    range_list = np.asarray(range_list)
    b, h, qt, _ = range_list.shape
    out = np.zeros((b, h, qt, ktiles), dtype=bool)
    flat = range_list.reshape(-1, range_list.shape[-1])
    oflat = out.reshape(-1, ktiles)
    for r in range(flat.shape[0]):
        n = int(flat[r, 0])
        for i in range(1, n, 2):
            hi, lo = int(flat[r, i]), int(flat[r, i + 1])
            oflat[r, lo : hi + 1] = True
    return out


__all__ = [
    "SkipMaskState",
    "cdiv",
    "init_mask",
    "must_do_mask",
    "update_mask",
    "compact_mask",
    "compact_mask_fine",
    "compact_mask_gather",
    "sparsity",
    "mask_to_range_list",
    "range_list_to_mask",
]
