"""The segment walks of B1 and B7: what their kernels read beside the ids.

Segment ids (the JAX kernels' ``has_segments``; batch 1) say which keys a
q row sees: those of its own id. A packed batch of documents makes ids in
order, with negative markers for dead rows and keys (the varlen functions'
-1 and -2). B1's CTA for a 128-row q-tile walks only a key range ``[x,
y)`` and B7's CTA for a 128-key tile only a q-row range; :func:`walk_ranges`
computes them on the device, with no host sync. For ids whose non-negative
values are in order, the range runs from the first to the last index whose
id is one of the tile's (negative markers between them fall to the element
test); a tile with a negative id inside the span of the other side's
negative ids, or any other ids at all, walks everything. Ranges never hide a visible pair, so
any ids give the right result, only slower.

:func:`id_spans` gives each tile's least and largest id: a tile whose keys
and a warp's rows are all of one id skips the per-element test.
"""

from __future__ import annotations

import dataclasses

import torch

# Rows of B1's q-tiles and keys of B1's and B7's k-tiles; rows of B7's q-steps.
TILE = 128
STEP = 64


def walk_ranges(a: torch.Tensor, b: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """For each ``tile``-long tile of the ids ``a`` ``[n]``, the indices
    ``[lo, hi)`` of ``b`` ``[m]`` that can carry one of its ids: int32
    ``[ceil(n / tile), 2]``. Where ``b``'s non-negative ids are in order
    and the tile's negative ids lie outside the span of ``b``'s: from the
    first index whose id is at least the tile's least non-negative id up to
    the first whose id exceeds its largest, so every index whose id the
    tile carries lies inside; when each of those ids occurs in ``b`` (a
    packed batch), the range ends at the last such index but for negative
    markers after it. ``[0, 0)`` for a tile without a non-negative id;
    ``[0, m)`` otherwise."""
    n, m = a.numel(), b.numel()
    t = -(-n // tile)
    pad = t * tile - n
    a, b = a.reshape(-1).to(torch.int32), b.reshape(-1).to(torch.int32)
    big, small = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    live = a >= 0
    lo_id = torch.nn.functional.pad(torch.where(live, a, big), (0, pad), value=big)
    hi_id = torch.nn.functional.pad(torch.where(live, a, -1), (0, pad), value=-1)
    lo_id, hi_id = lo_id.view(t, tile).amin(1), hi_id.view(t, tile).amax(1)
    # b's non-negative ids, each negative one replaced by the last before it:
    # non-decreasing when b is in order apart from its negative markers.
    neg = b < 0
    fill = torch.cummax(torch.where(neg, -1, b), 0).values
    in_order = (neg | (b == fill)).all()
    lo = torch.searchsorted(fill, lo_id).to(torch.int32)
    hi = torch.searchsorted(fill, hi_id, right=True).to(torch.int32)
    found = hi_id >= 0
    # A negative id of the tile inside the span of b's negative ids.
    neg_lo, neg_hi = torch.where(neg, b, 0).amin(), torch.where(neg, b, small).amax()
    hit = ~live & (a >= neg_lo) & (a <= neg_hi)
    hit = torch.nn.functional.pad(hit, (0, pad)).view(t, tile).any(1)
    keep = found & in_order & ~hit
    full = ~in_order | hit
    lo = torch.where(keep, lo, 0)
    hi = torch.where(keep, hi, torch.where(full, m, 0))
    return torch.stack([lo, hi], 1).to(torch.int32)  # the kernels read int2


def id_spans(ids: torch.Tensor, tile: int) -> torch.Tensor:
    """Each ``tile``-long tile's least and largest id: int32
    ``[ceil(n / tile), 2]``."""
    n = ids.numel()
    t = -(-n // tile)
    pad = t * tile - n
    x = ids.reshape(-1).to(torch.int32)
    info = torch.iinfo(torch.int32)
    lo = torch.nn.functional.pad(x, (0, pad), value=info.max).view(t, tile).amin(1)
    hi = torch.nn.functional.pad(x, (0, pad), value=info.min).view(t, tile).amax(1)
    return torch.stack([lo, hi], 1).contiguous()


def pad_ids(ids: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """int32 ids padded to whole tiles with the last id (so that padded
    rows keep a warp's ids as they were; padded keys lie past Sk)."""
    x = ids.reshape(-1).to(torch.int32)
    pad = -x.numel() % tile
    return torch.cat([x, x[-1:].expand(pad)]).contiguous()


@dataclasses.dataclass(frozen=True)
class SegmentWalk:
    """What B1's and B7's segment kernels read, on the ids' device: the
    padded ids, B1's key range per q-tile and B7's row range per k-tile, the
    k-tiles' and B7's 64-row q blocks' id spans."""

    q: torch.Tensor
    k: torch.Tensor
    fwd_range: torch.Tensor
    bwd_range: torch.Tensor
    k_span: torch.Tensor
    q_span: torch.Tensor


def segment_walk(q_segments: torch.Tensor, kv_segments: torch.Tensor) -> SegmentWalk:
    """The :class:`SegmentWalk` of ids ``[1, Sq]`` and ``[1, Sk]``."""
    q = q_segments.reshape(-1).to(torch.int32)
    k = kv_segments.reshape(-1).to(torch.int32)
    return SegmentWalk(
        q=pad_ids(q), k=pad_ids(k),
        fwd_range=walk_ranges(q, k), bwd_range=walk_ranges(k, q),
        k_span=id_spans(k, TILE), q_span=id_spans(q, STEP),
    )


__all__ = ["SegmentWalk", "id_spans", "pad_ids", "segment_walk", "walk_ranges"]
