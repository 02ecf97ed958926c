"""Split-KV decode over a contiguous or paged cache: the core that the
decode wrappers of kernels B8, B9a and B9b share.

Kernel: ``csrc/flash_decode.cu`` (one launch per call, the split merge
folded in), replacing the Pallas kernels ``liteattention_tpu/ops/flash_fwd.py:
_decode_folded_kernel`` (B8), ``ops/paged_attention.py:_paged_kernel``
(B9a) and ``_paged_folded_kernel`` (B9b). The wrappers
(:func:`~liteattention_torch.ops.flash_fwd.flash_attention_decode`,
:func:`~liteattention_torch.ops.paged_attention.paged_attention` and
:func:`~liteattention_torch.ops.paged_attention.paged_attention_folded`)
pack the q rows of each KV head as ``[B, Hk, R, D]`` with ``R = sq *
group`` ordered (q position, group member), fold int8 scales, and hand
this module the cache with the sizes and strides of its (page, slot, head)
dims. Row ``r`` is q position ``r // group``; it sees key ``col`` iff
``low <= col < bound`` and, when causal, ``col < bound - sq + r // group +
1`` (bottom-right aligned).

What bounds the kernel on the H100 is bytes (see the source's header). Its
work is cut on the device, with no host sync: a unit is one (b, kv head,
16-row tile), its keys run from ``low`` to the bound of its last row in key
tiles of ``TILE_KEYS`` aligned to absolute positions, and CTA
``c`` of the ``grid`` takes the c-th of equal chunks of the flat sequence
of all units' tiles (:func:`split_plan` is the same chunking in Python).
The last piece of a split unit to finish merges the pieces; the ticket
buffer it counts with lives here, per device and stream.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.combine import combine_attention

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ROWS_PER_UNIT = 16  # q rows of a unit (one mma row tile)
TILE_KEYS = 128  # keys per tile of the kernel's ring
MIN_SPLIT_KEYS = 256  # the least keys a chunk holds (unless chunks would be fewer than units)
MAX_GRID = 512  # the kernel's most CTAs (a unit's pieces are merged in shared memory)


def pack_rows(q: torch.Tensor, hk: int) -> torch.Tensor:
    """``[B, H, Sq, D]`` -> ``[B, Hk, Sq * group, D]``, rows (q position,
    group member)."""
    b, h, sq, d = q.shape
    return q.reshape(b, hk, h // hk, sq, d).transpose(2, 3).reshape(b, hk, -1, d)


def unpack_rows(o: torch.Tensor, lse: torch.Tensor, h: int, sq: int):
    """Inverse of :func:`pack_rows` for the output ``[B, Hk, R, D]`` and
    lse ``[B, Hk, R]``: ``[B, H, Sq, D]`` and ``[B, H, Sq]``."""
    b, hk, _, d = o.shape
    group = h // hk
    o = o.reshape(b, hk, sq, group, d).transpose(2, 3).reshape(b, h, sq, d)
    lse = lse.reshape(b, hk, sq, group).transpose(2, 3).reshape(b, h, sq)
    return o, lse


def _partial(s, valid, vf):
    """(out fp32, lse) of log2-space scores ``s`` over the keys of one
    split; a row with no valid key gives out 0 and lse -inf."""
    s = s.masked_fill(~valid, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    out = torch.matmul(p, vf) / torch.where(live, l, 1.0)
    lse = torch.where(live, m * LN2 + torch.log(l), -torch.inf)[..., 0]
    return out, lse


def split_plan(
    bound: torch.Tensor,
    low: Optional[torch.Tensor],
    rows: int,
    group: int,
    causal: bool,
    capacity: int,
    kv_heads: int,
    keys_per_tile: int,
    grid: int,
    min_tiles: int = 1,
) -> List[Tuple[int, int, int, List[Tuple[int, int]]]]:
    """The kernel's split of the work: per unit (b, kv head, 16-row tile),
    in the kernel's order, the key ranges ``[k0, k1)`` of its pieces (one
    per chunk it meets; none for a unit with no key). Units' tiles are laid
    end to end (pair (b, row tile) by pair, the heads of a pair in turn)
    and cut into ``G`` equal chunks, chunk ``c`` holding tiles ``[c T / G,
    (c + 1) T / G)``: ``G`` is ``grid`` rounded down to a whole multiple of
    the units (``grid`` itself when the units are more), at least the units
    and at least ``min_tiles`` tiles a chunk."""
    bound = [int(x) for x in bound.tolist()]
    low = [0] * len(bound) if low is None else [max(int(x), 0) for x in low.tolist()]
    kt = keys_per_tile
    rtiles = -(-rows // ROWS_PER_UNIT)
    units, starts, total = [], [], 0
    for b, (bd, lo) in enumerate(zip(bound, low)):
        for rt in range(rtiles):
            last = min(rows, (rt + 1) * ROWS_PER_UNIT) - 1
            hi = min(bd - rows // group + 1 + last // group if causal else bd, capacity)
            n = -(-hi // kt) - lo // kt if hi > lo else 0
            for h in range(kv_heads):
                units.append((b, h, rt, lo, hi, n))
                starts.append(total)
                total += n
    n_units = len(units)
    chunks = min(grid if n_units > grid else n_units * (grid // n_units),
                 max(n_units, total // max(min_tiles, 1)))
    edges = [c * total // chunks for c in range(chunks + 1)]
    plan = []
    for (b, h, rt, lo, hi, n), x0 in zip(units, starts):
        pieces = []
        for c in range(chunks):
            a, z = max(edges[c], x0), min(edges[c + 1], x0 + n)
            if a < z:
                t0 = lo // kt + a - x0
                pieces.append((max(t0 * kt, lo), min((t0 + z - a) * kt, hi)))
        plan.append((b, h, rt, pieces))
    return plan


def decode_plain(
    qp: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bound: torch.Tensor,
    low: Optional[torch.Tensor],
    group: int,
    causal: bool,
    scale: float,
    softcap: float = 0.0,
    num_splits: int = 1,
    grid: Optional[int] = None,
    keys_per_tile: int = TILE_KEYS,
    min_tiles: int = 1,
):
    """Plain PyTorch version of the kernel on dense ``[B, Hk, S, D]`` K/V
    (any strides; int8 values as they are): fp32 scores in log2 space,
    exact softmax. With ``grid`` (or ``num_splits`` n > 1: a grid of n CTAs
    per unit, as the kernel sizes it) the keys are cut into the kernel's
    own pieces (:func:`split_plan` with ``keys_per_tile``, ``grid`` and
    ``min_tiles``), whose partials merge through
    :func:`~liteattention_torch.ops.combine.combine_attention`, the plain
    version of the kernel's merge. Returns (out ``[B, Hk, R, D]`` in
    ``qp``'s dtype, lse fp32 ``[B, Hk, R]``)."""
    b, hk, rows, _ = qp.shape
    s_len = k.shape[2]
    s = torch.matmul(qp.float(), k.float().transpose(-1, -2))
    if softcap > 0.0:
        s = softcap * torch.tanh(s * (scale / softcap)) * LOG2E
    else:
        s = s * (scale * LOG2E)
    dev = qp.device
    col = torch.arange(s_len, device=dev)
    lim = bound.to(dev).long()[:, None]  # [B, 1]
    if causal:
        qi = torch.arange(rows, device=dev) // group
        lim = lim - rows // group + 1 + qi[None, :]  # [B, R]
    valid = col < lim[..., None]
    if low is not None:
        valid = valid & (col >= low.to(dev).long()[:, None, None])
    valid = valid[:, None].expand(b, hk, rows, s_len)  # over the KV heads
    vf = v.float()
    if grid is None and num_splits > 1:
        grid = num_splits * b * hk * -(-rows // ROWS_PER_UNIT)
    if grid is None:
        out, lse = _partial(s, valid, vf)
        return out.to(qp.dtype), lse
    return _plan_plain(s, valid, vf, qp.dtype, split_plan(
        bound, low, rows, group, causal, s_len, hk, keys_per_tile, grid, min_tiles))


def _plan_plain(s, valid, vf, dtype, plan):
    """decode_plain over the pieces of ``plan``, unit by unit."""
    b, hk, rows, _ = s.shape
    out = torch.zeros((b, hk, rows, vf.shape[-1]), device=s.device)
    lse = torch.full((b, hk, rows), -math.inf, device=s.device)
    for bi, h, rt, pieces in plan:
        r = slice(rt * ROWS_PER_UNIT, (rt + 1) * ROWS_PER_UNIT)
        parts = [_partial(s[bi, h, r, k0:k1], valid[bi, h, r, k0:k1], vf[bi, h, k0:k1])
                 for k0, k1 in pieces]
        if parts:
            o, l = combine_attention(torch.stack([o for o, _ in parts]),
                                     torch.stack([l for _, l in parts]))
            out[bi, h, r], lse[bi, h, r] = o, l
    return out.to(dtype), lse


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Per (device, stream): the tickets (int32, zero between launches: the
# kernel puts each back) and the pieces' scratch of the last launch's size.
_WORKSPACE = {}


def _workspace(dev: torch.device, stream: int, units: int, slots: int, d: int):
    key = (dev.index, stream)
    tickets, parts = _WORKSPACE.get(key, (None, None))
    if tickets is None or tickets.numel() < units:
        tickets = torch.zeros(max(units, 1024), dtype=torch.int32, device=dev)
    need = slots * ROWS_PER_UNIT * (d + 1)
    if parts is None or parts.numel() < need:
        parts = torch.empty(need, dtype=torch.float32, device=dev)
    _WORKSPACE[key] = (tickets, parts)
    n_o = slots * ROWS_PER_UNIT * d
    return tickets, parts[:n_o], parts[n_o:need]


def _map_dims(sizes: Sequence[int], strides: Sequence[int]):
    """The cache's (page, slot, head) dims as the kernel's tensor map takes
    them: sizes and element strides in increasing stride (a dim of size 1
    last, given a stride past the others), and where slot, head and page
    sit among them (2 bits each, dims 1-3)."""
    kinds = sorted(range(3), key=lambda i: (sizes[i] == 1, strides[i]))
    span = max(sz * st for sz, st in zip(sizes, strides))
    st = [strides[i] if sizes[i] > 1 else span for i in kinds]
    pos = {kind: n + 1 for n, kind in enumerate(kinds)}
    return [sizes[i] for i in kinds], st, pos[1] | pos[2] << 2 | pos[0] << 4


def launch_decode(
    qp: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_sizes: Sequence[int],
    k_strides: Sequence[int],
    v_strides: Sequence[int],
    bound: torch.Tensor,
    low: Optional[torch.Tensor],
    *,
    group: int,
    causal: bool,
    scale: float,
    softcap: float,
    num_splits: int,
    capacity: int,
    table: Optional[torch.Tensor] = None,
    page_size: int = 0,
):
    """Launch the kernel on packed rows ``qp`` ``[B, Hk, R, D]`` (bf16)
    against the cache at ``k``/``v``, whose (page or batch, slot or
    position, head) dims have sizes ``k_sizes`` and element strides
    ``k_strides`` / ``v_strides``, with a unit channel stride. With
    ``num_splits`` 0 or 1 the grid is one CTA per SM, and the work is cut
    into as many chunks as whole multiples of the units fit (at least one
    chunk per unit, chunks of at least ``MIN_SPLIT_KEYS`` keys);
    ``num_splits`` n > 1 sizes the grid at n CTAs per unit (at most
    ``MAX_GRID``), chunks of one tile or more. Adds no host sync. Returns (out bf16
    ``[B, Hk, R, D]``, lse fp32 ``[B, Hk, R]``)."""
    dev = qp.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if qp.dtype != torch.bfloat16:
        raise TypeError("the decode kernel takes bf16 q")
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise TypeError("the decode kernel takes bf16 or int8 caches (k and v alike)")
    b, hk, rows, d = qp.shape
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not built (64 or 128; 80 and 96 are ROADMAP B-iii 2, "
                         "GPT-J's 256 B-iii 3)")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the caches need a unit channel stride")
    el = k.element_size()
    kt = TILE_KEYS
    if capacity // kt >= 1 << 16:
        raise ValueError(f"a cache of {capacity} keys: the kernel counts a unit's tiles in 16 bits")
    if page_size and math.gcd(page_size, kt) < 8:
        raise ValueError(f"pages of {page_size} keys: the kernel's TMA boxes need a multiple of 8")
    k_n, k_st, k_dims = _map_dims(k_sizes, k_strides)
    v_n, v_st, v_dims = _map_dims(k_sizes, v_strides)
    if any(x * el % 16 for x in (*k_st, *v_st)) or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("TMA needs 16-byte aligned cache bases and strides")
    qp = qp.contiguous()
    _build.check_aligned(qp)
    i32 = dict(device=dev, dtype=torch.int32)
    bound = bound.to(**i32).contiguous()
    low = None if low is None else low.to(**i32).contiguous()
    table = None if table is None else table.to(**i32).contiguous()
    units = b * hk * -(-rows // ROWS_PER_UNIT)
    if num_splits > 1:
        grid, min_tiles = min(num_splits * units, MAX_GRID), 1
    else:
        grid, min_tiles = _sm_count(dev.index), max(1, MIN_SPLIT_KEYS // kt)  # one CTA per SM
    stream = _build.stream(dev)
    tickets, o_part, lse_part = _workspace(dev, stream, units, units + grid, d)
    out = torch.empty_like(qp)
    lse = torch.empty((b, hk, rows), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = _build.load_kernels().lite_flash_decode(
        qp.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(table), bound.data_ptr(),
        ptr(low), out.data_ptr(), lse.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(),
        tickets.data_ptr(), *k_n, *k_st, k_dims, *v_n, *v_st, v_dims,
        b, hk, rows, group, d, capacity,
        0 if table is None else table.shape[1], page_size, int(k_sizes[0]),
        int(causal), 1 - rows // group, grid, min_tiles, int(k.dtype == torch.int8),
        float(scale), float(softcap), dev.index, stream,
    )
    _build.check(err, "flash_decode")
    return out, lse


__all__ = [
    "decode_plain",
    "launch_decode",
    "pack_rows",
    "split_plan",
    "unpack_rows",
]
