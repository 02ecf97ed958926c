"""Schedule packer: fine skip mask -> compacted gather schedule (kernel B2).

Counterpart of ``liteattention_tpu/ops/schedule_pack.py:pack_schedule``.

Kernel: ``csrc/schedule_pack.cu``, replacing the Pallas kernel
``liteattention_tpu/ops/schedule_pack.py:_pack_kernel``. One warp per
(b, h, q-tile) mask row reads the row with 16-byte loads, gives each lane
its output offset by a popcount and a warp scan, lists the live tiles in
shared memory and writes the whole row from there with 16-byte stores.
What bounds it on the H100: memory, 5 bytes a tile (9 with ``kv_map``),
~4 us at [1, 40, 256, 256]; a call's host side (allocations, the ctypes
launch) takes longer than that, so the wrapper does as little as it can.
On Hopper one CTA owns one fine q-row (``qsubs = 1``), so only the index
list and the count are needed: the TPU wire format (qbits, step flags,
128-lane rows) is not carried over.

Output contract (``compact_mask_gather(mask, 1)[:2]``): ``fidx`` lists
the live k-tile indices in increasing order and repeats the last one in
the tail; ``count = max(live, 1)``; a row with no live tile lists tile 0.

With ``kv_map`` (:func:`~liteattention_torch.ops.kv_compact.kv_union_map`)
the packer also returns ``cidx = kv_map[fidx]``, each entry's position in
the union-compacted K/V buffer (0 throughout for a row with no live tile).
JAX's packer writes these compact positions in place of the fine indices
and hands ``kv_map`` to its vote decode; the port keeps both lists, so the
kernel loads at ``cidx`` and votes at ``fidx``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.mask import compact_mask


def _compact_positions(kv_map, fidx, count_live):
    b, h, qt, kt = fidx.shape
    group = h // kv_map.shape[1]
    rows = kv_map.repeat_interleave(group, dim=1)[:, :, None].expand(b, h, qt, kt)
    cidx = torch.gather(rows, -1, fidx.long())
    return torch.where(count_live[..., None] > 0, cidx, 0).int()


def pack_schedule_plain(do_mask: torch.Tensor, kv_map: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel (stable argsort compaction)."""
    fidx, count = compact_mask(do_mask)
    if kv_map is None:
        return fidx, count
    return fidx, count, _compact_positions(kv_map, fidx, do_mask.sum(-1))


def pack_schedule(
    do_mask: torch.Tensor, kv_map: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, ...]:
    """Fine mask bool ``[B, H, Qt, Kt]`` -> (fidx int32 ``[B, H, Qt, Kt]``,
    count int32 ``[B, H, Qt]``), and with ``kv_map`` int32 ``[B, Hk, Kt]``
    also cidx int32 ``[B, H, Qt, Kt]``."""
    if do_mask.dim() != 4 or do_mask.dtype != torch.bool:
        raise ValueError("do_mask must be a bool [B, H, Qt, Kt] tensor")
    b, h, qt, kt = do_mask.shape
    if kv_map is not None:
        if (kv_map.dim() != 3 or kv_map.shape[0] != b or kv_map.shape[2] != kt
                or h % kv_map.shape[1]):
            raise ValueError(f"kv_map {tuple(kv_map.shape)} does not match the mask")
    if do_mask.device.type == "cpu":
        return pack_schedule_plain(do_mask, kv_map)
    if do_mask.device.type != "cuda":
        raise ValueError(f"no kernel for device {do_mask.device}")
    mask = do_mask.contiguous()
    dev = mask.device.index
    fidx = torch.empty((b, h, qt, kt), dtype=torch.int32, device=mask.device)
    count = torch.empty((b, h, qt), dtype=torch.int32, device=mask.device)
    cidx = kmap = None
    rows_per_kv = qt
    if kv_map is not None:
        if kv_map.dtype != torch.int32:
            raise TypeError("kv_map must be int32")
        kmap = kv_map.contiguous()
        cidx = torch.empty_like(fidx)
        rows_per_kv = qt * (h // kv_map.shape[1])
    err = _build.load_kernels().lite_pack_schedule(
        mask.data_ptr(), fidx.data_ptr(), count.data_ptr(),
        None if kmap is None else kmap.data_ptr(),
        None if cidx is None else cidx.data_ptr(), b * h * qt, kt, rows_per_kv,
        dev, _build.stream(mask.device),
    )
    _build.check(err, "schedule_pack")
    pack_schedule.launches += 1
    return (fidx, count) if cidx is None else (fidx, count, cidx)


def noop_launch(device: torch.device) -> None:
    """Launch an empty kernel on ``device`` (with its index) through the
    same ctypes path as :func:`pack_schedule`: what a launch costs, timed
    by ``chip_smoke.py`` beside B2's call."""
    _build.check(_build.load_kernels().lite_noop(_build.stream(device)), "noop")


pack_schedule.launches = 0

__all__ = ["pack_schedule", "pack_schedule_plain"]
