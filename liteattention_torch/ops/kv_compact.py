"""Union-compacted K/V staging for the gather schedule (kernel B6).

Counterpart of ``liteattention_tpu/ops/kv_compact.py``. The live fine
k-tiles of a mask, united over every q-tile of a (batch, kv-head), are
gathered to the front of a compact K/V buffer; the schedule then names
each entry's tile in that buffer (``pack_schedule(kv_map=...)`` writes
these compact positions as ``cidx`` beside the fine ``fidx``), and the
sparse kernel loads from it. The outputs do not change: the same tiles
are computed, only their addresses move.

Kernel: ``csrc/kv_compact.cu``, replacing the Pallas kernel
``liteattention_tpu/ops/kv_compact.py:_copy_kernel``. Each 128-row tile of
K or V is one contiguous block, so the copy engine moves it: one CTA per
SM walks the flat list of tile copies, one thread issuing bulk copies
global -> shared into a ring of stages and shared -> global out of it;
no byte passes through registers. What bounds it on the H100: memory,
each tile read once and written once. The TPU's K|V lane interleave
(``pack_kv``) is not carried over: K and V stay separate ``[B, Hk, S,
D]`` tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.tile_sizes import VOTE_TILE


def kv_union_map(
    do_mask: torch.Tensor, hk: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(batch, kv-head) union compaction map of a fine skip mask.

    Args:
      do_mask: bool ``[B, H, Qtf, Ktf]`` fine mask (True = compute).
      hk: number of KV heads (a GQA group shares one compact buffer and so
        one map); defaults to H.

    Returns:
      ``(kv_map, inv, count)``: ``kv_map`` int32 ``[B, Hk, Ktf]`` fine tile
      -> compact position, -1 for tiles dead in the union; ``inv`` int32
      ``[B, Hk, Ktf]`` compact position -> fine tile, the dead tiles (in
      order) after the live ones; ``count`` int32 ``[B, Hk]`` live-union
      tiles.
    """
    b, h, _, ktf = do_mask.shape
    hk = hk or h
    u = do_mask.reshape(b, hk, -1, ktf).any(dim=2)
    csum = torch.cumsum(u.int(), dim=-1)
    kv_map = torch.where(u, csum - 1, -1)
    iota = torch.arange(ktf, device=do_mask.device)
    inv = torch.argsort(torch.where(u, iota, ktf + iota), dim=-1)
    return kv_map.int(), inv.int(), csum[..., -1].int()


def _check(k, v, inv):
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError("k and v must be [B, Hk, S, D] of one shape")
    b, hk, s, _ = k.shape
    if s % VOTE_TILE:
        raise ValueError(f"compact_kv needs S % {VOTE_TILE} == 0, got S = {s}")
    if tuple(inv.shape) != (b, hk, s // VOTE_TILE):
        raise ValueError(f"inv {tuple(inv.shape)} does not match K/V {tuple(k.shape)}")


def compact_kv_plain(k: torch.Tensor, v: torch.Tensor, inv: torch.Tensor):
    """Plain PyTorch version of the kernel: an index on the tile view."""
    _check(k, v, inv)
    b, hk, s, d = k.shape
    bi = torch.arange(b, device=k.device)[:, None, None]
    hi = torch.arange(hk, device=k.device)[None, :, None]
    idx = inv.long()

    def gather(x):
        return x.reshape(b, hk, s // VOTE_TILE, VOTE_TILE, d)[bi, hi, idx].reshape(x.shape)

    return gather(k), gather(v)


def compact_kv(
    k: torch.Tensor, v: torch.Tensor, inv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather K and V tiles into union-compact order.

    ``out[:, :, c*128:(c+1)*128] = x[:, :, inv[c]*128:(inv[c]+1)*128]`` for
    ``x`` in (k, v), ``[B, Hk, S, D]`` with ``S % 128 == 0``; ``inv`` from
    :func:`kv_union_map`. Positions past the union count copy dead tiles
    (no schedule entry points there): the outputs keep the full shape.
    """
    if k.device.type == "cpu":
        return compact_kv_plain(k, v, inv)
    if k.device.type != "cuda":
        raise ValueError(f"no kernel for device {k.device}")
    _check(k, v, inv)
    if v.dtype != k.dtype or inv.dtype != torch.int32:
        raise TypeError("k and v must share a dtype; inv must be int32")
    b, hk, s, d = k.shape
    if (d * k.element_size()) % 16:
        raise ValueError("a K/V row must be a multiple of 16 bytes")
    k, v, inv = k.contiguous(), v.contiguous(), inv.contiguous()
    _build.check_aligned(k, v)
    kc, vc = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_kernels()
    err = lib.lite_kv_compact(
        k.data_ptr(), v.data_ptr(), kc.data_ptr(), vc.data_ptr(), inv.data_ptr(),
        b, hk, s // VOTE_TILE, d * k.element_size(), k.device.index,
        _build.stream(k.device),
    )
    _build.check(err, "kv_compact")
    compact_kv.launches += 1
    return kc, vc


compact_kv.launches = 0

__all__ = ["compact_kv", "compact_kv_plain", "kv_union_map"]
