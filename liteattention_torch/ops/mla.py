"""Absorbed MLA (multi-head latent attention) decode (kernel B10).

Counterpart of ``liteattention_tpu/ops/mla.py:mla_decode`` (same
arguments). DeepSeek-style MLA decodes against one LATENT row per token
of ``D`` channels (kv_lora_rank + rope dims, 512 + 64 = 576): after weight
absorption K is the whole latent row and V its first ``Dv`` channels, and
every q head shares the one latent head.

Kernel: ``csrc/mla_decode.cu``, replacing the Pallas kernel
``liteattention_tpu/ops/mla.py:_mla_kernel``. One CTA per 64 q rows of a
chunk of the keys: two wgmma warpgroups (S computed once, P handed from
one to the other through shared memory), 64-key tiles loaded once by TMA
through the cache's own strides, feeding both QK^T (all D channels) and PV
(the first Dv). The work is cut on the device, with no host sync: the
requests' 64-key tiles laid end to end are cut into equal chunks, one CTA
per chunk and row block (:func:`split_plan` is the same cut in Python),
and the last piece of a split request merges the pieces inside the same
launch (:func:`~liteattention_torch.ops.combine.combine_attention` is the
plain version of that merge). What
bounds it on the H100: bytes at ~242 FLOP per cache byte at 128 heads,
with the tensor cores close behind (see the source's header).

The TPU kernel's 128-lane padding of the cache, its identity page table
for a contiguous cache and its multi-page DMA runs (``pages_per_step``)
are TPU machinery: the kernel reads the cache in place through its
strides, and ``pages_per_step`` and ``interpret`` are accepted and
ignored. The wrapper runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors (bf16, D 576, Dv 512); on the card any other
dtype or shape raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.flash_decode import _partial, _sm_count

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MIN_LANES = 128
MAX_ROWS = 128  # Sq * Hq, the JAX kernel's limit
KERNEL_D, KERNEL_DV = 576, 512  # the shape the kernel is built for
TILE_KEYS = 64  # keys per ring stage; a piece is a whole number of tiles
ROWS_PER_CTA = 64  # q rows of a row block
MIN_SPLIT_TILES = 8  # the least tiles a chunk holds (512 keys), unless there are fewer


@dataclasses.dataclass
class _Call:
    """The arguments of one call, checked and laid out as the kernel and
    the plain version read them."""

    q_rows: torch.Tensor  # [B, R, D], r = qi * Hq + h
    kv: torch.Tensor  # [B, S, D'] contiguous or [P, page_size, D'] pages
    lens: torch.Tensor  # [B]
    table: Optional[torch.Tensor]  # [B, pages_per_seq] or None
    b: int
    sq: int
    hq: int
    d: int
    dv: int
    scale: float
    causal: bool
    decode_rank: bool

    @property
    def capacity(self) -> int:
        """Key positions a request can hold."""
        if self.table is None:
            return self.kv.shape[1]
        return self.table.shape[1] * self.kv.shape[1]


def _prepare(q, kv_cache, cache_seqlens, head_dim_v, page_table, scale, causal) -> _Call:
    decode_rank = q.dim() == 3
    if decode_rank:
        q = q[:, None]
    if q.dim() != 4:
        raise ValueError(f"q must be [B, Sq, Hq, D] or [B, Hq, D], got {tuple(q.shape)}")
    b, sq, hq, d = q.shape
    if kv_cache.dim() == 4:
        if kv_cache.shape[2] != 1:
            raise ValueError("the MLA latent cache has one KV head")
        kv_cache = kv_cache[:, :, 0]
    if kv_cache.dim() != 3:
        raise ValueError(f"kv_cache must be [N, S, D] or [N, S, 1, D], got {tuple(kv_cache.shape)}")
    dv = int(head_dim_v)
    if dv % MIN_LANES or dv > d:
        raise ValueError(f"head_dim_v {dv} must be a multiple of {MIN_LANES} and at most D {d}")
    if kv_cache.shape[-1] < d:
        raise ValueError(f"kv_cache rows ({kv_cache.shape[-1]}) are narrower than q ({d})")
    rows = sq * hq
    if rows > MAX_ROWS:
        raise ValueError(f"Sq*Hq = {rows} > {MAX_ROWS} (decode kernel)")
    if page_table is None and kv_cache.shape[0] != b:
        raise ValueError("a contiguous cache needs one row of keys per request")
    if page_table is not None and page_table.shape[0] != b:
        raise ValueError("page_table needs one row per request")
    if scale is None:
        scale = 1.0 / (d**0.5)
    return _Call(q.reshape(b, rows, d), kv_cache, cache_seqlens, page_table, b, sq, hq, d,
                 dv, float(scale), bool(causal), decode_rank)


def _finish(c: _Call, out: torch.Tensor, lse: torch.Tensor, return_lse: bool):
    """``[B, R, Dv]`` / ``[B, R]`` -> JAX's output layout."""
    out = out.reshape(c.b, c.sq, c.hq, c.dv)
    if c.decode_rank:
        out = out[:, 0]
    if not return_lse:
        return out
    return out, lse.reshape(c.b, c.sq, c.hq).transpose(1, 2)  # [B, Hq, Sq]


def _plain(c: _Call):
    """fp32 scores in log2 space and an exact softmax over each request's
    keys (gathered through the page table). Returns (out ``[B, R, Dv]`` in
    q's dtype, lse fp32 ``[B, R]``)."""
    dev = c.q_rows.device
    if c.table is None:
        keys = c.kv[:, :, : c.d]
    else:
        keys = c.kv[c.table.to(dev).long()].reshape(c.b, -1, c.kv.shape[-1])[..., : c.d]
    kf = keys.float()
    s = torch.matmul(c.q_rows.float(), kf.transpose(1, 2)) * (c.scale * LOG2E)
    col = torch.arange(kf.shape[1], device=dev)
    lim = c.lens.to(dev).long()[:, None]  # [B, 1]
    if c.causal and c.sq > 1:
        qi = torch.arange(c.sq * c.hq, device=dev) // c.hq
        lim = lim - c.sq + 1 + qi[None, :]  # [B, R]
    valid = (col < lim[..., None]).expand(s.shape)
    out, lse = _partial(s, valid, kf[..., : c.dv])
    return out.to(c.q_rows.dtype), lse


def split_plan(
    lens: torch.Tensor, capacity: int, rows: int, sms: int, min_tiles: int = MIN_SPLIT_TILES
) -> List[List[Tuple[int, int]]]:
    """The kernel's split of the work: per request, the key ranges ``[k0,
    k1)`` of its pieces in order (none for a request with no key; every
    row block of a request has the same pieces). Each request's
    ``TILE_KEYS``-key tiles (``ceil(min(len, capacity) / 64)`` of them)
    are laid end to end, request by request, and cut into ``C`` equal
    chunks, chunk ``c`` holding tiles ``[c T / C, (c + 1) T / C)``: ``C``
    is the grid's width, ``sms`` over the row blocks, and fewer where a
    chunk would hold under ``min_tiles`` tiles. It depends on the lengths,
    the rows and the SM count only, never on the cache's form."""
    lens = [min(max(int(x), 0), capacity) for x in lens.tolist()]
    tiles = [-(-n // TILE_KEYS) for n in lens]
    grid = max(1, sms // -(-rows // ROWS_PER_CTA))
    total = sum(tiles)
    chunks = min(grid, max(1, total // min_tiles))
    edges = [c * total // chunks for c in range(chunks + 1)]
    plan, x0 = [], 0
    for n, length in zip(tiles, lens):
        pieces = []
        for c in range(chunks):
            a, z = max(edges[c], x0), min(edges[c + 1], x0 + n)
            if a < z:
                pieces.append(((a - x0) * TILE_KEYS, min((z - x0) * TILE_KEYS, length)))
        plan.append(pieces)
        x0 += n
    return plan


# Per (device, stream): the tickets (int32, zero between launches: the
# kernel puts each back) and the pieces' scratch of the last launch's size.
_WORKSPACE = {}


def _workspace(dev: torch.device, stream: int, tickets_n: int, slots: int):
    key = (dev.index, stream)
    tickets, parts = _WORKSPACE.get(key, (None, None))
    if tickets is None or tickets.numel() < tickets_n:
        tickets = torch.zeros(max(tickets_n, 1024), dtype=torch.int32, device=dev)
    need = slots * ROWS_PER_CTA * (KERNEL_DV + 1)
    if parts is None or parts.numel() < need:
        parts = torch.empty(need, dtype=torch.float32, device=dev)
    _WORKSPACE[key] = (tickets, parts)
    n_o = slots * ROWS_PER_CTA * KERNEL_DV
    return tickets, parts[:n_o], parts[n_o:need]


def _launch(c: _Call):
    q, kv = c.q_rows, c.kv
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16:
        raise TypeError(f"mla_decode: the kernel takes bf16 q and cache, got {q.dtype} / {kv.dtype}")
    if (c.d, c.dv) != (KERNEL_D, KERNEL_DV):
        raise ValueError(
            f"mla_decode: the kernel is built for D {KERNEL_D} / Dv {KERNEL_DV} "
            f"(DeepSeek's absorbed shape), got D {c.d} / Dv {c.dv}"
        )
    if kv.stride(-1) != 1 or any(s % 8 for s in kv.stride()[:2]):
        raise ValueError("mla_decode: cache rows need a unit channel stride and 16-byte starts")
    if kv.device != dev:
        raise ValueError("q and the cache must be on one device")
    q = q.contiguous()
    _build.check_aligned(q, kv)
    i32 = dict(device=dev, dtype=torch.int32)
    lens = c.lens.to(**i32).contiguous()
    table = None if c.table is None else c.table.to(**i32).contiguous()
    rows = c.sq * c.hq
    grid = max(1, _sm_count(dev.index) // -(-rows // ROWS_PER_CTA))  # one CTA per SM
    stream = _build.stream(dev)
    row_blocks = -(-rows // ROWS_PER_CTA)
    tickets, o_part, lse_part = _workspace(dev, stream, row_blocks * c.b, row_blocks * grid * 2)
    out = torch.empty((c.b, rows, c.dv), dtype=q.dtype, device=dev)
    lse = torch.empty((c.b, rows), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = _build.load_kernels().lite_mla_decode(
        q.data_ptr(), kv.data_ptr(), ptr(table), lens.data_ptr(), out.data_ptr(),
        lse.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(), tickets.data_ptr(),
        kv.stride(0), kv.stride(1), kv.shape[0], kv.shape[1],
        c.b, rows, c.hq, c.sq, c.d, c.dv, c.capacity,
        0 if table is None else table.shape[1], kv.shape[1] if table is not None else 0,
        int(c.causal), grid, MIN_SPLIT_TILES, c.scale, dev.index, stream,
    )
    _build.check(err, "mla_decode")
    mla_decode.launches += 1
    return out, lse


def mla_decode(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    cache_seqlens: torch.Tensor,
    head_dim_v: int,
    page_table: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = True,
    return_lse: bool = False,
    interpret: Optional[bool] = None,
    pages_per_step: Optional[int] = None,
):
    """Absorbed-MLA decode over one latent cache (kernel B10).

    Args:
      q: ``[B, Sq, Hq, D]`` (or ``[B, Hq, D]`` single-token) queries in
        the absorbed latent space; ``Sq * Hq`` must be at most 128.
      kv_cache: the latent cache, contiguous ``[B, S, D']`` / ``[B, S, 1,
        D']`` or paged ``[num_pages, page_size, D']`` / ``[..., 1, D']``
        with ``page_table [B, pages_per_seq]``, ``D' >= D``. K is the row's
        first D channels, V its first ``head_dim_v``; a wider row (the
        TPU's 640-lane layout) is read through its stride and its extra
        lanes are never read.
      cache_seqlens: ``[B]`` int valid lengths.
      head_dim_v: V's channels (kv_lora_rank), a multiple of 128, <= D.
      scale: softmax scale (default ``1/sqrt(D)``).
      causal: bottom-right-aligned causality for ``Sq > 1`` (row ``qi``
        sees keys ``< len - Sq + qi + 1``).
      interpret, pages_per_step: TPU knobs, accepted and ignored.

    Returns ``out [B, Sq, Hq, head_dim_v]`` (``[B, Hq, head_dim_v]`` for a
    rank-3 q) in q's dtype, plus natural-log lse ``[B, Hq, Sq]`` fp32 with
    ``return_lse``. A row with no valid key gives out 0 and lse -inf.
    """
    del interpret, pages_per_step
    c = _prepare(q, kv_cache, cache_seqlens, head_dim_v, page_table, scale, causal)
    if c.q_rows.device.type == "cpu":
        out, lse = _plain(c)
    else:
        out, lse = _launch(c)
    return _finish(c, out, lse, return_lse)


def mla_decode_plain(
    q, kv_cache, cache_seqlens, head_dim_v, page_table=None, scale=None, causal=True,
    return_lse=False, interpret=None, pages_per_step=None,
):
    """Plain PyTorch version of :func:`mla_decode` on any device: fp32
    scores, exact softmax (same arguments; the TPU knobs do not change the
    result)."""
    del interpret, pages_per_step
    c = _prepare(q, kv_cache, cache_seqlens, head_dim_v, page_table, scale, causal)
    out, lse = _plain(c)
    return _finish(c, out, lse, return_lse)


mla_decode.launches = 0

__all__ = ["mla_decode", "mla_decode_plain", "split_plan"]
