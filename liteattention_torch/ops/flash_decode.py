"""Split-KV decode over a contiguous or paged cache: the core that the
decode wrappers of kernels B8, B9a and B9b share.

Kernel: ``csrc/flash_decode.cu`` (one kernel and its split merge),
replacing the Pallas kernels ``liteattention_tpu/ops/flash_fwd.py:
_decode_folded_kernel`` (B8), ``ops/paged_attention.py:_paged_kernel``
(B9a) and ``_paged_folded_kernel`` (B9b). The wrappers
(:func:`~liteattention_torch.ops.flash_fwd.flash_attention_decode`,
:func:`~liteattention_torch.ops.paged_attention.paged_attention` and
:func:`~liteattention_torch.ops.paged_attention.paged_attention_folded`)
pack the q rows of each KV head as ``[B, Hk, R, D]`` with ``R = sq *
group`` ordered (q position, group member), fold int8 scales, and hand
this module the cache with its (page, slot, head) strides. Row ``r`` is
q position ``r // group``; it sees key ``col`` iff ``low <= col <
bound`` and, when causal, ``col < bound - sq + r // group + 1``
(bottom-right aligned).

What bounds the kernel on the H100 is bytes (see the source's header);
it splits each KV head's key range over enough CTAs to fill the two CTA
slots of every SM and merges the splits in a second small kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.combine import combine_attention

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MIN_SPLIT_KEYS = 256  # the least keys a split gets at full capacity
ROWS_PER_CTA = 16
MAX_SPLITS = 64


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
):
    """Plain PyTorch version of the kernel on dense ``[B, Hk, S, D]`` K/V
    (any strides; int8 values as they are): fp32 scores in log2 space,
    exact softmax. With ``num_splits > 1`` the keys are cut into that
    many equal chunks whose partials merge through
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
    valid = valid[:, None]  # over the KV heads
    vf = v.float()
    n = max(1, num_splits)
    chunk = -(-s_len // n)
    parts = [
        _partial(s[..., i : i + chunk], valid[..., i : i + chunk], vf[:, :, i : i + chunk])
        for i in range(0, s_len, chunk)
    ]
    if len(parts) == 1:
        out, lse = parts[0]
    else:
        out, lse = combine_attention(
            torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts])
        )
    return out.to(qp.dtype), lse


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits_heuristic(ctas: int, capacity: int, device: torch.device) -> int:
    """KV splits so that the grid fills the two CTA slots of every SM in
    one wave (rounded down: a second, partial wave would cost a whole
    CTA's time), with at least ``MIN_SPLIT_KEYS`` keys per split at full
    capacity, at most 64."""
    want = 2 * _sm_count(device.index) // max(ctas, 1)
    most = max(1, capacity // MIN_SPLIT_KEYS)
    return max(1, min(want, most, MAX_SPLITS))


def launch_decode(
    qp: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
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
    against the cache at ``k``/``v`` with element strides (page or batch,
    slot or position, head) and a unit channel stride. ``num_splits`` 0
    or 1 takes the heuristic. Returns (out bf16 ``[B, Hk, R, D]``, lse
    fp32 ``[B, Hk, R]``, whether the merge kernel ran)."""
    dev = qp.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if qp.dtype != torch.bfloat16:
        raise TypeError("the decode kernel takes bf16 q")
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise TypeError("the decode kernel takes bf16 or int8 caches (k and v alike)")
    b, hk, rows, d = qp.shape
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not built (64 or 128)")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the caches need a unit channel stride")
    if any(s * k.element_size() % 16 for s in (*k_strides, *v_strides)):
        raise ValueError("cache rows must start on 16-byte boundaries")
    if b * hk > 65535:
        raise ValueError("batch * kv heads above 65535")
    qp = qp.contiguous()
    _build.check_aligned(qp, k, v)
    i32 = dict(device=dev, dtype=torch.int32)
    bound = bound.to(**i32).contiguous()
    low = None if low is None else low.to(**i32).contiguous()
    table = None if table is None else table.to(**i32).contiguous()
    ctas = b * hk * -(-rows // ROWS_PER_CTA)
    splits = num_splits if num_splits > 1 else num_splits_heuristic(ctas, capacity, dev)
    out = torch.empty_like(qp)
    lse = torch.empty((b, hk, rows), dtype=torch.float32, device=dev)
    o_part = lse_part = None
    if splits > 1:
        o_part = torch.empty((splits, b, hk, rows, d), dtype=torch.float32, device=dev)
        lse_part = torch.empty((splits, b, hk, rows), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = _build.load_kernels().lite_flash_decode(
        qp.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(table), bound.data_ptr(),
        ptr(low), out.data_ptr(), lse.data_ptr(), ptr(o_part), ptr(lse_part),
        *(int(s) for s in k_strides), *(int(s) for s in v_strides),
        b, hk, rows, group, d, capacity,
        0 if table is None else table.shape[1], page_size,
        int(causal), 1 - rows // group, splits, int(k.dtype == torch.int8),
        float(scale), float(softcap), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flash_decode")
    return out, lse, splits > 1


__all__ = [
    "decode_plain",
    "launch_decode",
    "num_splits_heuristic",
    "pack_rows",
    "unpack_rows",
]
