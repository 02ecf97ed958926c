"""The counter-based attention-dropout keep mask of the JAX kernels.

Counterpart of ``liteattention_tpu/ops/flash_fwd.py:dropout_keep_mask``
(re-exported from :mod:`liteattention_torch.ops.flash_fwd`, where JAX
defines it). B1 and B7 compute the same hash per score on the card
(``csrc/key_mask.cuh:dropout_keep``); the plain versions of both call
:func:`dropout_keep` here. Torch's CPU ``uint32`` ops are thin, so the
arithmetic runs in int64 masked to 32 bits.
"""

from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """``a * c`` mod 2^32 for ``a`` int64 in [0, 2^32) and ``c`` below 2^32,
    in int64 without overflow (each partial product is below 2^48)."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _U32


def dropout_threshold(dropout_p: float) -> int:
    """The keep test of :func:`dropout_keep_mask` as an integer: a score is
    kept iff ``(x >> 8) >= dropout_threshold(p)``. JAX compares ``u =
    (x >> 8) * 2^-24`` with ``float32(p)`` in fp32, where both sides are
    exact, so the test is ``(x >> 8) >= ceil(float32(p) * 2^24)``."""
    p32 = float(torch.tensor(dropout_p, dtype=torch.float32))
    if not 0.0 <= p32 < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    return math.ceil(p32 * 2.0**24)


def dropout_keep(seed, bh, row: torch.Tensor, col: torch.Tensor, dropout_p: float):
    """:func:`dropout_keep_mask` at broadcastable int64 positions: ``seed``
    and ``bh`` ints or int tensors, ``row`` and ``col`` the global q row and
    key column. No host sync: every value stays on ``row``'s device."""
    def u32(x):
        return torch.as_tensor(x, device=row.device).to(torch.int64) & _U32

    key = (_mul32(u32(seed), 0xCC9E2D51) + _mul32(u32(bh), 0x1B873593)) & _U32
    x = (_mul32(u32(row), 0x9E3779B9) + _mul32(u32(col), 0x85EBCA6B)) & _U32
    x = x ^ key
    x = x ^ (x >> 16)  # murmur3's fmix32
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8) >= dropout_threshold(dropout_p)


def dropout_keep_mask(seed, bh, row0, col0, shape, dropout_p: float, device=None):
    """The counter-based attention-dropout keep mask of the JAX kernels
    (``liteattention_tpu/ops/flash_fwd.py:dropout_keep_mask``), bit for
    bit: a pure function of (``seed``, ``bh`` = b * H + q head, the global
    q row, the global key column), so that the forward and the backward
    regenerate one mask at any tile geometry. A murmur3 fmix32 over ``row
    * 0x9E3779B9 + col * 0x85EBCA6B`` xor ``seed * 0xCC9E2D51 + bh *
    0x1B873593``, every product mod 2^32 (the int32 inputs taken as uint32,
    as JAX casts them); kept iff ``(x >> 8) * 2^-24 >= float32(p)``.

    ``seed`` and ``bh``: ints or int32 scalars (tensors stay on their
    device); ``row0``, ``col0``: the tile's global offsets; ``shape``:
    (rows, cols). Returns a bool ``[rows, cols]`` keep mask on ``device``
    (the seed's, if it is a tensor and ``device`` is None).
    """
    if device is None and torch.is_tensor(seed):
        device = seed.device
    rows, cols = shape
    row = torch.arange(rows, device=device)[:, None] + int(row0)
    col = torch.arange(cols, device=device)[None, :] + int(col0)
    return dropout_keep(seed, bh, row, col, dropout_p)


def dropout_seed_tensor(dropout_seed, device) -> torch.Tensor:
    """The seed as the kernels read it: an int32 ``[1]`` on ``device`` (0
    when None, as JAX defaults it); a tensor is not read on the host."""
    if dropout_seed is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    seed = torch.as_tensor(dropout_seed, device=device)
    if seed.numel() != 1 or seed.is_floating_point():
        raise ValueError("dropout_seed must be one integer")
    return seed.to(torch.int32).reshape(1)


__all__ = ["dropout_keep", "dropout_keep_mask", "dropout_seed_tensor", "dropout_threshold"]
