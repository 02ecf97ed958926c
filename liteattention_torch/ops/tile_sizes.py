"""Attention tile sizes for the Hopper kernels.

Counterpart of ``liteattention_tpu/ops/tile_sizes.py``. That table was
measured on another machine and is not carried over; this one starts
from the geometry the hand-written kernels are built for and will be
re-derived from measurements on the H100.

* Lite (sparse) kernel: one CTA owns one fine 128-row q-tile of the skip
  mask, so ``block_q = 128`` is fixed and each CTA walks its own list of
  live k-tiles (``qsubs = 1``: no union over several fine q-rows).
  ``block_k = 128 * gsize`` sets how many live fine k-tiles form one
  vote step (the running max used by the vote test is refreshed once per
  step); ``gsize = 1`` by default. The coarse and super-tile modes take
  any ``(128 * qsub, 128 * ksub)`` compute tile: its ``qsub`` CTAs walk
  one coarse row.
* Dense kernel: 128 x 128 tiles, the first geometry of the port.

No timing is recorded here yet.
"""

from __future__ import annotations

import dataclasses

VOTE_TILE = 128  # fine (mask / vote) granularity in sequence elements


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile geometry for the flash / lite attention kernels."""

    block_q: int = 128
    block_k: int = 128

    def __post_init__(self):
        if self.block_q % 128 or self.block_k % 128:
            raise ValueError(
                f"block sizes must be multiples of 128, got "
                f"({self.block_q}, {self.block_k})"
            )


def get_block_sizes(
    head_dim: int, dtype_bytes: int = 2, kind: str = "dense"
) -> BlockSizes:
    """Pick (block_q, block_k) for a head dim / element size.

    ``kind`` is ``"dense"`` or ``"lite"``; both start at 128 x 128 on
    Hopper (gsize 1 for the lite kernel). ``head_dim`` and
    ``dtype_bytes`` are accepted for call-site parity with the JAX
    package. The kernels take bf16: B1 and B7 at head dims 64, 80, 96
    and 128 (their channels at 64, 80 and 128), the decode, lite and MLA
    kernels at the dims their modules name.
    """
    del head_dim, dtype_bytes
    if kind not in ("dense", "lite"):
        raise ValueError(f"unknown kernel kind {kind!r}")
    return BlockSizes(128, 128)


__all__ = ["BlockSizes", "VOTE_TILE", "get_block_sizes"]
