"""Losses (counterpart of ``liteattention_tpu/losses``)."""

from liteattention_torch.losses.cross_entropy import (
    cross_entropy_loss,
    parallel_cross_entropy_loss,
)

__all__ = ["cross_entropy_loss", "parallel_cross_entropy_loss"]
