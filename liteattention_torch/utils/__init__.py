"""Decoding utilities, the Wan checkpoint remap and the pad / unpad
utilities of variable-length batches (counterpart of
``liteattention_tpu/utils``)."""

from liteattention_torch.utils.padding import (
    index_first_axis,
    pad_input,
    unpad_input,
)

__all__ = ["pad_input", "unpad_input", "index_first_axis"]
