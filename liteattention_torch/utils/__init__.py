"""Decoding utilities, the checkpoint remaps, benchmarking helpers and the
pad / unpad utilities of variable-length batches (counterpart of
``liteattention_tpu/utils``; ``utils.benchmark``, ``utils.generation`` and
``utils.pretrained`` are submodules)."""

from liteattention_torch.utils.padding import (
    index_first_axis,
    pad_input,
    unpad_input,
)
from liteattention_torch.utils.pretrained import remap_state_dict_hf_gptj

__all__ = ["pad_input", "unpad_input", "index_first_axis", "remap_state_dict_hf_gptj"]
