"""Decoding utilities, the checkpoint remaps and the pad / unpad
utilities of variable-length batches (counterpart of
``liteattention_tpu/utils``)."""

from liteattention_torch.utils.padding import (
    index_first_axis,
    pad_input,
    unpad_input,
)
from liteattention_torch.utils.pretrained import remap_state_dict_hf_gptj

__all__ = ["pad_input", "unpad_input", "index_first_axis", "remap_state_dict_hf_gptj"]
