"""Core attention ops: Hopper kernels (with their plain versions), mask
state and oracle."""

from liteattention_torch.ops.attention_ref import (
    attention_ref,
    skip_votes_ref_gather,
)
from liteattention_torch.ops.combine import combine_attention
from liteattention_torch.ops.flash_bwd import flash_attention_bwd
from liteattention_torch.ops.flash_fwd import (
    flash_attention,
    flash_attention_decode,
    flash_attention_masked,
)
from liteattention_torch.ops.kv_compact import compact_kv, kv_union_map
from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
from liteattention_torch.ops.mask import (
    SkipMaskState,
    compact_mask,
    compact_mask_fine,
    compact_mask_gather,
    init_mask,
    must_do_mask,
    sparsity,
    update_mask,
)
from liteattention_torch.ops.mla import mla_decode
from liteattention_torch.ops.paged_attention import paged_attention
from liteattention_torch.ops.schedule_pack import pack_schedule
from liteattention_torch.ops.tile_sizes import BlockSizes, get_block_sizes

__all__ = [
    "compact_kv",
    "kv_union_map",
    "pack_schedule",
    "attention_ref",
    "skip_votes_ref_gather",
    "flash_attention",
    "flash_attention_masked",
    "flash_attention_decode",
    "flash_attention_bwd",
    "paged_attention",
    "combine_attention",
    "lite_flash_attention",
    "mla_decode",
    "SkipMaskState",
    "compact_mask",
    "compact_mask_fine",
    "compact_mask_gather",
    "init_mask",
    "must_do_mask",
    "sparsity",
    "update_mask",
    "BlockSizes",
    "get_block_sizes",
]
