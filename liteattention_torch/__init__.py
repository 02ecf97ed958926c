"""LiteAttention for PyTorch on NVIDIA Hopper.

The port of ``liteattention_tpu`` (JAX + Pallas) to PyTorch with
hand-written CUDA kernels for ``sm_90a``: temporal-sparse flash attention
for video-diffusion DiT inference. Per (batch, head, 128-row q-tile) a
persistent skip mask marks k-tiles whose contribution fell below a
threshold; marked tiles are not loaded or computed on later steps.

Module paths mirror the JAX package. Importing this package builds
nothing: the kernels compile with ``nvcc`` at their first CUDA launch.
"""

__version__ = "0.1.0"

from liteattention_torch import ops
from liteattention_torch.flash_attn_interface import (
    flash_attn_combine,
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    flash_attn_with_kvcache,
    flash_mla_with_kvcache,
)
from liteattention_torch.flash_blocksparse import (
    FlashBlocksparseAttention,
    convert_blockmask,
    flash_blocksparse_attn_func,
)
from liteattention_torch.lite_attention import (
    LiteAttention,
    SeqParallelLiteAttention,
    lite_attention_init,
    lite_attention_step,
)

# The JAX package's public names, all of which the port has (the varlen
# functions since they run on B1's and B7's segment channel).
__all__ = [
    "ops",
    "LiteAttention",
    "SeqParallelLiteAttention",
    "lite_attention_init",
    "lite_attention_step",
    "flash_attn_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_kvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_with_kvcache",
    "flash_mla_with_kvcache",
    "flash_attn_combine",
    "flash_blocksparse_attn_func",
    "FlashBlocksparseAttention",
    "convert_blockmask",
]
