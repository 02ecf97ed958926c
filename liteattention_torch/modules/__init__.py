"""Transformer building blocks (counterpart of ``liteattention_tpu/modules``),
the tensor-parallel ``ParallelMHA`` / ``ParallelMLP`` over a
``torch.distributed`` group among them."""

from liteattention_torch.modules.block import Block
from liteattention_torch.modules.dense import Dense
from liteattention_torch.modules.mha import MHA, ParallelMHA
from liteattention_torch.modules.mlp import GatedMlp, Mlp, ParallelMLP
from liteattention_torch.modules.moe import MoEMlp

__all__ = ["Block", "Dense", "GatedMlp", "MHA", "Mlp", "MoEMlp", "ParallelMHA", "ParallelMLP"]
