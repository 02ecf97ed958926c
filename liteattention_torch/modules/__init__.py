"""Transformer building blocks (counterpart of ``liteattention_tpu/modules``;
the tensor-parallel ``ParallelMHA`` / ``ParallelMLP`` wait for ROADMAP A15)."""

from liteattention_torch.modules.block import Block
from liteattention_torch.modules.dense import Dense
from liteattention_torch.modules.mha import MHA
from liteattention_torch.modules.mlp import GatedMlp, Mlp
from liteattention_torch.modules.moe import MoEMlp

__all__ = ["Block", "Dense", "GatedMlp", "MHA", "Mlp", "MoEMlp"]
