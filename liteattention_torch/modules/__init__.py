"""Transformer building blocks (counterpart of ``liteattention_tpu/modules``)."""

from liteattention_torch.modules.block import Block
from liteattention_torch.modules.dense import Dense
from liteattention_torch.modules.mha import MHA
from liteattention_torch.modules.mlp import GatedMlp, Mlp

__all__ = ["Block", "Dense", "GatedMlp", "MHA", "Mlp"]
