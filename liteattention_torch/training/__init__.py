"""Training harness (counterpart of ``liteattention_tpu/training``). The
config tree, metrics and diagnostics are submodules
(``training.config_tree``, ``training.metrics``, ``training.diagnostics``),
not exported here, as in JAX."""

from liteattention_torch.training.data import (
    FaultTolerantSampler,
    LMDataset,
    memmap_lm_batches,
    synthetic_lm_batches,
)
from liteattention_torch.training.logging import JsonlLogger, TeeLogger, read_jsonl
from liteattention_torch.training.trainer import TrainConfig, Trainer, TrainState

__all__ = [
    "FaultTolerantSampler",
    "LMDataset",
    "memmap_lm_batches",
    "synthetic_lm_batches",
    "JsonlLogger",
    "TeeLogger",
    "read_jsonl",
    "TrainConfig",
    "Trainer",
    "TrainState",
]
