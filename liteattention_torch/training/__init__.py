"""Training harness (counterpart of ``liteattention_tpu/training``)."""

from liteattention_torch.training.data import (
    FaultTolerantSampler,
    LMDataset,
    memmap_lm_batches,
    synthetic_lm_batches,
)
from liteattention_torch.training.logging import JsonlLogger, TeeLogger, read_jsonl
from liteattention_torch.training.trainer import TrainConfig, Trainer

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
]
