"""Data sampling with fault-tolerant resume.

Counterpart of ``liteattention_tpu/training/data.py``, numpy only: the
same seed gives the same numbers. It mirrors the reference's samplers
(reference training/src/datamodules/fault_tolerant_sampler.py:9-60:
``RandomFaultTolerantSampler`` / ``FaultTolerantDistributedSampler``
checkpoint the sampler RNG and consumed-batch counter so a resumed run
continues the epoch exactly where it crashed).

Here the sampler is a deterministic function of (seed, epoch, counter),
so its "state" is two integers and resume is exact by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class FaultTolerantSampler:
    """Shuffled index sampler whose full state is (seed, epoch, counter).

    ``state_dict``/``load_state_dict`` mirror the reference's surface
    (fault_tolerant_sampler.py:21-36). ``shard``/``num_shards`` cover the
    distributed variant (each data-parallel worker takes a strided
    slice, as ``FaultTolerantDistributedSampler`` does).
    """

    num_samples: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    epoch: int = 0
    counter: int = 0

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "counter": self.counter,
                "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.counter = int(state["counter"])
        self.seed = int(state.get("seed", self.seed))

    def _perm(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(self.num_samples)

    def __iter__(self) -> Iterator[int]:
        while True:
            perm = self._perm()[self.shard :: self.num_shards]
            while self.counter < len(perm):
                idx = int(perm[self.counter])
                self.counter += 1
                yield idx
            self.epoch += 1
            self.counter = 0

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        it = iter(self)
        while True:
            yield np.asarray([next(it) for _ in range(batch_size)])


def synthetic_lm_batches(
    vocab_size: int,
    batch_size: int,
    seqlen: int,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Deterministic synthetic token stream for harness tests/benchmarks
    (fills the role of the reference's datamodules when no corpus is
    mounted)."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(
            0, vocab_size, size=(batch_size, seqlen), dtype=np.int32
        )


class LMDataset:
    """Chunked language-modeling view over one long token array
    (reference training/src/datamodules/datasets/lm_dataset.py:10-32):
    sequence ``i`` is ``tokens[i*L : i*L + L + 1]`` -- input = ``[:-1]``,
    target = ``[1:]`` (the +1 overlap supplies the next-token labels).
    ``tokens`` may be an ``np.memmap`` (the reference concat-tokenizes
    corpora into a uint16/int32 memmap; only the indexed window is ever
    materialized -- no slicing of the whole array)."""

    def __init__(self, tokens, seq_len: int, drop_last: bool = True):
        self.seq_len = seq_len
        ntokens = len(tokens)
        if drop_last:
            ntokens = ((ntokens - 1) // seq_len) * seq_len + 1
        self.ntokens = ntokens
        self.tokens = tokens
        self.total_sequences = -(-(self.ntokens - 1) // seq_len)

    def __len__(self) -> int:
        return self.total_sequences

    def __getitem__(self, idx: int) -> np.ndarray:
        start = idx * self.seq_len
        n = min(self.seq_len, self.ntokens - 1 - start)
        return np.asarray(
            self.tokens[start : start + n + 1], dtype=np.int32
        )


def memmap_lm_batches(
    tokens,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    sampler: Optional[FaultTolerantSampler] = None,
) -> Iterator[np.ndarray]:
    """Shuffled, resumable LM batch stream over a (memmap) token array:
    ``[B, seq_len + 1]`` int32 batches (feed ``batch[:, :-1]`` /
    ``batch[:, 1:]`` to the loss). Pass a :class:`FaultTolerantSampler`
    to resume mid-epoch after a failure (its ``state_dict`` round-trips
    through the checkpoint)."""
    ds = LMDataset(tokens, seq_len)
    full = (len(ds) - 1) if (ds.ntokens - 1) % seq_len else len(ds)
    if sampler is None:
        sampler = FaultTolerantSampler(num_samples=full, seed=seed)
    while True:
        batch = []
        for idx in sampler:
            batch.append(ds[idx])
            if len(batch) == batch_size:
                yield np.stack(batch)
                batch = []


__all__ = [
    "FaultTolerantSampler",
    "LMDataset",
    "memmap_lm_batches",
    "synthetic_lm_batches",
]
