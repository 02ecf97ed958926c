"""Metrics sinks for the trainer (counterpart of
``liteattention_tpu/training/logging.py``; reference: the Lightning
W&B/CSV loggers wired by training/src/train.py + configs/logger/*).

No external service in this environment, so the durable equivalent is a
JSONL stream: one JSON object per log record, append-only, flushed per
write (crash-safe up to the last record; resume appends -- matching the
reference's wandb resume-by-id behavior at the file level). Use as the
``log_fn`` of :meth:`liteattention_torch.training.trainer.Trainer.fit`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


class JsonlLogger:
    """Append-only JSONL metrics writer.

    >>> logger = JsonlLogger("runs/exp1/metrics.jsonl")
    >>> trainer.fit(state, batches, steps, log_fn=logger)
    >>> logger.close()
    """

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def __call__(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a metrics file back (tolerates a truncated final line from a
    crash mid-write)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return out


class TeeLogger:
    """Fan a record out to several sinks (e.g. JSONL + print)."""

    def __init__(self, *sinks, printer: Optional[bool] = False):
        self.sinks = list(sinks)
        if printer:
            self.sinks.append(lambda r: print(json.dumps(r, default=float)))

    def __call__(self, record: Dict[str, Any]) -> None:
        for s in self.sinks:
            s(record)


__all__ = ["JsonlLogger", "TeeLogger", "read_jsonl"]
