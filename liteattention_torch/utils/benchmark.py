"""Benchmarking helpers.

Counterpart of ``liteattention_tpu/utils/benchmark.py`` (the same names and
returns): ``hard_sync`` waits for a result, ``benchmark_forward`` times a
call, ``benchmark_memory`` reads its peak memory and ``profile_trace``
traces it. On the card a call is timed by CUDA events around it, memory is
``torch.cuda.max_memory_allocated`` and the trace is ``torch.profiler``'s
(CPU and CUDA activity); on the CPU the timer is ``time.perf_counter``.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from typing import Any, Callable, List, Optional, Tuple

import torch


def _tensors(x: Any) -> List[torch.Tensor]:
    """The tensors in a result (nested tuples, lists and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _cuda_device(x: Any) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor in ``x``, if any."""
    for t in _tensors(x):
        if t.is_cuda:
            return t.device
    return None


def hard_sync(x) -> None:
    """Wait until ``x`` (a tensor or a tree of them) is computed: a device
    synchronize where it lies on the card, nothing on the CPU."""
    dev = _cuda_device(x)
    if dev is not None:
        torch.cuda.synchronize(dev)


def benchmark_forward(fn: Callable, *args, repeats: int = 10, warmup: int = 2, desc: str = "",
                      verbose: bool = True, **kwargs) -> Tuple[float, float]:
    """Time ``fn(*args, **kwargs)`` over ``repeats`` calls after ``warmup``
    calls; returns (mean seconds, standard deviation). Each call on the card
    is timed by CUDA events around it (the device's time from its first
    launch to its last, host gaps between launches included); on the CPU by
    ``time.perf_counter`` around the call and its sync."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        hard_sync(out)
    dev = _cuda_device(out) if warmup else _cuda_device((args, kwargs))
    times = []
    for _ in range(repeats):
        if dev is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            hard_sync(fn(*args, **kwargs))
            times.append(time.perf_counter() - t0)
    mean, std = statistics.fmean(times), statistics.pstdev(times)
    if verbose and desc:
        print(f"{desc}: {mean * 1e3:.3f} ms (+/- {std * 1e3:.3f})")
    return mean, std


def benchmark_memory(fn: Callable, *args, desc: str = "", **kwargs) -> float:
    """Peak bytes allocated on the card while ``fn(*args, **kwargs)`` runs
    (the peak statistic is reset first). A call whose result lies on the CPU
    gives 0.0: the CPU keeps no allocator statistics (JAX's CPU devices
    report none either)."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    hard_sync(out)
    dev = _cuda_device(out)
    peak = float(torch.cuda.max_memory_allocated(dev)) if dev is not None else 0.0
    if desc:
        print(f"{desc}: peak {peak / 2**30:.3f} GiB")
    return peak


def profile_trace(fn: Callable, *args, log_dir: Optional[str] = None, **kwargs) -> str:
    """One call of ``fn`` under ``torch.profiler`` (CPU activity, and CUDA
    where a card is present), written as a Chrome trace ``trace.json``
    into ``log_dir`` (default: a new temporary directory); returns
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="torch-trace-")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        hard_sync(fn(*args, **kwargs))
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return log_dir


__all__ = ["benchmark_forward", "benchmark_memory", "profile_trace", "hard_sync"]
