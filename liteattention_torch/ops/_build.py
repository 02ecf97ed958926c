"""Build and load the Hopper kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` for ``sm_90a``,
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The
library lands in ``liteattention_torch/_build/<hash>/``, keyed by a hash
of the sources and flags, so a stale build is never loaded. Nothing is
built or loaded at import time: the first CUDA launch calls
:func:`load_kernels`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "liblite_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argument types. Every entry returns the CUDA
# error of its launch (0 = success), but for lite_flash_decode_tile_keys,
# which returns the decode kernel's key tile at a head dim.
SIGNATURES = {
    "lite_flash_decode": [_P] * 13 + ([_I] * 3 + [_L] * 3 + [_I]) * 2 + [_I] * 14
    + [_F, _F, _I, _P],
    "lite_flash_decode_tile_keys": [_I],
    "lite_flash_fwd_dense": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "lite_flash_fwd_masked": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "lite_flash_fwd_dropout": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _F, _I, _P],
    "lite_flash_fwd_window": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _I, _I, _I, _F, _I, _P],
    "lite_flash_fwd_mla": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _I, _P],
    "lite_flash_fwd_segments": [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P],
    "lite_flash_fwd_segments_channels": [_P] * 10 + [_I] * 5 + [_F] + [_I] * 4
    + [_F, _I, _F, _I, _P],
    "lite_mla_decode": [_P] * 9 + [_L] * 2 + [_I] * 14 + [_F, _I, _P],
    "lite_flash_bwd": [_P] * 12 + [_I] * 6 + [_F, _I, _I, _P],
    "lite_flash_bwd_masked": [_P] * 15 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "lite_flash_bwd_dropout": [_P] * 15 + [_I] * 6 + [_F, _I, _I, _I, _F, _I, _P],
    "lite_flash_bwd_window": [_P] * 14 + [_I] * 6 + [_F, _I, _I, _I, _I, _F, _I, _P],
    "lite_flash_bwd_segments": [_P] * 17 + [_I] * 5 + [_F, _I, _I, _P],
    "lite_flash_bwd_segments_channels": [_P] * 18 + [_I] * 5 + [_F] + [_I] * 3
    + [_F, _I, _F, _I, _P],
    "lite_flash_fwd_gather": [_P] * 10 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "lite_flash_fwd_coarse": [_P] * 9 + [_I] * 8 + [_F, _F, _I, _P],
    "lite_kv_compact": [_P] * 5 + [_I] * 5 + [_P],
    "lite_pack_schedule": [_P] * 5 + [_I] * 4 + [_P],
    "lite_noop": [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc output, including ptxas register / spill lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_kernels() -> Build:
    """Compile the kernel library if no build of these sources exists."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {obj.stem}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *(str(o) for o, _ in procs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return Build(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    dll = ctypes.CDLL(str(build_kernels().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def check_aligned(*tensors) -> None:
    """The kernels move 16-byte chunks: every buffer must start on one."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")


def stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, read without
    building a ``torch.cuda.Stream`` object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


__all__ = ["Build", "build_kernels", "load_kernels", "check", "check_aligned", "stream"]
