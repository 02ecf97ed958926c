"""The sequence-parallel demo (``examples/torch_seq_parallel_demo.py``)
runs on the CPU: two gloo ranks it spawns itself, at a tiny size; four
steps, finite outputs, the whole masks' sparsity never falling."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_demo_runs_on_two_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "examples/torch_seq_parallel_demo.py", "--device", "cpu", "--ranks", "2",
         "--heads", "2", "--head-dim", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    steps = re.findall(r"step (\d): thr=\S+ sparsity=([\d.]+)% out=\(1, 2, 512, 64\) finite=True",
                       proc.stdout)
    assert [int(s) for s, _ in steps] == [0, 1, 2, 3], proc.stdout
    sparsity = [float(p) for _, p in steps]
    assert all(a <= b for a, b in zip(sparsity, sparsity[1:]))
