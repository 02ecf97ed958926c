"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
port runs its plain (CPU) versions, the JAX package its Pallas kernels in
interpret mode.
"""

import numpy as np
import torch

# Six xdist workers share the machine: keep each one's torch pool small.
torch.set_num_threads(2)


def t(x):
    """numpy / JAX array -> torch CPU tensor (copy)."""
    return torch.from_numpy(np.array(x))


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class LastLogits:
    """A model as greedy_decode calls it, keeping a copy of each call's
    last-position logits (those the next token is chosen from)."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def __call__(self, ids, inference_params):
        out = self.model(ids, inference_params)
        self.rows.append(out[:, -1].clone())
        return out

    def logits(self):
        return torch.stack(self.rows, dim=1)


def same_config(port, ref):
    """The fields two GPTConfigs (the port's and JAX's) share are equal,
    dtype aside."""
    import dataclasses

    common = {f.name for f in dataclasses.fields(port)} & {f.name for f in dataclasses.fields(ref)}
    common.discard("dtype")
    assert {n: getattr(port, n) for n in common} == {n: getattr(ref, n) for n in common}


def coherent_qkv(rng, b, h, sq, sk, d, hk=None, noise=0.3):
    """Temporally coherent q/k (shared base + noise) and random v, f32."""
    hk = hk or h
    base = rng.randn(b, 1, max(sq, sk), d)
    q = base[:, :, :sq] + noise * rng.randn(b, h, sq, d)
    k = base[:, :, :sk] + noise * rng.randn(b, hk, sk, d)
    v = rng.randn(b, hk, sk, d)
    return q.astype(np.float32), k.astype(np.float32), v.astype(np.float32)


def load_example(name):
    """The module of ``examples/<name>.py`` (the examples are scripts, not
    a package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
