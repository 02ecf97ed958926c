"""Activation functions (counterpart of ``liteattention_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch.nn.functional as F


def sqrelu_fwd(x):
    """Squared ReLU."""
    r = F.relu(x)
    return r * r


def swiglu(gate, up):
    """SiLU(gate) * up (the LLaMA MLP)."""
    return F.silu(gate) * up


def bias_gelu(x, bias):
    """Tanh-approximated GELU of ``x + bias``."""
    return F.gelu(x + bias, approximate="tanh")


def gelu_approx(x):
    """Tanh-approximated GELU (flax's ``nn.gelu`` default)."""
    return F.gelu(x, approximate="tanh")


__all__ = ["sqrelu_fwd", "swiglu", "bias_gelu", "gelu_approx"]
