"""MLP blocks (counterpart of ``liteattention_tpu/modules/mlp.py``).

``Mlp`` (Dense -> activation -> Dense) and ``GatedMlp`` (SwiGLU/GeGLU),
fp32 parameters computing in ``dtype``. The tensor-parallel MLP waits for
the port's tensor parallelism.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.activations import gelu_approx


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: Callable = gelu_approx, bias1: bool = True,
                 bias2: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.activation = activation
        self.fc1 = Dense(in_features, hidden_features, bias1, dtype, device)
        self.fc2 = Dense(hidden_features, out_features or in_features, bias2, dtype, device)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


class GatedMlp(nn.Module):
    """``fc2(activation(gate) * up)`` with gate | up from one ``fc1``."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: Callable = F.silu, bias1: bool = False,
                 bias2: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.activation = activation
        self.fc1 = Dense(in_features, 2 * hidden_features, bias1, dtype, device)
        self.fc2 = Dense(hidden_features, out_features or in_features, bias2, dtype, device)

    def forward(self, x):
        gate, up = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(self.activation(gate) * up)


__all__ = ["Mlp", "GatedMlp"]
