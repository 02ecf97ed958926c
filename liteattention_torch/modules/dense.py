"""A linear layer with fp32 parameters that computes in a lower dtype.

The torch form of flax ``nn.Dense(dtype=..., param_dtype=float32)``, which
every JAX module of the model stack uses: the weight and bias stay fp32
(the optimizer's master copy) and are cast, with the input, to ``dtype``
for the product. Weights are ``[out, in]`` as in ``nn.Linear``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=torch.float32, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


__all__ = ["Dense"]
