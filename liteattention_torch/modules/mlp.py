"""MLP blocks (counterpart of ``liteattention_tpu/modules/mlp.py``).

``Mlp`` (Dense -> activation -> Dense) and ``GatedMlp`` (SwiGLU/GeGLU),
fp32 parameters computing in ``dtype``, on the card unless a ``device``
is given. ``ParallelMLP`` is the tensor-parallel MLP over a
``torch.distributed`` group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from liteattention_torch.device import resolve_device
from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.activations import gelu_approx
from liteattention_torch.parallel._collectives import all_reduce, copy_to_group
from liteattention_torch.parallel.tensor_parallel import shard_cols, shard_rows


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 activation: Callable = gelu_approx, bias1: bool = True,
                 bias2: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
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
        device = resolve_device(device)
        self.activation = activation
        self.fc1 = Dense(in_features, 2 * hidden_features, bias1, dtype, device)
        self.fc2 = Dense(hidden_features, out_features or in_features, bias2, dtype, device)

    def forward(self, x):
        gate, up = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(self.activation(gate) * up)


class ParallelMLP(nn.Module):
    """Tensor-parallel MLP (JAX ``modules/mlp.py:ParallelMLP``): the hidden
    features split over ``group``'s ``n`` ranks. ``fc1`` is this rank's
    column-parallel up projection (``hidden_features / n`` features, gate |
    up halves when ``gated``), ``fc2`` its row-parallel down projection,
    and an ``all_reduce`` sums the ranks' outputs. JAX's has no bias; with
    ``bias1`` ``fc1`` carries this rank's rows of the up bias, and with
    ``bias2`` the down bias ``out_bias`` is added after the sum (OPT's
    MLP). Differentiable: the input's gradient is summed over the group.
    ``in_features`` is the input width, which Flax reads from the first
    input.
    """

    def __init__(self, in_features: int, hidden_features: int, group,
                 activation: Callable = gelu_approx, gated: bool = False,
                 bias1: bool = False, bias2: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        tp = group.size()
        if hidden_features % tp:
            raise ValueError(f"ParallelMLP: {hidden_features} hidden features do not split "
                             f"over {tp} ranks")
        hidden_local = hidden_features // tp
        self.group = group
        self.gated = gated
        self.activation = activation
        self.fc1 = Dense(in_features, (2 if gated else 1) * hidden_local, bias1, dtype, device)
        self.fc2 = Dense(hidden_local, in_features, False, dtype, device)
        self.out_bias = (nn.Parameter(torch.zeros(in_features, device=device))
                         if bias2 else None)

    def forward(self, x):
        y = self.fc1(copy_to_group(x, self.group))
        if self.gated:
            gate, up = y.chunk(2, dim=-1)
            y = self.activation(gate) * up
        else:
            y = self.activation(y)
        y = all_reduce(self.fc2(y), self.group)
        if self.out_bias is not None:
            y = y + self.out_bias.to(y.dtype)
        return y


def parallel_mlp_state_dict(state_dict, rank: int, tp: int, gated: bool = False):
    """An :class:`Mlp` / :class:`GatedMlp` ``state_dict`` -> rank
    ``rank``'s :class:`ParallelMLP` ``state_dict`` of ``tp`` ranks: its
    rows of ``fc1`` and of its bias (of the gate and of the up half when
    ``gated``), its input columns of ``fc2``, and ``fc2``'s bias as
    ``out_bias``."""
    fc1 = state_dict["fc1.weight"]
    sections = [fc1.shape[0] // 2] * 2 if gated else None
    out = {"fc1.weight": shard_rows(fc1, rank, tp, sections),
           "fc2.weight": shard_cols(state_dict["fc2.weight"], rank, tp)}
    if "fc1.bias" in state_dict:
        out["fc1.bias"] = shard_rows(state_dict["fc1.bias"], rank, tp, sections)
    if "fc2.bias" in state_dict:
        out["out_bias"] = state_dict["fc2.bias"]
    return out


__all__ = ["Mlp", "GatedMlp", "ParallelMLP", "parallel_mlp_state_dict"]
