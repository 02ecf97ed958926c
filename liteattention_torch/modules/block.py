"""Transformer residual block (counterpart of
``liteattention_tpu/modules/block.py:Block``).

Pre-norm (the residual stream threads through, in fp32 with
``residual_in_fp32``; ``residual=None`` in the first block), post-norm
(BERT/OPT-350m: residual add, then norm) and the parallel block
(GPT-J/NeoX: attention and MLP from the same normed input, with tied or
separate norms). The mixer is held as ``mha`` and the MLP as ``mlp``, the
names the GPT param tree gives them. Residual dropout is not ported and
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from liteattention_torch.modules.mha import MHA
from liteattention_torch.modules.mlp import Mlp
from liteattention_torch.ops.norms import dropout_add_norm


class Block(nn.Module):
    def __init__(
        self,
        dim: int,
        mixer: Optional[nn.Module] = None,
        mlp: Optional[nn.Module] = None,
        prenorm: bool = True,
        parallel_block: bool = False,
        parallel_block_tied_norm: bool = True,
        resid_dropout1: float = 0.0,
        resid_dropout2: float = 0.0,
        use_rms_norm: bool = False,
        residual_in_fp32: bool = False,
        eps: float = 1e-6,
        dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        if resid_dropout1 > 0.0 or resid_dropout2 > 0.0:
            raise NotImplementedError("Block: residual dropout is not ported yet")
        self.prenorm = prenorm
        self.parallel_block = parallel_block
        self.parallel_block_tied_norm = parallel_block_tied_norm
        self.use_rms_norm = use_rms_norm
        self.residual_in_fp32 = residual_in_fp32
        self.eps = eps
        self.mha = mixer or MHA(dim, 8, dtype=dtype, device=device)
        self.mlp = mlp or Mlp(dim, 4 * dim, dtype=dtype, device=device)
        norms = ["norm1"]
        if not (parallel_block and parallel_block_tied_norm):
            norms.append("norm2")
        for name in norms:
            self.register_parameter(
                f"{name}_scale", nn.Parameter(torch.ones(dim, device=device))
            )
            if not use_rms_norm:
                self.register_parameter(
                    f"{name}_bias", nn.Parameter(torch.zeros(dim, device=device))
                )

    def _norm(self, name, x, residual, prenorm=True):
        return dropout_add_norm(
            x, residual, getattr(self, f"{name}_scale"),
            getattr(self, f"{name}_bias", None), eps=self.eps, prenorm=prenorm,
            residual_in_fp32=self.residual_in_fp32 and prenorm,
            rms=self.use_rms_norm,
        )

    def forward(self, hidden_states, residual=None, **mixer_kwargs):
        """Pre-norm: returns ``(mlp_out, residual)``; post-norm: the
        normed output alone."""
        if not self.prenorm:
            h = self._norm("norm1", self.mha(hidden_states, **mixer_kwargs),
                           hidden_states, prenorm=False)
            return self._norm("norm2", self.mlp(h), h, prenorm=False)

        normed, new_residual = self._norm("norm1", hidden_states, residual)
        attn_out = self.mha(normed, **mixer_kwargs)
        if self.parallel_block:
            if self.parallel_block_tied_norm:
                mlp_in = normed
            else:
                # Separate norms: re-norm the same pre-attention stream.
                mlp_in, _ = self._norm("norm2", hidden_states, residual)
            return attn_out + self.mlp(mlp_in), new_residual
        normed2, new_residual = self._norm("norm2", attn_out, new_residual)
        return self.mlp(normed2), new_residual


__all__ = ["Block"]
