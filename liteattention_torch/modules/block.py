"""Transformer residual block (counterpart of
``liteattention_tpu/modules/block.py:Block``).

Pre-norm (the residual stream threads through, in fp32 with
``residual_in_fp32``; ``residual=None`` in the first block), post-norm
(BERT/OPT-350m: residual add, then norm) and the parallel block
(GPT-J/NeoX: attention and MLP from the same normed input, with tied or
separate norms). The mixer is held as ``mha`` and the MLP as ``mlp``, the
names the GPT param tree gives them. Residual dropout (``resid_dropout1``
on the input of norm1 -- the mixer's output in post-norm --, and
``resid_dropout2`` on that of norm2) runs in a call with
``deterministic=False``, its masks drawn from the call's ``generator``
(which the mixer takes too, for attention dropout), in JAX's order:
norm1's mask, the mixer's seed, norm2's mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from liteattention_torch.device import resolve_device
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
        device = resolve_device(device)
        self.resid_dropout1, self.resid_dropout2 = float(resid_dropout1), float(resid_dropout2)
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

    def _norm(self, name, x, residual, prenorm=True, dropout_p=0.0, **drop):
        """Norm ``name`` of ``dropout(x) + residual``; ``drop``: the call's
        ``deterministic`` and ``generator``."""
        return dropout_add_norm(
            x, residual, getattr(self, f"{name}_scale"),
            getattr(self, f"{name}_bias", None), dropout_p, eps=self.eps, prenorm=prenorm,
            residual_in_fp32=self.residual_in_fp32 and prenorm,
            rms=self.use_rms_norm, **drop,
        )

    def forward(self, hidden_states, residual=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, **mixer_kwargs):
        """Pre-norm: returns ``(mlp_out, residual)``; post-norm: the
        normed output alone. ``deterministic=False`` turns on residual and
        attention dropout, drawn from ``generator``."""
        drop = dict(deterministic=deterministic, generator=generator)
        if not deterministic:
            mixer_kwargs.update(deterministic=False, generator=generator)
        if not self.prenorm:
            h = self._norm("norm1", self.mha(hidden_states, **mixer_kwargs),
                           hidden_states, prenorm=False, dropout_p=self.resid_dropout1, **drop)
            return self._norm("norm2", self.mlp(h), h, prenorm=False,
                              dropout_p=self.resid_dropout2, **drop)

        normed, new_residual = self._norm("norm1", hidden_states, residual,
                                          dropout_p=self.resid_dropout1, **drop)
        attn_out = self.mha(normed, **mixer_kwargs)
        if self.parallel_block:
            if self.parallel_block_tied_norm:
                mlp_in = normed
            else:
                # Separate norms: norm2 of the same pre-attention stream
                # (norm1's sum, with norm1's dropout mask, as JAX's reuse
                # of rng1 gives).
                mlp_in = self._norm("norm2", new_residual.to(hidden_states.dtype), None,
                                    prenorm=False)
            return attn_out + self.mlp(mlp_in), new_residual
        normed2, new_residual = self._norm("norm2", attn_out, new_residual,
                                           dropout_p=self.resid_dropout2, **drop)
        return self.mlp(normed2), new_residual


__all__ = ["Block"]
