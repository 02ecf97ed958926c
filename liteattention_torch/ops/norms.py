"""Fused-norm semantics: residual-add + LayerNorm / RMSNorm.

Counterpart of ``liteattention_tpu/ops/norms.py``. Statistics in fp32,
the IO dtype preserved; ``dropout_add_norm`` adds the residual (in fp32
with ``residual_in_fp32``) and with ``prenorm`` also returns the pre-norm
sum, the residual stream of a pre-norm block. None of these is a Pallas
kernel in the JAX package (XLA fuses them); here they are plain torch.
Residual dropout is not ported: ``dropout_p > 0`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _norm_core(x, weight, bias, eps: float, rms: bool):
    xf = x.float()
    if rms:
        normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        if weight is not None:
            normed = normed * weight.float()
    else:
        normed = F.layer_norm(
            xf, (x.shape[-1],),
            None if weight is None else weight.float(),
            None if bias is None else bias.float(), eps,
        )
    return normed.to(x.dtype)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last dim: fp32 statistics, IO dtype preserved."""
    return _norm_core(x, weight, bias, eps, rms=False)


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm over the last dim: fp32 statistics, IO dtype preserved."""
    return _norm_core(x, weight, None, eps, rms=True)


def dropout_add_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    dropout_p: float = 0.0,
    eps: float = 1e-6,
    prenorm: bool = False,
    residual_in_fp32: bool = False,
    rms: bool = False,
):
    """``norm(x + residual)``, and with ``prenorm`` also the pre-norm sum.

    The sum is taken in fp32 when ``residual_in_fp32`` (else in x's
    dtype) and rounded to x's dtype before the norm, as the JAX function
    does. ``dropout_p > 0`` raises: residual dropout is not ported.
    """
    if dropout_p > 0.0:
        raise NotImplementedError("dropout_add_norm: residual dropout is not ported yet")
    acc_dtype = torch.float32 if residual_in_fp32 else x.dtype
    pre = x.to(acc_dtype)
    if residual is not None:
        pre = pre + residual.to(acc_dtype)
    out = _norm_core(pre.to(x.dtype), weight, bias, eps, rms)
    if prenorm:
        return out, pre
    return out


__all__ = ["layer_norm", "rms_norm", "dropout_add_norm"]
