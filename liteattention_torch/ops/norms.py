"""Fused-norm semantics: dropout + residual-add + LayerNorm / RMSNorm.

Counterpart of ``liteattention_tpu/ops/norms.py``. Statistics in fp32,
the IO dtype preserved; ``dropout_add_norm`` drops ``x`` (residual
dropout, when not ``deterministic``), adds the residual (in fp32 with
``residual_in_fp32``) and with ``prenorm`` also returns the pre-norm sum,
the residual stream of a pre-norm block. None of these is a Pallas kernel
in the JAX package (XLA fuses them); here they are plain torch. The keep
mask is drawn from an explicit ``torch.Generator`` in place of JAX's rng
key.
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
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
):
    """``norm(dropout(x) + residual)``, and with ``prenorm`` also the
    pre-norm sum.

    Dropout runs when ``dropout_p > 0`` and not ``deterministic`` (JAX's
    default, True, leaves ``x`` as it is): each element of ``x`` is kept
    with probability ``1 - dropout_p`` (:func:`dropout_mask`, drawn from
    ``generator``, which must then be given, on x's device) and scaled by
    ``1 / (1 - dropout_p)`` in x's dtype. The sum is taken in fp32 when ``residual_in_fp32`` (else
    in x's dtype) and rounded to x's dtype before the norm, as the JAX
    function does.
    """
    h = x
    if dropout_p > 0.0 and not deterministic:
        keep = dropout_mask(x, dropout_p, generator)
        h = torch.where(keep, x / (1.0 - dropout_p), 0.0).to(x.dtype)
    acc_dtype = torch.float32 if residual_in_fp32 else x.dtype
    pre = h.to(acc_dtype)
    if residual is not None:
        pre = pre + residual.to(acc_dtype)
    out = _norm_core(pre.to(x.dtype), weight, bias, eps, rms)
    if prenorm:
        return out, pre
    return out


def dropout_mask(x: torch.Tensor, dropout_p: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The keep mask of residual dropout over ``x``: bool, True with
    probability ``1 - dropout_p``, drawn from ``generator`` on x's device
    (JAX's ``bernoulli(rng, 1 - p, x.shape)``)."""
    if generator is None:
        raise ValueError("dropout requires a torch.Generator (generator=), as JAX's needs an "
                         "rng key")
    return torch.rand(x.shape, generator=generator, device=x.device) >= dropout_p


def dropout_add_layer_norm(*args, **kwargs):
    """:func:`dropout_add_norm` with LayerNorm."""
    return dropout_add_norm(*args, rms=False, **kwargs)


def dropout_add_rms_norm(*args, **kwargs):
    """:func:`dropout_add_norm` with RMSNorm."""
    return dropout_add_norm(*args, rms=True, **kwargs)


__all__ = [
    "layer_norm",
    "rms_norm",
    "dropout_add_norm",
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
    "dropout_mask",
]
