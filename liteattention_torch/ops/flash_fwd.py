"""Dense flash-attention forward (kernel B1), differentiable.

Counterpart of ``liteattention_tpu/ops/flash_fwd.py:flash_attention``.

Kernel: ``csrc/flash_fwd.cu`` + ``csrc/attention_fwd.cuh``, replacing the
Pallas kernel ``liteattention_tpu/ops/flash_fwd.py:_fwd_kernel``. One CTA
per (b, h, 128-row q-tile) walks the 128-key tiles through a two-stage
cp.async ring, with mma.sync bf16 matmuls and an exp2 online softmax.
With ``causal`` it stops at the diagonal (bottom-right aligned, offset
``Sk - Sq``), so the tiles above it cost nothing. What bounds it on the
H100: tensor-core throughput (each K/V byte feeds 128 q rows); mma.sync runs
below the wgmma rate, which later PRs take on.

The gradient is a ``torch.autograd.Function`` whose backward is the pair
of kernels B7a/B7b (:mod:`liteattention_torch.ops.flash_bwd`); the lse
cotangent is ignored, as in the JAX ``custom_vjp``.

Takes bf16 on the card (any float dtype on the CPU), head dim 64 or 128,
GQA, causal or not. The other JAX mask channels (segments, bound/low,
window, softcap, ALiBi, dropout, ``qv``) are not ported and raise. The
wrapper runs the plain PyTorch version for CPU tensors and the kernel for
CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.flash_bwd import causal_mask, flash_attention_bwd
from liteattention_torch.ops.tile_sizes import BlockSizes

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# q rows per chunk of the plain version (bounds its score matrix).
PLAIN_Q_CHUNK = 1024


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
):
    """Plain PyTorch version of the kernel: fp32 scores, exact softmax in
    log2 space (the kernel's and the plain lite version's form).

    ``q`` ``[B, H, Sq, D]``, ``k``/``v`` ``[B, Hk, Sk, D]``. Returns
    (out in q's dtype, lse fp32 natural log). A row with no valid key
    (causal with Sq > Sk) gives out 0 and lse -inf. Query rows are
    processed in chunks so long sequences fit in memory.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sq, sk = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    outs, lses = [], []
    for q0 in range(0, sq, PLAIN_Q_CHUNK):
        qf = q[:, :, q0 : q0 + PLAIN_Q_CHUNK].float()
        s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
        if causal:
            s = s.masked_fill(causal_mask(q0, qf.shape[2], sq, sk, q.device), -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        # A row with no valid key: every p is 0, not exp2 of the mask.
        p = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(dim=-1, keepdim=True)
        live = l > 0
        outs.append((torch.matmul(p, vf) / torch.where(live, l, 1.0)).to(q.dtype))
        lse = torch.where(live, m * LN2 + torch.log(l), -torch.inf)
        lses.append(lse[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q, k, v must be [B, H, S, D] with k.shape == v.shape")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"incompatible shapes {q.shape} / {k.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


class _FlashAttention(torch.autograd.Function):
    """Forward through B1 (or its plain version), backward through B7."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, causal)
        else:
            out, lse = _launch(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
    dropout_p: float = 0.0,
    qv: Optional[torch.Tensor] = None,
):
    """Dense flash attention forward, differentiable in q, k, v.

    Args:
      q: ``[B, H, Sq, D]``; k, v: ``[B, Hk, Sk, D]`` with ``H % Hk == 0``.
      scale: softmax scale (default ``1/sqrt(D)``).
      causal: bottom-right-aligned causal mask (key col valid for q row r
        iff ``col <= r + Sk - Sq``).
      block_sizes: only the 128 x 128 geometry is built.
      return_lse: also return the natural-log LSE ``[B, H, Sq]`` fp32.

    ``dropout_p`` and ``qv`` are channels of the JAX kernel that the port
    does not take yet; they raise.
    """
    if dropout_p or qv is not None:
        raise NotImplementedError("flash_attention: dropout and qv are not ported yet")
    if block_sizes is not None and block_sizes != BlockSizes(128, 128):
        raise ValueError(f"only BlockSizes(128, 128) is built, got {block_sizes}")
    _check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    out, lse = _FlashAttention.apply(q, k, v, float(scale), bool(causal))
    if return_lse:
        return out, lse
    return out


def _launch(q, k, v, scale, causal):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the CUDA kernel takes bf16 q, k, v")
    b, h, sq, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not built (64 or 128)")
    _build.check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load_kernels()
    err = lib.lite_flash_fwd_dense(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d, float(scale),
        int(causal), q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_plain"]
