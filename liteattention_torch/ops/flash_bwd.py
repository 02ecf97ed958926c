"""Dense flash-attention backward (kernels B7a dQ and B7b dK/dV).

Counterpart of ``liteattention_tpu/ops/flash_bwd.py:flash_attention_bwd``.

Kernels: ``csrc/flash_bwd.cu``, replacing the Pallas kernels
``liteattention_tpu/ops/flash_bwd.py:_dq_kernel`` and ``_dkv_kernel``.
Both recompute P from the forward's lse (the scores matrix is never
stored) with ``delta = rowsum(dO * O)`` computed here in fp32 by torch, as
the JAX package computes it in one XLA pass.

* B7a :func:`flash_bwd_dq`: one CTA per (b, q-head, 128-row q-tile) walks
  64-key K/V tiles up to the diagonal.
* B7b :func:`flash_bwd_dkv`: one CTA per (b, kv-head, 128-key k-tile)
  loops over the q-heads of its GQA group and their 64-row Q/dO tiles from
  the first that reaches the diagonal. The group sum stays inside one CTA:
  no atomics, so the gradients are bit-stable from run to run.

What bounds them on the H100: tensor-core throughput (S, dP and dQ in B7a; S,
dV, dP and dK in B7b, all mma.sync bf16 with fp32 accumulation). As in
the JAX kernels, P and dS are rounded to bf16 before they feed a product.

Takes bf16 on the card (any float dtype on the CPU), head dim 64 or 128,
GQA, ragged Sq/Sk, ``Sq != Sk``, causal or not. The JAX function's other
mask channels are not ported and raise. Each wrapper runs its plain
PyTorch version for CPU tensors and its kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from liteattention_torch.ops import _build

LOG2E = 1.4426950408889634
# q rows per chunk of the plain versions (bounds their score matrices).
PLAIN_Q_CHUNK = 1024


def causal_mask(q0: int, rows: int, seqlen_q: int, seqlen_k: int, device):
    """Bool ``[rows, Sk]``: True where key col lies above the bottom-right
    aligned diagonal of q rows ``q0..q0+rows`` (``col > row + Sk - Sq``)."""
    row = torch.arange(q0, q0 + rows, device=device)[:, None]
    col = torch.arange(seqlen_k, device=device)[None, :]
    return col > row + (seqlen_k - seqlen_q)


def _plain_chunks(q, k, v, dout, lse, delta, scale, causal):
    """Yield ``(q0, p, ds)`` per chunk of q rows, fp32, with K/V expanded
    to the q heads: P recomputed from lse exactly as the kernels do
    (``p = 0`` where lse is -inf), ``dS = P * (dP - delta) * scale``."""
    sq, sk = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    for q0 in range(0, sq, PLAIN_Q_CHUNK):
        rows = slice(q0, q0 + PLAIN_Q_CHUNK)
        s = torch.matmul(q[:, :, rows].float(), kf.transpose(-1, -2)) * (scale * LOG2E)
        if causal:
            s = s.masked_fill(causal_mask(q0, s.shape[2], sq, sk, q.device), -torch.inf)
        lse2 = lse[:, :, rows, None] * LOG2E
        p = torch.where(torch.isfinite(lse2), torch.exp2(s - lse2), 0.0)
        dp = torch.matmul(dout[:, :, rows].float(), vf.transpose(-1, -2))
        yield q0, p, p * (dp - delta[:, :, rows, None]) * scale


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal):
    """Plain version of B7a: dQ ``[B, H, Sq, D]`` in q's dtype."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    dq = [
        torch.matmul(ds, kf)
        for _, _, ds in _plain_chunks(q, k, v, dout, lse, delta, scale, causal)
    ]
    return torch.cat(dq, dim=2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal):
    """Plain version of B7b: dK, dV ``[B, Hk, Sk, D]`` in k's / v's dtype,
    summed over each kv head's group of q heads."""
    b, h, _, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, p, ds in _plain_chunks(q, k, v, dout, lse, delta, scale, causal):
        rows = slice(q0, q0 + p.shape[2])
        dv += torch.matmul(p.transpose(-1, -2), dout[:, :, rows].float())
        dk += torch.matmul(ds.transpose(-1, -2), q[:, :, rows].float())
    dk = dk.view(b, hk, h // hk, sk, d).sum(dim=2)
    dv = dv.view(b, hk, h // hk, sk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(q, k, v, dout, lse, delta):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v, dout)):
        raise TypeError("the CUDA kernels take bf16 q, k, v, dout")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be fp32")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim {q.shape[-1]} not built (64 or 128)")
    if not all(x.is_contiguous() for x in (q, k, v, dout, lse, delta)):
        raise ValueError("the CUDA kernels take contiguous tensors")
    _build.check_aligned(q, k, v, dout)


def _dims(q, k, scale, causal):
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d, float(scale), int(causal),
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dq(q, k, v, dout, lse, delta, scale: float, causal: bool):
    """B7a: dQ from q, k, v, dO, lse and delta (``[B, H, Sq]`` fp32)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal)
    _check_cuda(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    err = _build.load_kernels().lite_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(q, k, scale, causal),
    )
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float, causal: bool):
    """B7b: dK, dV from q, k, v, dO, lse and delta."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal)
    _check_cuda(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load_kernels().lite_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, scale, causal),
    )
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0

# Mask channels of the JAX function that the port does not take yet.
_UNPORTED = (
    "q_segments", "kv_segments", "kv_bound", "bound_causal", "kv_low",
    "window", "softcap", "alibi_slopes", "dropout_p", "dropout_seed",
)


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, causal: bool, **channels):
    """dQ, dK, dV of the dense flash forward.

    ``q`` ``[B, H, Sq, D]``, ``k``/``v`` ``[B, Hk, Sk, D]``, ``o``/``do``
    like q, ``lse`` ``[B, H, Sq]`` fp32 natural log (the forward's). Passing
    one of the JAX function's other mask channels (segments, bound/low,
    window, softcap, ALiBi, dropout), even at its default, raises
    ``NotImplementedError``.
    """
    unknown = set(channels) - set(_UNPORTED)
    if unknown:
        raise TypeError(f"flash_attention_bwd: unexpected arguments {sorted(unknown)}")
    if channels:
        raise NotImplementedError(f"flash_attention_bwd: {sorted(channels)} not ported yet")
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    delta = (o.float() * do.float()).sum(dim=-1)  # [B, H, Sq]
    lse = lse.contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


__all__ = [
    "causal_mask",
    "flash_attention_bwd",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
]
