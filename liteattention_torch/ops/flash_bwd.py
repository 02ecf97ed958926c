"""Dense flash-attention backward (kernel B7: dQ, dK and dV in one pass).

Counterpart of ``liteattention_tpu/ops/flash_bwd.py:flash_attention_bwd``.

Kernel: ``csrc/flash_bwd.cu``, replacing the Pallas kernels
``liteattention_tpu/ops/flash_bwd.py:_dq_kernel`` (B7a) and
``_dkv_kernel`` (B7b), and the XLA pass that computes
``delta = rowsum(dO * O)``. :func:`flash_bwd` launches three kernels on
the current stream: (a) delta, lse in log2 units and a zeroed fp32 dQ
accumulator; (b) one CTA per (b, kv-head, 128-key tile) that walks the
GQA group's q-heads and their 64-row Q/dO tiles (TMA loads into a ring of
shared-memory stages, five wgmma products per step by two warpgroups) and
adds each step's dQ part to the accumulator with a bulk reduce-add; (c)
the accumulator to bf16. dK and dV sum the group inside one CTA and are
bit-stable; dQ is summed across CTAs by atomics in no fixed order, so its
last bits may change from run to run.

What bounds it on the H100: tensor-core throughput (10 d FLOPs per (q
row, key) pair: S, dP, dV, dK, dQ). As in the JAX kernels, P and dS are
rounded to the input dtype (bf16 on the card) before they feed a product.

Takes bf16 on the card (any float dtype on the CPU), head dim 64 or 128,
GQA, ragged Sq/Sk, ``Sq != Sk``, causal or not. The JAX function's other
mask channels are not ported and raise. :func:`flash_bwd` runs its plain
PyTorch version (:func:`flash_bwd_plain`, the same one pass over 128-key
tiles) for CPU tensors and the kernels for CUDA tensors.
:func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv_plain` are B7a's and
B7b's plain versions, which the card's results are held against.
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


# keys per tile of the one pass (the kernel's CTA width).
TILE_K = 128
# q rows per step of the kernel's walk (its dQ accumulator is padded to it).
TILE_Q = 64


def flash_bwd_plain(q, k, v, o, lse, dout, scale, causal):
    """Plain version of the one pass: dq, dk, dv in q's / k's / v's dtype.

    Walks 128-key tiles in order, as the kernel's CTAs do: per tile, P and
    dS over every q row (P recomputed from lse, 0 where lse is -inf or
    masked; ``dS = P * (dP - delta) * scale``), each rounded to q's dtype
    before its product; dK, dV of the tile's keys, and dQ accumulated in
    fp32 tile after tile. dK, dV sum each kv head's group of q heads.
    """
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    qf, dof = q.float(), dout.float()
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)  # [B, H, Sq, 1]
    lse2 = (lse * LOG2E)[..., None]
    live = torch.isfinite(lse2)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, TILE_K):
        keys = slice(k0, k0 + TILE_K)
        kt, vt = kf[:, :, keys], vf[:, :, keys]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * (scale * LOG2E)
        p = torch.where(live, torch.exp2(s - lse2), 0.0)
        if causal:
            row = torch.arange(sq, device=q.device)[:, None]
            col = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            p = p.masked_fill(col > row + (sk - sq), 0.0)
        dp = torch.matmul(dof, vt.transpose(-1, -2))
        ds = (p * (dp - delta) * scale).to(q.dtype).float()
        p = p.to(q.dtype).float()
        dv[:, :, keys] = torch.matmul(p.transpose(-1, -2), dof)
        dk[:, :, keys] = torch.matmul(ds.transpose(-1, -2), qf)
        dq += torch.matmul(ds, kt)
    dk = dk.view(b, hk, group, sk, d).sum(dim=2)
    dv = dv.view(b, hk, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(q, k, v, o, lse, dout):
    if any(x.device != q.device for x in (k, v, o, lse, dout)):
        raise ValueError("flash_bwd: all inputs must be on one device")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v, o, dout)):
        raise TypeError("the CUDA kernels take bf16 q, k, v, o, dout")
    if lse.dtype != torch.float32:
        raise TypeError("lse must be fp32")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim {q.shape[-1]} not built (64 or 128)")
    if not all(x.is_contiguous() for x in (q, k, v, o, lse, dout)):
        raise ValueError("the CUDA kernels take contiguous tensors")
    _build.check_aligned(q, k, v, o, dout)


def flash_bwd(q, k, v, o, lse, dout, scale: float, causal: bool):
    """B7: dq, dk, dv from q, k, v, the forward's o and lse (``[B, H, Sq]``
    fp32, natural log) and dO, in one pass (three launches)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, dout, scale, causal)
    _check_cuda(q, k, v, o, lse, dout)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    sq_pad = -(-sq // TILE_Q) * TILE_Q
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_accum = torch.empty((b, h, sq_pad, d), dtype=torch.float32, device=q.device)
    lse2 = torch.empty((b, h, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    err = _build.load_kernels().lite_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_accum.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), b, h, hk, sq, sk, d, float(scale), int(causal),
        q.device.index, _build.stream(q.device),
    )
    _build.check(err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0

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
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    return flash_bwd(q, k, v, o, lse.contiguous(), do, scale, causal)


__all__ = [
    "causal_mask",
    "flash_attention_bwd",
    "flash_bwd",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_plain",
]
