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

Takes bf16 on the card (any float dtype on the CPU), head dim 64, 80, 96,
128 or 256 (:func:`check_head_dim`; at 256 the kernel of
``csrc/flash_bwd_d256.cu``: 64-key CTAs whose two warpgroups split dK, dV
and dQ by columns, dQ added by float4 atomics), GQA, ragged Sq/Sk, ``Sq !=
Sk``, causal or not, and B1's per-batch channels (at head dim 64, 80 or
128) with JAX's
meanings: the key range ``[kv_low[b], kv_bound[b])``
with ``bound_causal`` and the ALiBi bias (``alibi_slopes`` ``[H]`` or
``[B, H]``), on the same kernel's RANGE / ALIBI instantiations (entry
``lite_flash_bwd_masked``; launches counted in ``flash_bwd.bound_launches``,
and with ALiBi in ``flash_bwd.alibi_launches``; ``flash_bwd.launches``
counts the channel-free kernel). With ``bound_causal`` the ALiBi scores
leave out the per-row constant ``slope * (Sk - kv_bound[b])`` and lse takes
it back, as B1 does, so P is recomputed from the scores B1 summed. The
segment channel (``q_segments`` / ``kv_segments``, batch 1) runs the
kernel's segment instantiation (entry ``lite_flash_bwd_segments``, counted
in ``flash_bwd.segment_launches``): each 128-key tile walks only the q rows
its ids can meet (:mod:`liteattention_torch.ops.segments`). Attention
dropout runs the kernel's DROPOUT instantiation (source
``csrc/flash_bwd_dropout.cu``, entry ``lite_flash_bwd_dropout``, counted in
``flash_bwd.dropout_launches``; the key range with it): each score
regenerates B1's keep mask (:func:`~liteattention_torch.ops.dropout.
dropout_keep_mask`, ``bh`` the q head), dV takes the dropped and rescaled
P and dS the dropped and rescaled dP, as in JAX. The JAX function's other
mask channels (window, softcap) are not ported and raise. :func:`flash_bwd` runs its plain PyTorch version
(:func:`flash_bwd_plain`, the same one pass over 128-key tiles) for CPU
tensors and the kernels for CUDA tensors. :func:`flash_bwd_dq_plain` and
:func:`flash_bwd_dkv_plain` are B7a's and B7b's plain versions, which the
card's results are held against.
"""

from __future__ import annotations

import torch

from liteattention_torch.ops import _build, segments
from liteattention_torch.ops.dropout import dropout_keep, dropout_seed_tensor, dropout_threshold

LOG2E = 1.4426950408889634
# q rows per chunk of the plain versions (bounds their score matrices).
PLAIN_Q_CHUNK = 1024


def causal_mask(q0: int, rows: int, seqlen_q: int, seqlen_k: int, device):
    """Bool ``[rows, Sk]``: True where key col lies above the bottom-right
    aligned diagonal of q rows ``q0..q0+rows`` (``col > row + Sk - Sq``)."""
    row = torch.arange(q0, q0 + rows, device=device)[:, None]
    col = torch.arange(seqlen_k, device=device)[None, :]
    return col > row + (seqlen_k - seqlen_q)


class _Keys:
    """B1's channels as the plain versions apply them: the log2-space
    scores of q rows ``row`` against keys ``col`` (ALiBi added, hidden keys
    -inf), lse in log2 units (with ALiBi and ``bound_causal`` less the
    per-row constant ``slope * shift`` that the scores leave out, ``shift =
    max(Sk - kv_bound[b], 0)``) and, with ``dropout_p``, B1's keep mask."""

    def __init__(self, b, h, sq, sk, device, scale, causal, kv_bound=None, kv_low=None,
                 bound_causal=False, alibi_slopes=None, q_segments=None, kv_segments=None,
                 dropout_p=0.0, dropout_seed=None):
        self.sq, self.sk, self.scale, self.causal = sq, sk, scale, causal
        self.dropout_p = dropout_p
        if dropout_p > 0.0:
            self.seed = dropout_seed_tensor(dropout_seed, device)
            self.bh = (torch.arange(b, device=device)[:, None] * h
                       + torch.arange(h, device=device))[:, :, None, None]
        self.q_seg = self.k_seg = None
        if q_segments is not None:
            self.q_seg = q_segments.to(device).reshape(b, 1, sq, 1)
            self.k_seg = kv_segments.to(device).reshape(b, 1, 1, sk)
        self.bound_causal = bound_causal and kv_bound is not None

        def per_batch(x):
            return None if x is None else x.to(device).reshape(b, 1, 1, 1)

        self.bound, self.low = per_batch(kv_bound), per_batch(kv_low)
        self.slopes = self.shift = None
        if alibi_slopes is not None:
            slopes = alibi_slopes.to(device, torch.float32).reshape(-1, h).expand(b, h)
            self.slopes = slopes[:, :, None, None]
            self.shift = torch.zeros(b, 1, 1, 1, device=device)
            if self.bound_causal:
                self.shift = (sk - self.bound).clamp_min(0).float()

    def scores(self, raw, row, col):
        """``raw`` ``[B, H, R, C]`` fp32 (q . k), ``row`` ``[R, 1]`` and
        ``col`` ``[1, C]`` absolute positions -> log2-space scores."""
        s = raw * (self.scale * LOG2E)
        if self.slopes is not None:
            dist = (row + (self.sk - self.sq) - col).float()
            s = s - (self.slopes * LOG2E) * ((dist if self.causal else dist.abs()) - self.shift)
        hidden = col >= self.sk
        if self.causal:
            hidden = hidden | (col > row + (self.sk - self.sq))
        if self.bound is not None:
            end = self.bound - self.sq + row + 1 if self.bound_causal else self.bound
            hidden = hidden | (col >= end)
        if self.low is not None:
            hidden = hidden | (col < self.low)
        if self.q_seg is not None:
            rows = row.reshape(-1)
            hidden = hidden | (self.q_seg[:, :, rows] != self.k_seg[..., col.reshape(-1)])
        return s.masked_fill(hidden, -torch.inf)

    def drop(self, p, dp, row, col):
        """JAX's dropout of the backward: ``(D * P, D * dP)`` with ``D =
        keep / (1 - p)`` at q rows ``row`` and keys ``col`` (as
        :meth:`scores` takes them); ``(p, dp)`` without dropout."""
        if self.dropout_p <= 0.0:
            return p, dp
        keep = dropout_keep(self.seed, self.bh, row, col, self.dropout_p)
        rp = 1.0 / (1.0 - self.dropout_p)
        return torch.where(keep, p * rp, 0.0), torch.where(keep, dp * rp, 0.0)

    def lse2(self, lse):
        """``lse`` ``[B, H, R]`` (natural log, B1's) -> ``[B, H, R, 1]`` in
        log2 units against the scores."""
        lse = lse[..., None]
        if self.slopes is not None and self.bound_causal:
            lse = lse + self.slopes * self.shift
        return lse * LOG2E


def _plain_chunks(q, k, v, dout, lse, delta, scale, causal, **channels):
    """Yield ``(q0, p, ds)`` per chunk of q rows, fp32, with K/V expanded
    to the q heads: P recomputed from lse exactly as the kernels do
    (``p = 0`` where lse is -inf or the key is hidden), ``dS = P * (dP -
    delta) * scale``; with dropout (JAX's order) ``p`` is the dropped and
    rescaled P that dV takes and dP is dropped and rescaled before dS."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    group = h // k.shape[1]
    keys = _Keys(b, h, sq, sk, q.device, scale, causal, **channels)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    col = torch.arange(sk, device=q.device)[None, :]
    for q0 in range(0, sq, PLAIN_Q_CHUNK):
        rows = slice(q0, q0 + PLAIN_Q_CHUNK)
        qc = q[:, :, rows].float()
        row = torch.arange(q0, q0 + qc.shape[2], device=q.device)[:, None]
        s = keys.scores(torch.matmul(qc, kf.transpose(-1, -2)), row, col)
        lse2 = keys.lse2(lse[:, :, rows])
        p = torch.where(torch.isfinite(lse2), torch.exp2(s - lse2), 0.0)
        dp = torch.matmul(dout[:, :, rows].float(), vf.transpose(-1, -2))
        pd, dp = keys.drop(p, dp, row, col)
        yield q0, pd, p * (dp - delta[:, :, rows, None]) * scale


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal, **channels):
    """Plain version of B7a: dQ ``[B, H, Sq, D]`` in q's dtype.
    ``channels``: B1's (``kv_bound``, ``kv_low``, ``bound_causal``,
    ``alibi_slopes``, segments) and dropout (``dropout_p``,
    ``dropout_seed``), as :func:`flash_attention_bwd` takes them."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    dq = [
        torch.matmul(ds, kf)
        for _, _, ds in _plain_chunks(q, k, v, dout, lse, delta, scale, causal, **channels)
    ]
    return torch.cat(dq, dim=2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal, **channels):
    """Plain version of B7b: dK, dV ``[B, Hk, Sk, D]`` in k's / v's dtype,
    summed over each kv head's group of q heads (``channels`` as B7a's)."""
    b, h, _, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, p, ds in _plain_chunks(q, k, v, dout, lse, delta, scale, causal, **channels):
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


def flash_bwd_plain(q, k, v, o, lse, dout, scale, causal, **channels):
    """Plain version of the one pass: dq, dk, dv in q's / k's / v's dtype.

    Walks 128-key tiles in order, as the kernel's CTAs do: per tile, P and
    dS over every q row (P recomputed from lse, 0 where lse is -inf or
    masked; ``dS = P * (dP - delta) * scale``; with dropout dV takes the
    dropped and rescaled P and dS the dropped and rescaled dP), each
    rounded to q's dtype before its product; dK, dV of the tile's keys,
    and dQ accumulated in fp32 tile after tile. dK, dV sum each kv head's
    group of q heads. ``channels``: B1's and dropout, as
    :func:`flash_attention_bwd` takes them.
    """
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    keys = _Keys(b, h, sq, sk, q.device, scale, causal, **channels)
    qf, dof = q.float(), dout.float()
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)  # [B, H, Sq, 1]
    lse2 = keys.lse2(lse)
    live = torch.isfinite(lse2)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    row = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, TILE_K):
        tile = slice(k0, k0 + TILE_K)
        kt, vt = kf[:, :, tile], vf[:, :, tile]
        col = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
        s = keys.scores(torch.matmul(qf, kt.transpose(-1, -2)), row, col)
        p = torch.where(live, torch.exp2(s - lse2), 0.0)
        dp = torch.matmul(dof, vt.transpose(-1, -2))
        pd, dp = keys.drop(p, dp, row, col)
        ds = (p * (dp - delta) * scale).to(q.dtype).float()
        p = pd.to(q.dtype).float()
        dv[:, :, tile] = torch.matmul(p.transpose(-1, -2), dof)
        dk[:, :, tile] = torch.matmul(ds.transpose(-1, -2), qf)
        dq += torch.matmul(ds, kt)
    dk = dk.view(b, hk, group, sk, d).sum(dim=2)
    dv = dv.view(b, hk, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# Head dims B1 and B7 are built for (BTLM's 80, GPT-NeoX-20B's 96, GPT-J's
# 256); those of B1 with its key range alone (kv_bound, kv_low,
# bound_causal: a KV cache's prefill and multi-token steps); those with
# every channel (ALiBi, segments) forwards, and with any channel backwards.
HEAD_DIMS = (64, 80, 96, 128, 256)
RANGE_HEAD_DIMS = (64, 80, 128, 256)
CHANNEL_HEAD_DIMS = (64, 80, 128)


def check_head_dim(d: int, channels: bool, name: str, key_range_only: bool = False) -> None:
    """Raise ``ValueError`` unless B1 and B7 are built at head dim ``d``
    (with B1's per-batch channels when ``channels``; ``key_range_only``:
    they are B1's key range alone, forwards), naming the ROADMAP item that
    would build it. Both wrappers call it before a launch."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not built (built: {HEAD_DIMS}; ROADMAP B-iii 4)")
    built = RANGE_HEAD_DIMS if key_range_only else CHANNEL_HEAD_DIMS
    if channels and d not in built:
        what = "kv_bound and kv_low" if key_range_only else \
            "kv_bound, kv_low, alibi_slopes and segments"
        raise ValueError(f"{name}: {what} at head dim {d} not built (built: {built}; "
                         "ROADMAP B-iii 4)")


# Head dims of B1's and B7's dropout instantiations.
DROPOUT_HEAD_DIMS = (64, 128)


def check_dropout(d: int, alibi: bool, segments: bool, name: str) -> None:
    """Raise ``NotImplementedError`` unless B1's and B7's dropout
    instantiations take this call on the card: the dense walk at head dim
    64 or 128, with or without the key range; not ALiBi or segments with
    dropout (ROADMAP B-i 5), nor another head dim (B-iii 4)."""
    if alibi or segments:
        what = "alibi_slopes" if alibi else "segments (varlen)"
        raise NotImplementedError(f"{name}: {what} with dropout is not built on the card "
                                  "(ROADMAP B-i 5)")
    if d not in DROPOUT_HEAD_DIMS:
        raise NotImplementedError(f"{name}: dropout at head dim {d} is not built on the card "
                                  f"(built: {DROPOUT_HEAD_DIMS}; ROADMAP B-iii 4)")


def check_segments(q_segments, kv_segments, b: int, sq: int, sk: int, per_batch: bool,
                   name: str) -> None:
    """Raise unless the segment ids are ``[1, Sq]`` and ``[1, Sk]`` at
    batch 1 (as JAX asserts), both given, and not combined with B1's
    per-batch channels (ROADMAP A11)."""
    if q_segments is None or kv_segments is None:
        raise ValueError(f"{name}: q_segments and kv_segments go together")
    if b != 1:
        raise ValueError(f"{name}: segment ids (varlen) take a packed batch of 1, got {b}")
    if tuple(q_segments.shape) != (1, sq) or tuple(kv_segments.shape) != (1, sk):
        raise ValueError(f"{name}: q_segments must be [1, {sq}] and kv_segments [1, {sk}], got "
                         f"{tuple(q_segments.shape)} and {tuple(kv_segments.shape)}")
    if per_batch:
        raise NotImplementedError(f"{name}: segments with kv_bound, kv_low or alibi_slopes are "
                                  "not ported yet (ROADMAP A11)")


def _check_cuda(q, k, v, o, lse, dout, channels):
    if any(x.device != q.device for x in (k, v, o, lse, dout)):
        raise ValueError("flash_bwd: all inputs must be on one device")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v, o, dout)):
        raise TypeError("the CUDA kernels take bf16 q, k, v, o, dout")
    if lse.dtype != torch.float32:
        raise TypeError("lse must be fp32")
    check_head_dim(q.shape[-1], channels, "flash_bwd")
    if not all(x.is_contiguous() for x in (q, k, v, o, lse, dout)):
        raise ValueError("the CUDA kernels take contiguous tensors")
    _build.check_aligned(q, k, v, o, dout)


# The most q-heads per kv-head of the ALiBi instantiation (its slopes sit in
# shared memory: flash_bwd.cu:kMaxGroup).
MAX_ALIBI_GROUP = 256


def flash_bwd(q, k, v, o, lse, dout, scale: float, causal: bool, kv_bound=None, kv_low=None,
              bound_causal: bool = False, alibi_slopes=None, q_segments=None, kv_segments=None,
              segment_walk=None, dropout_p: float = 0.0, dropout_seed=None):
    """B7: dq, dk, dv from q, k, v, the forward's o and lse (``[B, H, Sq]``
    fp32, natural log) and dO, in one pass (three launches); with B1's
    per-batch channels (``kv_bound``/``kv_low`` ``[B]``, ``alibi_slopes``
    ``[B, H]`` or ``[H]``) on the RANGE / ALIBI instantiations, with segment
    ids (``[1, Sq]``, ``[1, Sk]``; ``segment_walk`` their
    :class:`~liteattention_torch.ops.segments.SegmentWalk` if the forward
    made it) on the segment kernel, with ``dropout_p`` > 0 (the forward's
    ``dropout_seed``) on the DROPOUT instantiations (the key range too)."""
    bound_causal = bool(bound_causal and kv_bound is not None)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, dout, scale, causal, kv_bound=kv_bound,
                               kv_low=kv_low, bound_causal=bound_causal,
                               alibi_slopes=alibi_slopes, q_segments=q_segments,
                               kv_segments=kv_segments, dropout_p=dropout_p,
                               dropout_seed=dropout_seed)
    dropout = dropout_p > 0.0
    if dropout:
        check_dropout(q.shape[-1], alibi_slopes is not None, q_segments is not None, "flash_bwd")
    plain = kv_bound is None and kv_low is None and alibi_slopes is None and not dropout
    _check_cuda(q, k, v, o, lse, dout, channels=not plain or q_segments is not None)
    if q_segments is not None:
        if segment_walk is None:
            segment_walk = segments.segment_walk(q_segments.to(q.device),
                                                 kv_segments.to(q.device))
        return _flash_bwd_segments(q, k, v, o, lse, dout, scale, causal, segment_walk)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    sq_pad = -(-sq // TILE_Q) * TILE_Q
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_accum = torch.empty((b, h, sq_pad, d), dtype=torch.float32, device=q.device)
    lse2 = torch.empty((b, h, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    lib = _build.load_kernels()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_accum.data_ptr(),
            lse2.data_ptr(), delta.data_ptr())
    dims = (b, h, hk, sq, sk, d, float(scale), int(causal))
    dev = (q.device.index, _build.stream(q.device))
    if plain:
        _build.check(lib.lite_flash_bwd(*ptrs, *dims, *dev), "flash_bwd")
        flash_bwd.launches += 1
        return dq, dk, dv

    def per_batch(x):
        return None if x is None else x.to(q.device, torch.int32).reshape(b).contiguous()

    bound, low = per_batch(kv_bound), per_batch(kv_low)
    slopes = None
    if alibi_slopes is not None:
        if h // hk > MAX_ALIBI_GROUP:
            raise ValueError(f"flash_bwd: ALiBi takes at most {MAX_ALIBI_GROUP} q-heads per kv-head")
        slopes = alibi_slopes.to(q.device, torch.float32).reshape(-1, h).expand(b, h).contiguous()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    if dropout:
        seed = dropout_seed_tensor(dropout_seed, q.device)
        err = lib.lite_flash_bwd_dropout(*ptrs, ptr(bound), ptr(low), seed.data_ptr(), *dims,
                                         int(bound_causal), dropout_threshold(dropout_p),
                                         1.0 / (1.0 - dropout_p), *dev)
        _build.check(err, "flash_bwd_dropout")
        flash_bwd.dropout_launches += 1
        return dq, dk, dv
    err = lib.lite_flash_bwd_masked(*ptrs, ptr(bound), ptr(low), ptr(slopes), *dims,
                                    int(bound_causal), *dev)
    _build.check(err, "flash_bwd")
    if slopes is not None:
        flash_bwd.alibi_launches += 1
    else:
        flash_bwd.bound_launches += 1
    return dq, dk, dv


def _flash_bwd_segments(q, k, v, o, lse, dout, scale, causal, walk):
    """B7's segment kernel (batch 1; three launches), counted in
    ``flash_bwd.segment_launches``."""
    _, h, sq, d = q.shape
    sq_pad = -(-sq // TILE_Q) * TILE_Q
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_accum = torch.empty((1, h, sq_pad, d), dtype=torch.float32, device=q.device)
    lse2 = torch.empty((1, h, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    err = _build.load_kernels().lite_flash_bwd_segments(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_accum.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), walk.q.data_ptr(), walk.k.data_ptr(), walk.bwd_range.data_ptr(),
        walk.q_span.data_ptr(), walk.k_span.data_ptr(), h, k.shape[1], sq, k.shape[2], d,
        float(scale), int(causal), q.device.index, _build.stream(q.device),
    )
    _build.check(err, "flash_bwd_segments")
    flash_bwd.segment_launches += 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.bound_launches = 0
flash_bwd.alibi_launches = 0
flash_bwd.segment_launches = 0
flash_bwd.dropout_launches = 0

# Mask channels of the JAX function that the port does not take yet.
_UNPORTED = ("window", "softcap")


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, causal: bool, kv_bound=None,
                        bound_causal: bool = False, kv_low=None, alibi_slopes=None,
                        q_segments=None, kv_segments=None, segment_walk=None,
                        dropout_p: float = 0.0, dropout_seed=None, **channels):
    """dQ, dK, dV of the dense flash forward.

    ``q`` ``[B, H, Sq, D]``, ``k``/``v`` ``[B, Hk, Sk, D]``, ``o``/``do``
    like q, ``lse`` ``[B, H, Sq]`` fp32 natural log (the forward's, B1's
    with the same channels). B1's per-batch channels, with the JAX
    function's meanings: ``kv_bound`` ``[B]`` (the total valid key length;
    with ``bound_causal`` q row ``i`` sees keys ``< kv_bound - Sq + i + 1``;
    ``bound_causal`` without ``kv_bound`` does nothing), ``kv_low`` ``[B]``
    (the first valid key) and ``alibi_slopes`` ``[H]`` or ``[B, H]`` fp32
    (the bias ``-slope * |row + Sk - Sq - col|`` in log2 units, not scaled
    by ``scale``). ``q_segments`` ``[1, Sq]`` and ``kv_segments`` ``[1,
    Sk]``: a key is seen only by the rows of its id (batch 1, not with the
    per-batch channels: ROADMAP A11); ``segment_walk``, the forward's
    :class:`~liteattention_torch.ops.segments.SegmentWalk` of those ids, if
    it made one. ``dropout_p`` and ``dropout_seed``: the forward's
    attention dropout, whose keep mask B7 regenerates (``o`` is the dropped
    output, so delta is too); on the card head dim 64 or 128, not with
    ALiBi or segments (``NotImplementedError`` naming ROADMAP B-i 5 or
    B-iii 4). Passing one of the JAX function's other mask channels
    (window, softcap), even at its default, raises ``NotImplementedError``
    naming it.
    """
    unknown = set(channels) - set(_UNPORTED)
    if unknown:
        raise TypeError(f"flash_attention_bwd: unexpected arguments {sorted(unknown)}")
    if channels:
        raise NotImplementedError(
            f"flash_attention_bwd: {sorted(channels)} not ported yet (ROADMAP A11, B-i 3)")
    b, h = q.shape[:2]
    for name, x, shapes in (("kv_bound", kv_bound, [(b,)]), ("kv_low", kv_low, [(b,)]),
                            ("alibi_slopes", alibi_slopes, [(h,), (b, h)])):
        if x is not None and tuple(x.shape) not in shapes:
            raise ValueError(f"{name} must be one of {shapes}, got {tuple(x.shape)}")
    if q_segments is not None or kv_segments is not None:
        check_segments(q_segments, kv_segments, b, q.shape[2], k.shape[2],
                       kv_bound is not None or kv_low is not None or alibi_slopes is not None,
                       "flash_attention_bwd")
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    if dropout_p > 0.0:
        dropout_threshold(dropout_p)  # checks 0 <= p < 1
    return flash_bwd(q, k, v, o, lse.contiguous(), do, scale, causal, kv_bound=kv_bound,
                     kv_low=kv_low, bound_causal=bound_causal, alibi_slopes=alibi_slopes,
                     q_segments=q_segments, kv_segments=kv_segments, segment_walk=segment_walk,
                     dropout_p=dropout_p, dropout_seed=dropout_seed)


__all__ = [
    "CHANNEL_HEAD_DIMS",
    "DROPOUT_HEAD_DIMS",
    "HEAD_DIMS",
    "RANGE_HEAD_DIMS",
    "causal_mask",
    "check_dropout",
    "check_head_dim",
    "check_segments",
    "flash_attention_bwd",
    "flash_bwd",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_plain",
]
