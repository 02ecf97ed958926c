"""Dense flash-attention forward (kernel B1), differentiable.

Counterpart of ``liteattention_tpu/ops/flash_fwd.py:flash_attention``.

Kernel: ``csrc/flash_fwd.cu:flash_fwd_kernel``, replacing the Pallas
kernel ``liteattention_tpu/ops/flash_fwd.py:_fwd_kernel``. One CTA per (b,
h, 128-row q-tile), two warpgroups of 64 rows: TMA loads Q once and the
128-key K/V tiles through a three-stage mbarrier ring, S = Q K^T and
O += P V run on wgmma, and each warpgroup's exp2 online softmax of tile
j + 1 runs while its P V of tile j is in flight. With ``causal`` it stops
at the diagonal (bottom-right aligned, offset ``Sk - Sq``), so the tiles
above it cost nothing. What bounds it on the H100: tensor-core issue (each
K/V byte feeds 128 q rows), then the exp2 of the softmax.

The gradient is a ``torch.autograd.Function`` whose backward is the pair
of kernels B7a/B7b (:mod:`liteattention_torch.ops.flash_bwd`); the lse
cotangent is ignored, as in the JAX ``custom_vjp``.

Takes bf16 on the card (any float dtype on the CPU), head dim 64, 80, 96,
128 or 256 (``flash_bwd.check_head_dim``; at 80 and 96 each tile takes two
64-value atoms, the second partly filled, and no product reads the
padding; at 256, GPT-J's, 64-key tiles in two stages), GQA, causal or
not. The wrapper runs the plain PyTorch version for CPU
tensors and the kernel for CUDA tensors.

:func:`flash_attention_masked` adds B1's per-batch channels, differentiable:
the key range ``[kv_low[b], kv_bound[b])`` with ``bound_causal`` (bottom-
right causality against the bound: KV caches, right-padded batches) and
the ALiBi bias (``alibi_slopes`` ``[H]`` or ``[B, H]``), on the same kernel
(entry ``lite_flash_fwd_masked``; launches counted in
``flash_attention.bound_launches``, and with ALiBi in
``flash_attention.alibi_launches``). Their gradient runs B7 with the same
channels (``flash_attention_bwd``; counted in ``flash_bwd.bound_launches``
and ``.alibi_launches``); the channels themselves get no gradient, as in
JAX. The segment channel (``q_segments`` / ``kv_segments``, batch 1: a key
is seen by the rows of its id) runs B1's segment walk (entry
``lite_flash_fwd_segments``, counted in ``flash_attention.segment_launches``):
each 128-row q-tile walks only the key range its ids can meet
(:mod:`liteattention_torch.ops.segments`), and its gradient B7's segment
kernel (``flash_bwd.segment_launches``). With dropout (head dim 64 or
128), the window, the chunk or the cap (64, 128 or 256: what the varlen
functions pass over packed documents) the segment walk runs its
instantiations of those channels (source
``csrc/flash_fwd_segments_channels.cu``, at 256
``csrc/flash_fwd_d256_segments.cu``; entry
``lite_flash_fwd_segments_channels``, counted in
``flash_attention.segment_dropout_launches`` and
``.segment_window_launches``; the gradient in ``flash_bwd``'s counters of
the same names): the segment range narrowed by the window, the ids and the
window tested together per element. Attention dropout (``dropout_p``,
``dropout_seed``) runs B1's dropout instantiation (source
``csrc/flash_fwd_dropout.cu``, entry ``lite_flash_fwd_dropout``, counted in
``flash_attention.dropout_launches``): the dense walk, with the key range,
drops each score's P after the row sum by the counter hash of
:func:`dropout_keep_mask` (about eleven integer instructions a score, one
integer compare against :func:`dropout_threshold`), and its gradient runs
B7's. The window, ``attention_chunk`` and softcap channels run B1's window
instantiations (source ``csrc/flash_fwd_window.cu``, at head dim 256
``csrc/flash_fwd_d256_window.cu``; entry
``lite_flash_fwd_window``, counted in ``flash_attention.window_launches``):
the dense walk, with the key range, narrowed to the keys the q-tile's rows'
windows and chunks reach (a tile is masked per element only where it
crosses a row's interval edge), and softcap taking each tile to log2 units
as ``cap * tanh(s * scale / cap) * log2(e)`` before the mask; the gradient
(window and softcap; ``attention_chunk`` is forward-only, as in JAX) runs
B7's.

MLA shapes -- V with its own head dim, and/or the ``qv`` term that adds
``qv . v`` to the scores -- are forward only, as in JAX (entry
``lite_flash_fwd_mla``), built for (D, Dv, qv) = (192, 128, no), (576, 512,
no) and (64, 512, yes). (192, 128), DeepSeek's non-absorbed prefill, runs
on B1's own kernel with D 192 for Q and K and 128 for V (two ring stages
with separate K and V barriers; launches counted in
``flash_attention.mla_launches``). The V-512 shapes run on the split-O
kernel ``csrc/mla_fwd.cu:mla_fwd_kernel`` (B10's design: one CTA per 64 q
rows, S over the 576 score channels computed once per 64-key tile by one
warpgroup, O's 512 channels split over two; counted in
``flash_attention.mla_v512_launches``). Other pairs raise on the card
(ROADMAP B-i 7) and the backward raises. Through :func:`flash_attention_masked`
they take B1's key range (``kv_bound``, ``kv_low``, ``bound_causal``): at
(192, 128) as runtime data of B1's dense walk (counted in
``flash_attention.mla_bound_launches``), at V 512 on the split-O kernel's
RANGE instantiations (``flash_attention.mla_v512_bound_launches``); their
other channels raise (ROADMAP A11).

:func:`flash_attention_decode` is the decode entry (kernel B8, replacing
``liteattention_tpu/ops/flash_fwd.py:_decode_folded_kernel``): a few q rows
against a KV cache with per-batch bounds, through the split-KV kernel of
:mod:`liteattention_torch.ops.flash_decode`.
"""

from __future__ import annotations

from typing import Optional

import torch

from liteattention_torch.ops import _build
from liteattention_torch.ops.flash_bwd import (
    WINDOW_SIDE_MAX,
    causal_mask,
    check_dropout,
    check_head_dim,
    check_segments,
    check_window,
    flash_attention_bwd,
    softcap_scores,
    window_arg,
    window_hidden,
)
from liteattention_torch.ops.dropout import (
    dropout_keep,
    dropout_keep_mask,
    dropout_seed_tensor,
    dropout_threshold,
)
from liteattention_torch.ops.flash_decode import (
    decode_plain,
    launch_decode,
    pack_rows,
    quantize_rows,
    unpack_rows,
)
from liteattention_torch.ops.segments import segment_walk
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
    qv: Optional[torch.Tensor] = None,
    kv_bound: Optional[torch.Tensor] = None,
    kv_low: Optional[torch.Tensor] = None,
    bound_causal: bool = False,
    alibi_slopes: Optional[torch.Tensor] = None,
    q_segments: Optional[torch.Tensor] = None,
    kv_segments: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    window=None,
    attention_chunk: int = 0,
    softcap: float = 0.0,
):
    """Plain PyTorch version of the kernel: fp32 scores, exact softmax in
    log2 space (the kernel's and the plain lite version's form).

    ``q`` ``[B, H, Sq, D]``, ``k`` ``[B, Hk, Sk, D]``, ``v`` ``[B, Hk, Sk,
    Dv]``; with ``qv`` ``[B, H, Sq, Dv]`` the scores are ``q . k + qv .
    v``. B1's channels as :func:`flash_attention_masked` takes them: keys
    ``col < kv_bound[b]`` (``col < kv_bound[b] - Sq + row + 1`` with
    ``bound_causal``) and ``col >= kv_low[b]``; ALiBi subtracts ``slope *
    log2(e) * dist`` from the log2-space scores, ``dist = row + Sk - Sq -
    col`` (``|dist|`` unless ``causal``), as the JAX kernel does, less the
    constant ``shift = Sk - kv_bound[b]`` with ``bound_causal`` (no visible
    key is nearer: the kernel's form, which keeps the scores over a large,
    mostly empty cache precise in fp32), which is added back to lse. With
    ``q_segments`` ``[B, Sq]`` and ``kv_segments`` ``[B, Sk]`` a key is
    seen only by the rows of its id. With ``dropout_p`` > 0 the JAX
    kernel's attention dropout: P, unnormalised, keeps the entries of
    :func:`dropout_keep_mask` at ``dropout_seed`` (``bh = b * H + h``, the
    global q row and key column) after its row sum ``l`` is taken, and the
    output is scaled by ``1 / (1 - p)``; lse stays dropout-free. JAX's
    ``window`` (left, right), ``attention_chunk`` and ``softcap``: the row's
    position ``pos = row + kv_bound[b] - Sq`` with ``kv_bound`` (else ``row
    + Sk - Sq``) sees keys ``[pos - left, pos + right]`` (-1: unbounded)
    and ``[floor(pos / c) c, + c)`` (:func:`~liteattention_torch.ops.
    flash_bwd.window_hidden`), and the scores are capped as ``cap *
    tanh(s * scale / cap)`` before ALiBi and the masks. Returns (out ``[B,
    H, Sq, Dv]`` in q's dtype, lse fp32 natural log). A row with no valid
    key gives out 0 and lse -inf. Query rows are processed in chunks so
    long sequences fit in memory.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    col = torch.arange(sk, device=q.device)
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).reshape(-1, h).expand(b, h)
        shift = torch.zeros(b, 1, 1, 1, device=q.device)
        if kv_bound is not None and bound_causal:
            shift = (sk - kv_bound.to(q.device)).clamp_min(0).float().reshape(b, 1, 1, 1)
        lse_shift = slopes[:, :, None, None] * shift
        slopes = (slopes * LOG2E)[:, :, None, None]
    if dropout_p > 0.0:
        seed = dropout_seed_tensor(dropout_seed, q.device)
        bh = (torch.arange(b, device=q.device)[:, None] * h
              + torch.arange(h, device=q.device))[:, :, None, None]
    window = window_arg(window)
    # The window's and the chunk's positions: bottom-right against the
    # bound, as JAX's.
    off = sk - sq if kv_bound is None else kv_bound.to(q.device).reshape(-1, 1, 1, 1) - sq
    outs, lses = [], []
    for q0 in range(0, sq, PLAIN_Q_CHUNK):
        qf = q[:, :, q0 : q0 + PLAIN_Q_CHUNK].float()
        row = torch.arange(q0, q0 + qf.shape[2], device=q.device)[:, None]
        s = torch.matmul(qf, kf.transpose(-1, -2))
        if qv is not None:
            s = s + torch.matmul(qv[:, :, q0 : q0 + PLAIN_Q_CHUNK].float(), vf.transpose(-1, -2))
        s = softcap_scores(s, scale, softcap)[0] if softcap else s * (scale * LOG2E)
        if alibi_slopes is not None:
            dist = (row + (sk - sq) - col).float()
            s = s - slopes * ((dist if causal else dist.abs()) - shift)
        if causal:
            s = s.masked_fill(causal_mask(q0, qf.shape[2], sq, sk, q.device), -torch.inf)
        if kv_bound is not None:
            end = kv_bound.to(q.device).reshape(-1, 1, 1, 1)
            s = s.masked_fill(col >= (end - sq + row + 1 if bound_causal else end), -torch.inf)
        if kv_low is not None:
            s = s.masked_fill(col < kv_low.to(q.device).reshape(-1, 1, 1, 1), -torch.inf)
        if q_segments is not None:
            qs = q_segments.to(q.device).reshape(b, 1, sq, 1)[:, :, q0 : q0 + qf.shape[2]]
            s = s.masked_fill(qs != kv_segments.to(q.device).reshape(b, 1, 1, sk), -torch.inf)
        if window is not None or attention_chunk:
            s = s.masked_fill(window_hidden(row, col, off, window, attention_chunk), -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        # A row with no valid key: every p is 0, not exp2 of the mask.
        p = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(dim=-1, keepdim=True)
        live = l > 0
        if dropout_p > 0.0:
            p = torch.where(dropout_keep(seed, bh, row, col, dropout_p), p, 0.0)
            o = torch.matmul(p, vf) * ((1.0 / (1.0 - dropout_p)) / torch.where(live, l, 1.0))
        else:
            o = torch.matmul(p, vf) / torch.where(live, l, 1.0)
        outs.append(o.to(q.dtype))
        lse = torch.where(live, m * LN2 + torch.log(l), -torch.inf)
        if alibi_slopes is not None:
            lse = lse - lse_shift
        lses.append(lse[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _check_inputs(q, k, v, qv=None):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError("q, k, v must be [B, H, S, D] with v [B, Hk, Sk, Dv] beside k")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"incompatible shapes {q.shape} / {k.shape}")
    if qv is not None and qv.shape != (b, h, sq, v.shape[3]):
        raise ValueError(f"qv must be [B, H, Sq, Dv] = {(b, h, sq, v.shape[3])}, got {qv.shape}")
    if any(x is not None and x.device != q.device for x in (k, v, qv)):
        raise ValueError("q, k, v (and qv) must be on one device")


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
    dropout_seed=None,
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

    MLA shapes (inference only, as in JAX): ``v`` ``[B, Hk, Sk, Dv]``
    with its own head dim, and/or ``qv`` ``[B, H, Sq, Dv]``, which adds
    ``qv . v`` to the scores; the output is ``[B, H, Sq, Dv]``. Their
    backward raises.

    ``dropout_p`` > 0: the JAX kernel's attention dropout, on B1's and
    B7's dropout instantiations (:func:`flash_attention_masked`, which
    says what they take); ``dropout_seed`` an int or int32 scalar (tensor
    on the device, read there; default 0, as in JAX). The MLA shapes are
    inference-only and take none.
    """
    if block_sizes is not None and block_sizes != BlockSizes(128, 128):
        raise ValueError(f"only BlockSizes(128, 128) is built, got {block_sizes}")
    if dropout_p > 0.0:
        return flash_attention_masked(q, k, v, scale=scale, causal=causal, return_lse=return_lse,
                                      dropout_p=dropout_p, dropout_seed=dropout_seed, qv=qv)
    _check_inputs(q, k, v, qv)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if v.shape[-1] != q.shape[-1] or qv is not None:
        out, lse = _FlashAttentionMLA.apply(q, k, v, qv, float(scale), bool(causal))
    else:
        out, lse = _FlashAttention.apply(q, k, v, float(scale), bool(causal))
    if return_lse:
        return out, lse
    return out


class _FlashAttentionMLA(torch.autograd.Function):
    """Forward through B1's MLA kernels (or the plain version); the MLA
    shapes are inference-only, so the backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, qv, scale, causal, kv_bound=None, kv_low=None, bound_causal=False):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        qv = None if qv is None else qv.contiguous()
        rng = dict(kv_bound=kv_bound, kv_low=kv_low, bound_causal=bound_causal)
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, causal, qv=qv, **rng)
        else:
            out, lse = _launch_mla(q, k, v, qv, scale, causal, **rng)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        raise NotImplementedError(
            "flash_attention: MLA shapes (V's own head dim, qv) are forward-only, as in JAX"
        )


# (D, Dv, qv) pairs of B1's MLA kernels.
MLA_SHAPES = ((192, 128, False), (576, 512, False), (64, 512, True))


def _launch_mla(q, k, v, qv, scale, causal, kv_bound=None, kv_low=None, bound_causal=False):
    """B1's MLA kernels on the card, with or without the key range; one
    launch, counted in ``flash_attention.mla_launches`` /
    ``.mla_v512_launches``, or with the range ``.mla_bound_launches`` /
    ``.mla_v512_bound_launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    tensors = [x for x in (q, k, v, qv) if x is not None]
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise TypeError("the CUDA kernel takes bf16 q, k, v (and qv)")
    b, h, sq, d = q.shape
    dv = v.shape[-1]
    if (d, dv, qv is not None) not in MLA_SHAPES:
        raise NotImplementedError(
            f"flash_attention: no MLA kernel for D {d}, Dv {dv}, qv {qv is not None}; "
            f"built (D, Dv, qv): {MLA_SHAPES} (ROADMAP B-i 7)"
        )
    _build.check_aligned(*tensors)

    def per_batch(x):
        return None if x is None else x.to(q.device, torch.int32).reshape(b).contiguous()

    bound, low = per_batch(kv_bound), per_batch(kv_low)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _build.load_kernels().lite_flash_fwd_mla(
        q.data_ptr(), ptr(qv), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        ptr(bound), ptr(low), b, h, k.shape[1], sq, k.shape[2], d, dv, float(scale),
        int(causal), int(bound_causal and bound is not None), q.device.index,
        _build.stream(q.device),
    )
    _build.check(err, "flash_fwd_mla")
    ranged = bound is not None or low is not None
    if dv == 512:
        if ranged:
            flash_attention.mla_v512_bound_launches += 1
        else:
            flash_attention.mla_v512_launches += 1
    elif ranged:
        flash_attention.mla_bound_launches += 1
    else:
        flash_attention.mla_launches += 1
    return out, lse


def _launch(q, k, v, scale, causal, kv_bound=None, kv_low=None, bound_causal=False,
            alibi_slopes=None, q_segments=None, kv_segments=None, walk=None, dropout_p=0.0,
            dropout_seed=None, window=None, attention_chunk=0, softcap=0.0):
    """B1 on the card, with or without its channels; one launch, counted
    in ``flash_attention.launches``, ``.bound_launches`` (bound or low),
    ``.alibi_launches``, ``.segment_launches`` (with segments ``walk``
    is the ids' :class:`~liteattention_torch.ops.segments.SegmentWalk`;
    with dropout ``.segment_dropout_launches``, with the window, chunk
    and / or softcap ``.segment_window_launches``), ``.dropout_launches``
    (dropout, with or without the key range) or ``.window_launches``
    (window, chunk and / or softcap, with or without the key range)."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the CUDA kernel takes bf16 q, k, v")
    b, h, sq, d = q.shape
    windowed = window is not None or attention_chunk > 0 or softcap > 0.0
    if windowed:
        check_window(d, window is not None or attention_chunk > 0, softcap > 0.0,
                     alibi_slopes is not None, dropout_p > 0.0, "flash_attention")
    if dropout_p > 0.0:
        check_dropout(d, alibi_slopes is not None, "flash_attention")
    check_head_dim(d, alibi_slopes is not None, "flash_attention")
    _build.check_aligned(q, k, v)
    if q_segments is not None:
        return _launch_segments(q, k, v, scale, causal, walk, dropout_p, dropout_seed, window,
                                attention_chunk, softcap)

    def per_batch(x):
        return None if x is None else x.to(q.device, torch.int32).reshape(b).contiguous()

    bound, low = per_batch(kv_bound), per_batch(kv_low)
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32).reshape(-1, h).expand(b, h).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    if windowed:
        left, right = (min(x, WINDOW_SIDE_MAX) for x in (window or (-1, -1)))
        err = _build.load_kernels().lite_flash_fwd_window(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            ptr(bound), ptr(low), b, h, k.shape[1], sq, k.shape[2], d, float(scale), int(causal),
            int(bound_causal), left, right, min(int(attention_chunk), WINDOW_SIDE_MAX),
            float(softcap), q.device.index, _build.stream(q.device),
        )
        _build.check(err, "flash_fwd_window")
        flash_attention.window_launches += 1
        return out, lse
    if dropout_p > 0.0:
        seed = dropout_seed_tensor(dropout_seed, q.device)
        err = _build.load_kernels().lite_flash_fwd_dropout(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            ptr(bound), ptr(low), seed.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d,
            float(scale), int(causal), int(bound_causal), dropout_threshold(dropout_p),
            1.0 / (1.0 - dropout_p), q.device.index, _build.stream(q.device),
        )
        _build.check(err, "flash_fwd_dropout")
        flash_attention.dropout_launches += 1
        return out, lse
    err = _build.load_kernels().lite_flash_fwd_masked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        ptr(bound), ptr(low), ptr(slopes), b, h, k.shape[1], sq, k.shape[2], d,
        float(scale), int(causal), int(bound_causal), q.device.index, _build.stream(q.device),
    )
    _build.check(err, "flash_fwd")
    if slopes is not None:
        flash_attention.alibi_launches += 1
    elif bound is not None or low is not None:
        flash_attention.bound_launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def _launch_segments(q, k, v, scale, causal, walk, dropout_p=0.0, dropout_seed=None,
                     window=None, attention_chunk=0, softcap=0.0):
    """B1's segment walk (batch 1): one launch, counted in
    ``flash_attention.segment_launches``; with dropout in
    ``.segment_dropout_launches``, with the window, the chunk and / or the
    cap in ``.segment_window_launches``."""
    _, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((1, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load_kernels()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            walk.q.data_ptr(), walk.k.data_ptr(), walk.fwd_range.data_ptr(),
            walk.k_span.data_ptr())
    dims = (h, k.shape[1], sq, k.shape[2], d, float(scale), int(causal))
    dev = (q.device.index, _build.stream(q.device))
    if dropout_p == 0.0 and window is None and not attention_chunk and softcap == 0.0:
        _build.check(lib.lite_flash_fwd_segments(*ptrs, *dims, *dev), "flash_fwd_segments")
        flash_attention.segment_launches += 1
        return out, lse
    if dropout_p > 0.0:
        seed = dropout_seed_tensor(dropout_seed, q.device)
        err = lib.lite_flash_fwd_segments_channels(
            *ptrs, seed.data_ptr(), *dims, -1, -1, 0, 0.0, dropout_threshold(dropout_p),
            1.0 / (1.0 - dropout_p), *dev)
        _build.check(err, "flash_fwd_segments_channels")
        flash_attention.segment_dropout_launches += 1
        return out, lse
    left, right = (min(x, WINDOW_SIDE_MAX) for x in (window or (-1, -1)))
    err = lib.lite_flash_fwd_segments_channels(
        *ptrs, None, *dims, left, right, min(int(attention_chunk), WINDOW_SIDE_MAX),
        float(softcap), 0, 1.0, *dev)
    _build.check(err, "flash_fwd_segments_channels")
    flash_attention.segment_window_launches += 1
    return out, lse


flash_attention.launches = 0
flash_attention.bound_launches = 0
flash_attention.alibi_launches = 0
flash_attention.segment_launches = 0
flash_attention.segment_window_launches = 0
flash_attention.segment_dropout_launches = 0
flash_attention.mla_launches = 0
flash_attention.mla_v512_launches = 0
flash_attention.mla_bound_launches = 0
flash_attention.mla_v512_bound_launches = 0
flash_attention.dropout_launches = 0
flash_attention.window_launches = 0


class _FlashAttentionMasked(torch.autograd.Function):
    """Forward through B1 with its channels (or the plain version),
    backward through B7 with the same channels. The channels get no
    gradient (None), as JAX's ``_flash_core_bwd`` gives none. The segment
    walk's ranges, computed once on the card, serve both; so does the
    dropout seed, which B7 reads to regenerate B1's keep mask. A gradient
    through ``attention_chunk`` raises: JAX's chunked forward has no
    backward (FA3's asserts the chunk away)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bound, kv_low, alibi, q_seg, kv_seg, seed, scale, causal,
                bound_causal, dropout_p, window, attention_chunk, softcap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        channels = dict(kv_bound=kv_bound, kv_low=kv_low, bound_causal=bound_causal,
                        alibi_slopes=alibi, q_segments=q_seg, kv_segments=kv_seg)
        if dropout_p > 0.0:
            channels.update(dropout_p=dropout_p, dropout_seed=seed)
        if window is not None or softcap > 0.0:
            channels.update(window=window, softcap=softcap)
        fwd_only = dict(attention_chunk=attention_chunk) if attention_chunk else {}
        walk = None
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, causal, **channels, **fwd_only)
        else:
            if q_seg is not None:
                walk = segment_walk(q_seg.to(q.device), kv_seg.to(q.device))
            out, lse = _launch(q, k, v, scale, causal, walk=walk, **channels, **fwd_only)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.channels, ctx.walk = scale, causal, channels, walk
        ctx.attention_chunk = attention_chunk
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        if ctx.attention_chunk:
            raise NotImplementedError(
                "flash_attention_masked: attention_chunk is forward-only, as in JAX (the "
                "chunked forward has no backward)")
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale, ctx.causal,
                                         segment_walk=ctx.walk, **ctx.channels)
        return (dq, dk, dv) + (None,) * 13


def flash_attention_masked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segments=None,
    kv_segments=None,
    kv_bound=None,
    kv_low=None,
    alibi_slopes=None,
    scale: Optional[float] = None,
    causal: bool = False,
    bound_causal: bool = False,
    window=None,
    attention_chunk: int = 0,
    softcap: float = 0.0,
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
    dropout_p: float = 0.0,
    dropout_seed=None,
    qv=None,
):
    """Counterpart of ``liteattention_tpu/ops/flash_fwd.py:
    flash_attention_masked`` (same arguments). The plain and causal forms
    go to :func:`flash_attention` (kernel B1, with its backward), and so do
    ``qv`` and a V of its own head dim, the MLA shapes.

    B1's per-batch channels run on the same kernel, and their gradient
    on B7 with the same channels (q, k and v get theirs; the channels get
    none, as in JAX):
    ``kv_bound`` ``[B]`` (the total valid key length per batch; with
    ``bound_causal`` q row ``i`` sees keys ``< kv_bound - Sq + i + 1``, the
    KV-cache append alignment; ``bound_causal`` without ``kv_bound`` does
    nothing, as in JAX), ``kv_low`` ``[B]`` (the first valid key) and
    ``alibi_slopes`` ``[H]`` or ``[B, H]`` fp32 (the bias ``-slope *
    |row + Sk - Sq - col|``, applied in log2 units as the JAX kernel does,
    not scaled by ``scale``). ``q_segments`` ``[1, Sq]`` and
    ``kv_segments`` ``[1, Sk]`` integer ids (batch 1, as in JAX): a key is
    seen only by the rows of its id (with ``causal``, at or below the
    bottom-right diagonal too). Any ids are taken; ids in order apart from
    negative markers (a packed batch) walk only their segments' tiles.
    On the card the key range and segments take head dim 64, 80, 96, 128
    and 256, forwards and backwards, and ALiBi all but 256 (ROADMAP B-iii
    4); segments do not combine with the per-batch channels (ROADMAP
    A11). The MLA shapes (``qv``, V's own head dim; forward only,
    as in JAX) take the key range alone, on B1's MLA kernels; their other
    channels raise (ROADMAP A11).

    ``dropout_p`` > 0 (with ``dropout_seed``, an int or int32 scalar,
    default 0): the JAX kernels' attention dropout, differentiable. B1
    drops P by :func:`dropout_keep_mask` after its row sum and folds ``1 /
    (1 - p)`` into the output; lse stays dropout-free; B7 regenerates the
    mask from the seed. On the card it runs B1's and B7's dropout
    instantiations (counted in ``flash_attention.dropout_launches`` and
    ``flash_bwd.dropout_launches``): head dim 64 or 128, causal or not,
    with the key range (``kv_bound``, ``kv_low``, ``bound_causal``) or
    without, or with segments (the segment walk's dropout instantiations,
    counted in ``flash_attention.segment_dropout_launches`` and
    ``flash_bwd.segment_dropout_launches``); with ALiBi it raises
    ``NotImplementedError`` naming ROADMAP B-i 5, with the window or the
    cap B-i 3's rest, at another head dim B-iii 4. The plain versions take
    it with every channel. A seed without ``dropout_p`` does
    nothing, as in JAX.

    ``window`` (left, right; -1: that side unbounded; (-1, -1) is no
    window), ``attention_chunk`` c > 0 and ``softcap`` > 0: JAX's sliding
    window, chunked attention and logit cap. Row ``i``'s position is ``pos
    = i + kv_bound[b] - Sq`` with ``kv_bound`` (else ``i + Sk - Sq``); it
    sees keys ``[pos - left, pos + right]`` and ``[floor(pos / c) c, + c)``
    (floored: ``pos`` is negative when ``Sq > Sk`` or the bound is short),
    intersected with causal and the other channels; the scores become
    ``softcap * tanh(s * scale / softcap)`` before the masks, and lse is
    taken from them. Window and softcap are differentiable (B7 multiplies
    dS by the cap's derivative ``1 - tanh^2``); ``attention_chunk`` is
    forward-only, as in JAX: a gradient through it raises. On the card
    they run B1's and B7's window instantiations (counted in
    ``flash_attention.window_launches`` and ``flash_bwd.window_launches``):
    head dim 64, 128 or 256 (Gemma-2's and Gemma-3's; B7 at 256 is
    ``csrc/flash_bwd_d256.cu``'s kernel), causal or not, with the key range
    (``kv_bound``,
    ``kv_low``, ``bound_causal``) or without, or with segments (the
    segment walk's window instantiations, counted in
    ``flash_attention.segment_window_launches`` and
    ``flash_bwd.segment_window_launches``); with ALiBi or dropout they
    raise ``NotImplementedError`` naming ROADMAP B-i 3's rest, at another
    head dim B-iii 4. The plain versions take them with every channel.
    ``block_sizes`` is a tiling knob of the JAX kernel, accepted and
    ignored (B1 runs 128 x 128)."""
    del block_sizes
    window = window_arg(window)
    attention_chunk = int(attention_chunk)
    if attention_chunk < 0 or softcap < 0.0:
        raise ValueError(f"attention_chunk and softcap must be >= 0, got {attention_chunk} and "
                         f"{softcap}")
    segments = q_segments is not None or kv_segments is not None
    dropout = dropout_p > 0.0
    windowed = window is not None or attention_chunk > 0 or softcap > 0.0
    if (kv_bound is None and kv_low is None and alibi_slopes is None and not segments
            and not dropout and not windowed):
        return flash_attention(q, k, v, scale=scale, causal=causal, return_lse=return_lse, qv=qv)
    _check_inputs(q, k, v, qv)
    if qv is not None or v.shape[-1] != q.shape[-1]:
        if alibi_slopes is not None or segments or dropout or windowed:
            raise NotImplementedError(
                "flash_attention_masked: alibi_slopes, segments, dropout, window, "
                "attention_chunk and softcap with the MLA shapes (qv, V's own head dim) are not "
                "ported (ROADMAP A11; the MLA shapes take the key range alone and are "
                "inference-only, as in JAX)"
            )
        b = q.shape[0]
        for name, x in (("kv_bound", kv_bound), ("kv_low", kv_low)):
            if x is not None and tuple(x.shape) != (b,):
                raise ValueError(f"{name} must be [B] = ({b},), got {tuple(x.shape)}")
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        out, lse = _FlashAttentionMLA.apply(
            q, k, v, qv, float(scale), bool(causal), kv_bound, kv_low,
            bool(bound_causal and kv_bound is not None),
        )
        return (out, lse) if return_lse else out
    seed = None
    if dropout:
        if attention_chunk:
            raise ValueError("flash_attention_masked: attention_chunk is inference-only, as in "
                             "JAX: no dropout with it")
        dropout_threshold(dropout_p)  # checks 0 <= p < 1
        seed = dropout_seed_tensor(dropout_seed, q.device)
    b, h = q.shape[:2]
    for name, x, shapes in (("kv_bound", kv_bound, [(b,)]), ("kv_low", kv_low, [(b,)]),
                            ("alibi_slopes", alibi_slopes, [(h,), (b, h)])):
        if x is not None and tuple(x.shape) not in shapes:
            raise ValueError(f"{name} must be one of {shapes}, got {tuple(x.shape)}")
    if segments:
        check_segments(q_segments, kv_segments, q.shape[0], q.shape[2], k.shape[2],
                       kv_bound is not None or kv_low is not None or alibi_slopes is not None,
                       "flash_attention_masked")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    out, lse = _FlashAttentionMasked.apply(
        q, k, v, kv_bound, kv_low, alibi_slopes, q_segments, kv_segments, seed, float(scale),
        bool(causal), bool(bound_causal and kv_bound is not None), float(dropout_p), window,
        attention_chunk, float(softcap),
    )
    if return_lse:
        return out, lse
    return out


def _decode(q, k_cache, v_cache, kv_bound, kv_low, scale, softcap, k_scale,
            v_scale, int8_mma, causal, num_splits, plain, cache_batch_idx=None):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("q must be [B, H, Sq, D], the caches [B, S, Hk, D] alike")
    b, h, sq, d = q.shape
    b_cache, s_max, hk = k_cache.shape[:3]
    if cache_batch_idx is not None and tuple(cache_batch_idx.shape) != (b,):
        raise ValueError(f"cache_batch_idx must be [B] = ({b},), got "
                         f"{tuple(cache_batch_idx.shape)}")
    if (cache_batch_idx is None and b_cache != b) or k_cache.shape[3] != d or h % hk:
        raise ValueError(f"incompatible shapes {q.shape} / {k_cache.shape}")
    group = h // hk
    if scale is None:
        scale = d**-0.5
    idx = None if cache_batch_idx is None else cache_batch_idx.to(q.device).long()
    q_scale = None
    if k_cache.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 caches need k_scale/v_scale [B, Hk, D] (ops/kv_quant)")
        if idx is not None:
            k_scale, v_scale = k_scale[idx], v_scale[idx]
        qf = q.float().reshape(b, hk, group, sq, d) * k_scale[:, :, None, None, :]
        q = qf.to(q.dtype).reshape(b, h, sq, d)
    qp = pack_rows(q, hk)
    if int8_mma and k_cache.dtype == torch.int8:
        qp, q_scale = quantize_rows(qp)
    if kv_bound is None:
        kv_bound = torch.full((b,), s_max, dtype=torch.int32, device=q.device)
    if plain or q.device.type == "cpu":
        kc, vc = (k_cache, v_cache) if idx is None else (k_cache[idx], v_cache[idx])
        o, lse = decode_plain(
            qp, kc.transpose(1, 2), vc.transpose(1, 2), kv_bound, kv_low,
            group, causal, scale, softcap, num_splits, q_scale=q_scale,
        )
        o = o.to(q.dtype)
    else:
        if cache_batch_idx is not None and k_cache.dtype == torch.int8:
            raise NotImplementedError(
                "flash_attention_decode: cache_batch_idx with int8 caches is not built on the "
                "card (JAX's flash_attn_with_kvcache refuses the combination)")
        o, lse, n = launch_decode(
            qp, k_cache, v_cache, (b_cache, s_max, hk), k_cache.stride()[:3],
            v_cache.stride()[:3], kv_bound, kv_low, group=group, causal=causal, scale=scale,
            softcap=softcap, num_splits=num_splits, capacity=s_max, batch_idx=cache_batch_idx,
            q_scale=q_scale,
        )
        if q_scale is not None:
            flash_attention_decode.int8_mma_launches += n
        elif cache_batch_idx is not None:
            flash_attention_decode.batch_idx_launches += n
        else:
            flash_attention_decode.launches += n
    if v_scale is not None:
        o = (o.float() * v_scale[:, :, None, :]).to(o.dtype)
    return unpack_rows(o, lse, h, sq)


def flash_attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_bound: Optional[torch.Tensor] = None,
    kv_low: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    int8_mma: bool = False,
    causal: bool = False,
    num_splits: int = 0,
    cache_batch_idx: Optional[torch.Tensor] = None,
):
    """Decode with a short q against a KV cache (kernel B8), inference only.

    Counterpart of ``liteattention_tpu/ops/flash_fwd.py:
    flash_attention_decode``. ``q`` ``[B, H, Sq, D]`` (a few query tokens
    and/or packed GQA rows); ``k_cache``/``v_cache`` ``[B, S_max, Hk, D]``
    in any strides with a unit channel stride, so a head-major ``[B, Hk,
    S_max, D]`` cache passes as ``cache.transpose(1, 2)`` without a
    copy. ``kv_bound``/``kv_low`` ``[B]`` bound the valid keys per batch
    (default all of ``S_max``). ``softcap`` > 0 caps the scores as
    ``cap * tanh(s / cap)``.

    int8 caches (``ops/kv_quant``) take ``k_scale``/``v_scale`` ``[B, Hk,
    D]``: q is multiplied by ``k_scale`` before the kernel and the
    output by ``v_scale`` after it, as in JAX; the kernel only casts int8
    to bf16 after the load. ``int8_mma`` (int8 caches; with bf16 caches it
    does nothing, as in JAX): JAX's reduced-precision QK, each packed q row
    quantized to int8 on the device as JAX does
    (:func:`~liteattention_torch.ops.flash_decode.quantize_rows`) and S =
    Q K^T taken as int8 x int8 -> int32 times the row's scale (the
    kernel's int8_mma instantiation, counted in
    ``flash_attention_decode.int8_mma_launches``); P V stays on the
    dequant path in bf16, as in JAX.

    Port extensions: ``causal`` adds bottom-right causality per q
    position (row ``qi`` sees ``col < bound - Sq + qi + 1``), used by
    ``flash_attn_with_kvcache`` for appends; ``num_splits`` n > 1 sizes
    the kernel's grid at n CTAs per (b, KV head, 16-row tile), about n
    splits each at uniform lengths (0 or 1: one CTA per SM, the splits
    balanced over the keys present); ``cache_batch_idx`` ``[B]``: q's
    batch row ``b`` attends the caches' row ``cache_batch_idx[b]`` (the
    caches may hold more rows than q), which the kernel reads in place,
    never gathering the pool (the kernel's cache_batch_idx instantiation,
    bf16 caches; counted in ``flash_attention_decode.batch_idx_launches``;
    with int8 caches it raises on the card, as JAX's API refuses the
    combination). The JAX function's TPU
    knobs (``block_sizes``, ``interpret``, ``folded``) have no counterpart.

    Returns ``(out [B, H, Sq, D] in q's dtype, lse [B, H, Sq] fp32)``. A
    row with no valid key gives out 0 and lse -inf. The wrapper runs the
    plain version for CPU tensors and the kernel for CUDA tensors (bf16
    q, bf16 or int8 caches, D 64, 80, 96, 128 or 256; ``int8_mma`` at 64,
    128 or 256).
    """
    return _decode(q, k_cache, v_cache, kv_bound, kv_low, scale, softcap, k_scale,
                   v_scale, int8_mma, causal, num_splits, False, cache_batch_idx)


def flash_attention_decode_plain(
    q, k_cache, v_cache, kv_bound=None, kv_low=None, scale=None, softcap=0.0,
    k_scale=None, v_scale=None, int8_mma=False, causal=False, num_splits=0,
    cache_batch_idx=None,
):
    """Plain PyTorch version of :func:`flash_attention_decode` on any
    device (fp32 scores, exact softmax; ``num_splits > 1`` cuts the keys
    into the kernel's pieces at that grid and merges them through
    ``combine_attention``)."""
    return _decode(q, k_cache, v_cache, kv_bound, kv_low, scale, softcap, k_scale,
                   v_scale, int8_mma, causal, num_splits, True, cache_batch_idx)


flash_attention_decode.launches = 0
flash_attention_decode.batch_idx_launches = 0
flash_attention_decode.int8_mma_launches = 0

__all__ = [
    "dropout_keep_mask",
    "flash_attention",
    "flash_attention_masked",
    "flash_attention_plain",
    "flash_attention_decode",
    "flash_attention_decode_plain",
]
