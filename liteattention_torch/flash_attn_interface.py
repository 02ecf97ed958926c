"""The flash-attention functional API: ``flash_attn_func`` and its packed
forms, ``flash_attn_varlen_func`` and its packed forms,
``flash_attn_with_kvcache``, ``flash_mla_with_kvcache``,
``flash_attn_combine`` and ``get_scheduler_metadata``.

Counterpart of ``liteattention_tpu/flash_attn_interface.py`` (same
argument order), taking the reference's ``[batch, seq, heads, dim]``
layout (the varlen functions its packed ``[total, heads, dim]``).

``flash_attn_func`` (and ``flash_attn_qkvpacked_func`` /
``flash_attn_kvpacked_func``) is the original LiteAttention's kernel API:
FA3 with the skip extras ``attn_read_list`` and ``thr``. Without a mask
it is dense attention through
:func:`~liteattention_torch.ops.flash_fwd.flash_attention_masked` (kernel
B1, plain or causal; with ``alibi_slopes`` ``[H]`` or ``[B, H]``, B1's
ALiBi channel, its gradient through B7's; with ``dropout_p`` and
``dropout_seed``, B1's and B7's dropout instantiations; with
``window_size``, ``attention_chunk`` and ``softcap``, B1's window
instantiations and, for window and softcap, B7's for the gradient
(``attention_chunk`` is forward-only, as in JAX); the packed forms
too). With a dense bool tile mask ``attn_read_list`` its
granularity is read from its shape, as in JAX: at fine 128 x 128 tiles
the packer B2 and the gather kernel B3 run (one 128-row q-tile per CTA,
vote step ``block_k / 128``); at the ``block_sizes`` compute tile the
coarse kernel B4 runs. The votes are folded into the returned mask by
``update_mask`` (JAX returns the mask instead of writing
``attn_write_list`` in place; so does the port). ``qv`` and a V of its own
head dim (the MLA shapes, dense only) go to B1's MLA instantiation, with
the default scale ``(D + Dv)^-0.5`` when ``qv`` is given, as in JAX.

``flash_attn_with_kvcache`` routes on the decode kernel of
:mod:`liteattention_torch.ops.flash_decode`:

* **Contiguous cache** (``kv_cache_layout`` "bshd" ``[B, S_max, Hk, D]``
  or "bhsd" ``[B, Hk, S_max, D]``): new ``k``/``v`` ``[B, S_new, Hk, D]``
  are written at ``cache_seqlens``, then
  :func:`~liteattention_torch.ops.flash_fwd.flash_attention_decode`
  (kernel B8) attends over ``[cache_leftpad, cache_seqlens + S_new)``
  with bottom-right causality per q position when ``causal``, optional
  ``softcap``, int8 caches with ``k_cache_scale``/``v_cache_scale``
  ``[B, Hk, D]`` (``int8_mma``: B8's int8 x int8 QK). Every ``S_new`` goes
  through the kernel; its rows are tiled 16 at a time. ``cache_batch_idx``
  picks each q batch row's slot of the caches; B8 reads the slot in place.
  A step with ``window_size`` or ``attention_chunk``, single-token or
  not, goes to B1's key range with the window
  (``flash_attention_masked(kv_bound=total, kv_low=cache_leftpad,
  bound_causal=causal, window=, attention_chunk=, softcap=)``), as JAX's
  does; so does a step with ``qv`` or a ``v_cache`` of its own head dim,
  on B1's MLA kernels (built at ``ops/flash_fwd.py:MLA_SHAPES``; other
  pairs raise on the card, naming ROADMAP B-i 7). Those routes gather
  ``cache_batch_idx``'s slots first, as JAX does.
* **Paged cache** (``page_table``): the pools ``[num_pages, page_size,
  Hk, D]`` take the new rows by a scatter, then
  :func:`~liteattention_torch.ops.paged_attention.paged_attention_folded`
  (kernel B9b), bf16 or int8 with ``[Hk, D]`` scales (and ``int8_mma``).
  ``window_size``, ``attention_chunk``, ``cache_batch_idx``, ``qv`` and a
  V of its own head dim raise there, as JAX asserts.

Rotary (``rotary_cos``/``rotary_sin``, ``rotary_seqlens``,
``rotary_interleaved``) rotates q and the new k in plain PyTorch before
the append, at JAX's positions. Varlen q (``cu_seqlens_q``,
``cu_seqlens_k_new``) pads each sequence right-aligned onto the
fixed-shape routes, as JAX does. ``num_splits`` 0 or 1 sizes the decode
kernel's grid at one CTA per SM, its splits balanced over the keys
present; n > 1 at n CTAs per (batch, KV head, 16-row tile) (the result
equals the unsplit one up to rounding).

Unlike JAX, the caches are updated in place (a copy of a multi-GB cache
per step would cost more than the step); the return value keeps JAX's
shape: ``out`` [, ``lse``] [, ``(k_cache, v_cache)`` when ``k`` is given].
The fp8 descales raise, as JAX asserts. Head dims 80 and 96 (Pythia,
GPT-NeoX) are built for every function here and their backward (B1, B7
and the decode kernel, with ALiBi, segments and the key range); their
dropout, window, softcap and lite walks raise, naming ROADMAP B-iii 4,
and ``int8_mma`` raises there, as JAX's asserts ``d % 128 == 0``. Head
dim 256 (GPT-J, Gemma-2, Gemma-3) is built for ``flash_attn_func``, the
varlen functions and ``flash_attn_with_kvcache`` and their backward (B1,
B7 and the decode kernel), with the key range, segments, the window /
``attention_chunk`` and softcap (Gemma-2's local and global layers, Gemma-3's
local ones); its ALiBi, dropout and lite walks raise, naming ROADMAP B-iii
4. ALiBi with
``attn_read_list`` raises, as every mask channel does on the skip path.

``flash_attn_varlen_func`` (and ``flash_attn_varlen_qkvpacked_func`` /
``flash_attn_varlen_kvpacked_func``) attends over packed sequences
``[total, H, D]`` with ``cu_seqlens``: the boundaries become segment ids
(:func:`varlen_segment_ids`, as JAX makes them) and the call runs B1's
segment channel, and B7's for the gradient.

``flash_mla_with_kvcache`` is absorbed-MLA decode over one latent cache
(:func:`~liteattention_torch.ops.mla.mla_decode`, kernel B10).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from liteattention_torch.ops.combine import combine_attention
from liteattention_torch.ops.flash_bwd import check_head_dim, window_arg
from liteattention_torch.ops.flash_fwd import flash_attention_decode, flash_attention_masked
from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
from liteattention_torch.ops.mask import SkipMaskState, cdiv, compact_mask, update_mask
from liteattention_torch.ops.mla import mla_decode
from liteattention_torch.ops.paged_attention import paged_attention_folded
from liteattention_torch.ops.schedule_pack import pack_schedule
from liteattention_torch.ops.tile_sizes import VOTE_TILE, BlockSizes, get_block_sizes


def _bhsd(x):
    return None if x is None else x.transpose(1, 2)


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    qv=None,
    q_descale=None,
    k_descale=None,
    v_descale=None,
    window_size: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
    softcap: float = 0.0,
    num_splits: int = 1,
    pack_gqa=None,
    deterministic: bool = False,
    sm_margin: int = 0,
    attn_read_list: Optional[torch.Tensor] = None,
    attn_must_do_list: Optional[torch.Tensor] = None,
    attn_write_list=None,
    thr: float = -3.0,
    return_softmax_lse: bool = False,
    return_skip_mask: bool = False,
    alibi_slopes: Optional[torch.Tensor] = None,
    block_sizes: Optional[BlockSizes] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
):
    """Attention forward, dense or skip-masked.

    Args:
      q, k, v: ``[batch, seqlen, heads, head_dim]``; GQA/MQA by fewer KV
        heads.
      attn_read_list: optional bool skip mask ``[B, H, Qt, Kt]`` at fine
        (128 x 128) or ``block_sizes`` granularity; the sparse kernels run
        and the votes evolve the returned mask.
      attn_must_do_list: bool, broadcastable to the mask: tiles never newly
        skipped.
      thr: skip threshold (log2 space).
      dropout_p, dropout_seed: attention dropout of the dense path (the
        skip path is inference-only and raises with it, as in JAX).
      return_skip_mask: also return the evolved mask.
      num_splits, pack_gqa, deterministic, sm_margin, attn_write_list:
        scheduling knobs and the in-place write list of other backends,
        accepted and ignored.

    Returns:
      ``out`` plus optionally ``lse`` (fp32 ``[B, H, S]``) and the evolved
      mask, in that order.
    """
    del num_splits, pack_gqa, deterministic, sm_margin, attn_write_list
    if q_descale is not None or k_descale is not None or v_descale is not None:
        raise NotImplementedError("flash_attn_func: fp8 descales are not supported")
    qh, kh, vh = _bhsd(q), _bhsd(k), _bhsd(v)
    window = None if tuple(window_size) == (-1, -1) else tuple(window_size)
    if attn_read_list is None:
        if qv is not None and softmax_scale is None:
            softmax_scale = (q.shape[-1] + qv.shape[-1]) ** -0.5
        out, lse = flash_attention_masked(
            qh, kh, vh, alibi_slopes=alibi_slopes, scale=softmax_scale,
            causal=causal, window=window, attention_chunk=int(attention_chunk),
            softcap=softcap, return_lse=True, dropout_p=dropout_p,
            dropout_seed=dropout_seed, qv=_bhsd(qv),
        )
        new_mask = None
    else:
        others = [name for name, used in (
            ("causal", causal), ("qv", qv is not None), ("window_size", window is not None),
            ("attention_chunk", bool(attention_chunk)), ("softcap", bool(softcap)),
            ("alibi_slopes", alibi_slopes is not None), ("dropout", dropout_p > 0.0),
        ) if used]
        if others:
            raise ValueError(
                f"skip-masked attention composes with none of: {', '.join(others)}"
            )
        read = attn_read_list.bool()
        sq, sk = q.shape[1], k.shape[1]
        bs = block_sizes or get_block_sizes(q.shape[-1], q.element_size(), kind="lite")
        bq = min(bs.block_q, max(VOTE_TILE, cdiv(sq, VOTE_TILE) * VOTE_TILE))
        bk = min(bs.block_k, max(VOTE_TILE, cdiv(sk, VOTE_TILE) * VOTE_TILE))
        grid = tuple(read.shape[-2:])
        fine_shape = (cdiv(sq, VOTE_TILE), cdiv(sk, VOTE_TILE))
        coarse_shape = (cdiv(sq, bq), cdiv(sk, bk))
        if grid == fine_shape:
            # One CTA per fine q-row: block_q 128, vote step block_k / 128.
            fidx, count = pack_schedule(read)
            out, lse, votes = lite_flash_attention(
                qh, kh, vh, fidx, count, thr, read, scale=softmax_scale,
                block_sizes=BlockSizes(VOTE_TILE, bk),
            )
        elif grid == coarse_shape:
            kv_idx, count = compact_mask(read)
            out, lse, votes = lite_flash_attention(
                qh, kh, vh, kv_idx, count, thr, scale=softmax_scale,
                block_sizes=BlockSizes(bq, bk), fine_schedule=False,
            )
        else:
            raise ValueError(
                f"attn_read_list tile grid {grid} matches neither fine "
                f"{fine_shape} nor coarse {coarse_shape} granularity"
            )
        must_do = None if attn_must_do_list is None else attn_must_do_list.bool()
        new_mask = update_mask(SkipMaskState(read, 0), votes, must_do=must_do).do_mask
    result = [out.transpose(1, 2)]
    if return_softmax_lse:
        result.append(lse)
    if return_skip_mask:
        result.append(new_mask)
    return result[0] if len(result) == 1 else tuple(result)


def flash_attn_qkvpacked_func(
    qkv: torch.Tensor,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    return_softmax_lse: bool = False,
    **kwargs,
):
    """Packed-QKV attention: ``qkv`` ``[B, S, 3, H, D]``."""
    return flash_attn_func(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], softmax_scale=softmax_scale,
        causal=causal, return_softmax_lse=return_softmax_lse, **kwargs,
    )


def flash_attn_kvpacked_func(
    q: torch.Tensor,
    kv: torch.Tensor,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    return_softmax_lse: bool = False,
    **kwargs,
):
    """Packed-KV attention: ``kv`` ``[B, S, 2, Hk, D]``."""
    return flash_attn_func(
        q, kv[:, :, 0], kv[:, :, 1], softmax_scale=softmax_scale, causal=causal,
        return_softmax_lse=return_softmax_lse, **kwargs,
    )


def varlen_segment_ids(
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    total_q: int,
    total_k: int,
    seqused_q: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    attention_chunk: int = 0,
):
    """The segment ids ``[total_q]``, ``[total_k]`` (int32, on the
    ``cu_seqlens`` device) that :func:`flash_attn_varlen_func` hands B1, as
    JAX makes them: token -> sequence index by ``searchsorted`` on the
    prefix sums (tokens past ``cu_seqlens[-1]`` form one more segment, the
    phantom segment ``B``); q tokens past ``seqused_q[i]`` of their
    sequence get -1 and keys past ``seqused_k[i]`` -2, ids no key or row
    carries, as do the phantom segment's tokens when ``seqused_*`` is
    given; ``attention_chunk`` c refines each live id to ``id * (total_q
    // c + 2) + local // c`` (chunk membership inside a sequence). No host
    sync."""
    ids = []
    for cu, total, used, dead in ((cu_seqlens_q, total_q, seqused_q, -1),
                                  (cu_seqlens_k, total_k, seqused_k, -2)):
        cu = cu.to(torch.int64)
        pos = torch.arange(total, device=cu.device)
        seg = torch.searchsorted(cu[1:].contiguous(), pos, right=True)
        local = pos - cu[seg]
        if used is not None:
            # JAX's take fills past the sequences: the phantom segment is dead.
            n = used.numel()
            lim = used.to(cu.device, torch.int64)[seg.clamp_max(n - 1)]
            seg = torch.where((seg < n) & (local < lim), seg, dead)
        if attention_chunk:
            chunk = int(attention_chunk)
            seg = torch.where(seg < 0, seg, seg * (total_q // chunk + 2) + local // chunk)
        ids.append(seg.to(torch.int32))
    return ids[0], ids[1]


def flash_attn_varlen_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    seqused_q: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    qv=None,
    q_descale=None,
    k_descale=None,
    v_descale=None,
    window_size: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
    softcap: float = 0.0,
    num_splits: int = 1,
    pack_gqa=None,
    deterministic: bool = False,
    sm_margin: int = 0,
    return_softmax_lse: bool = False,
    block_sizes: Optional[BlockSizes] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
):
    """Attention over packed sequences, differentiable in q, k, v.

    ``q`` ``[total_q, H, D]``, ``k``/``v`` ``[total_k, Hk, D]`` (GQA by
    fewer KV heads), ``cu_seqlens_*`` ``[B + 1]`` prefix sums. The
    sequence boundaries become segment ids (:func:`varlen_segment_ids`)
    and the call runs B1's segment channel (and B7's for the gradient):
    each q-tile walks only its sequences' keys. ``seqused_q``/``seqused_k``
    keep each sequence's first tokens (the other q rows give out 0 and lse
    -inf); ``attention_chunk`` folds chunk membership into the ids, as JAX
    does, so it is differentiable too. Causal, the window and the chunk
    compare positions on the packed axis, which needs the same packing of
    q and k: ``cu_seqlens_q`` equal to ``cu_seqlens_k`` (checked on the host
    when they are not one tensor). ``max_seqlen_*``, ``num_splits``,
    ``pack_gqa``, ``deterministic``, ``sm_margin`` and ``block_sizes`` are
    accepted and ignored. ``dropout_p`` / ``dropout_seed``: attention
    dropout on the packed axis (the keep mask's rows and columns are packed
    positions, as in JAX). ``window_size`` and ``softcap``: the sliding
    window about the packed position and the logit cap. On the card each of
    them, and the window with the cap, runs B1's and B7's segment
    instantiations of those channels (counted in
    ``flash_attention.segment_dropout_launches`` /
    ``.segment_window_launches`` and ``flash_bwd``'s counters of the same
    names): the window and the cap at head dim 64, 128 or 256 (Gemma's),
    dropout at 64 or 128; dropout with the window or the cap raises there
    (ROADMAP B-i 3's rest), and so do the window and the cap at head dim 80
    or 96, and dropout at 80, 96 or 256 (B-iii 4). The plain versions take
    every combination on the CPU. ``qv`` and the fp8 descales raise on
    every device; so does a head dim the segment kernels are not built for
    (64, 80, 96, 128 and 256 are; B-iii 4).
    The packed
    layout is copied to ``[1, H, total, D]`` for the kernel (reading it in
    place is ROADMAP B-i 6).

    Returns ``out`` ``[total_q, H, D]`` and, with ``return_softmax_lse``,
    lse ``[H, total_q]`` fp32.
    """
    del max_seqlen_q, max_seqlen_k, num_splits, pack_gqa, deterministic, sm_margin, block_sizes
    if qv is not None:
        raise NotImplementedError("flash_attn_varlen_func: qv is not supported (as in JAX)")
    if q_descale is not None or k_descale is not None or v_descale is not None:
        raise NotImplementedError("flash_attn_varlen_func: fp8 descales are not supported")
    window = None if tuple(window_size) == (-1, -1) else tuple(window_size)
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("q must be [total_q, H, D] and k, v [total_k, Hk, D]")
    check_head_dim(q.shape[-1], False, "flash_attn_varlen_func")
    tq, tk = q.shape[0], k.shape[0]
    if causal or window is not None or attention_chunk:
        if tq != tk or (cu_seqlens_q is not cu_seqlens_k
                        and not torch.equal(cu_seqlens_q.cpu(), cu_seqlens_k.cpu())):
            raise ValueError("flash_attn_varlen_func: causal, window_size and attention_chunk "
                             "need the same packing of q and k (cu_seqlens_q == cu_seqlens_k)")
    seg_q, seg_k = varlen_segment_ids(cu_seqlens_q.to(q.device), cu_seqlens_k.to(q.device),
                                      tq, tk, seqused_q, seqused_k, attention_chunk)
    out, lse = flash_attention_masked(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None], v.transpose(0, 1)[None],
        q_segments=seg_q[None], kv_segments=seg_k[None], scale=softmax_scale, causal=causal,
        window=window, softcap=softcap, return_lse=True, dropout_p=dropout_p,
        dropout_seed=dropout_seed,
    )
    out = out[0].transpose(0, 1).contiguous()
    return (out, lse[0]) if return_softmax_lse else out


def flash_attn_varlen_qkvpacked_func(
    qkv: torch.Tensor,
    cu_seqlens: torch.Tensor,
    max_seqlen: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    **kwargs,
):
    """Packed-QKV varlen attention: ``qkv`` ``[total, 3, H, D]``."""
    return flash_attn_varlen_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens, max_seqlen, max_seqlen,
        softmax_scale=softmax_scale, causal=causal, **kwargs,
    )


def flash_attn_varlen_kvpacked_func(
    q: torch.Tensor,
    kv: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    **kwargs,
):
    """Packed-KV varlen attention: ``kv`` ``[total_k, 2, Hk, D]``."""
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
        softmax_scale=softmax_scale, causal=causal, **kwargs,
    )


def _gather_rotary(tab: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``tab`` ``[seqlen_ro, rd / 2]``, ``pos`` int ``[B, S]`` -> fp32 ``[B,
    S, rd / 2]`` (JAX ``flash_attn_interface.py:_gather_rotary``). A
    position past the table (a padding row of a varlen batch, whose values
    are never used) reads its last row, where JAX's take reads NaN."""
    return tab.to(pos.device, torch.float32)[pos.long().clamp(0, tab.shape[0] - 1)]


def _apply_rotary_batched(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                          interleaved: bool) -> torch.Tensor:
    """Rotary with per-batch, per-position tables, as JAX's
    ``_apply_rotary_batched``: ``x`` ``[B, S, H, D]``, ``cos`` / ``sin``
    ``[B, S, rd / 2]``; the first ``2 (rd / 2)`` features rotate (pairs
    ``(2i, 2i + 1)`` when ``interleaved``, else the two halves), in fp32,
    cast back to ``x``'s dtype; the rest pass through."""
    ro = 2 * cos.shape[-1]
    xf = x[..., :ro].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        rot = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(xf.shape)
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        rot = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    rot = rot.to(x.dtype)
    return torch.cat([rot, x[..., ro:]], dim=-1) if ro < x.shape[-1] else rot


def _rotate(x, rotary_cos, rotary_sin, pos, interleaved):
    return _apply_rotary_batched(x, _gather_rotary(rotary_cos, pos),
                                 _gather_rotary(rotary_sin, pos), interleaved)


def _per_batch(x, b: int, dev) -> torch.Tensor:
    """An int or ``[B]`` tensor (None: 0) as int32 ``[B]`` on ``dev``."""
    if x is None:
        x = 0
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int32, device=dev)
    return x.to(device=dev, dtype=torch.int32)


def _refuse(message: str) -> None:
    raise NotImplementedError(f"flash_attn_with_kvcache: {message}")


def flash_attn_with_kvcache(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k: Optional[torch.Tensor] = None,
    v: Optional[torch.Tensor] = None,
    qv=None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    cache_seqlens: Optional[Union[int, torch.Tensor]] = None,
    cache_batch_idx: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    cu_seqlens_q: Optional[torch.Tensor] = None,
    cu_seqlens_k_new: Optional[torch.Tensor] = None,
    max_seqlen_q: Optional[int] = None,
    rotary_seqlens: Optional[torch.Tensor] = None,
    q_descale=None,
    k_descale=None,
    v_descale=None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
    softcap: float = 0.0,
    rotary_interleaved: bool = True,
    scheduler_metadata=None,
    num_splits: int = 1,
    pack_gqa=None,
    sm_margin: int = 0,
    return_softmax_lse: bool = False,
    block_sizes=None,
    kv_cache_layout: str = "bshd",
    k_cache_scale: Optional[torch.Tensor] = None,
    v_cache_scale: Optional[torch.Tensor] = None,
    max_seqlen_k_new: Optional[int] = None,
    int8_mma: bool = False,
):
    """Decode / append attention against a fixed-capacity KV cache.

    ``q`` ``[B, S_new, H, D]``; caches as the module docstring says;
    optional ``k``/``v`` ``[B, S_new_k, Hk, D]`` are appended at
    ``cache_seqlens`` (an int or ``[B]``; default 0) and attended.
    Bottom-right causality: q row ``i`` sees positions ``< cache_seqlens +
    S_new_k - S_new + i + 1``. ``window_size`` (left, right) and
    ``attention_chunk`` c, about the same position ``pos = cache_seqlens +
    S_new_k - S_new + i``: keys ``[pos - left, pos + right]`` and
    ``[floor(pos / c) c, + c)``, on the contiguous route (B1's window
    instantiation, as in JAX; on the card at head dims 64, 128 and 256, so
    Gemma-2's and Gemma-3's local layers), not with int8 caches (window) or
    ``num_splits`` > 1 (chunk), as JAX asserts. ``softcap`` alone (a
    Gemma-2 global layer) goes to the decode kernel, at 256 too.

    ``rotary_cos`` / ``rotary_sin`` ``[seqlen_ro, rd / 2]`` rotate q and the
    new k before the append, as JAX does (:func:`_apply_rotary_batched`):
    k at ``rot_base + i`` with ``rot_base`` = ``rotary_seqlens`` when given,
    else ``cache_seqlens``; q at the same positions when ``causal`` or with
    a window, else every row at ``rot_base``.

    ``cache_batch_idx`` ``[B]`` (contiguous caches): batch row ``b`` of q
    reads and appends to the caches' row ``cache_batch_idx[b]`` (a pool of
    slots); the decode kernel B8 reads the slots in place, B1's window /
    chunk and MLA routes gather the live slots' rows first, as JAX does.

    ``cu_seqlens_q`` ``[B + 1]`` (with ``max_seqlen_q``, required) takes q
    packed ``[total_q, H, D]``; ``cu_seqlens_k_new`` the new ``k`` / ``v``
    packed ``[total_k, Hk, D]`` (``max_seqlen_k_new``: their pad bound,
    default ``total_k``), with q packed or dense. As JAX does
    (:func:`_kvcache_varlen_q`), each sequence's q is padded right-aligned
    to ``max_seqlen_q`` (bottom-right causality is then exact on every real
    row), the ragged new rows are appended under their validity mask, the
    fixed-shape route runs, and ``out`` ``[total_q, H, Dv]`` and ``lse``
    ``[H, total_q]`` are re-packed. int8 caches refuse varlen q, as JAX
    asserts.

    ``qv`` ``[B, S_new, H, Dv]`` and a ``v_cache`` of its own head dim Dv
    (contiguous route; MLA decode) go to B1's MLA kernels with the key
    range (``flash_attention_masked(kv_bound=total, kv_low=cache_leftpad,
    bound_causal=causal, qv=)``); a single-token step folds the GQA group
    into q rows there (one CTA then reads each KV head's cache once).
    ``softmax_scale`` defaults to ``(D + Dv)^-0.5`` with ``qv``. ``qv``
    refuses ``page_table``, ``num_splits`` > 1 and ``k``, as JAX asserts.

    ``int8_mma`` (int8 caches, single-token steps, contiguous in either
    layout or paged): the decode kernels' int8 x int8 QK (q quantized per
    row on the device, as JAX does); JAX's reduced-precision mode.

    ``scheduler_metadata``, ``pack_gqa``, ``sm_margin``, ``block_sizes``
    are scheduling or tiling knobs of other backends, accepted and
    ignored. The fp8 descales raise, as JAX asserts.
    """
    if any(x is not None for x in (q_descale, k_descale, v_descale)):
        _refuse("fp8 descales are not supported (bf16 / fp32 kernels), as JAX asserts")
    window = window_arg(window_size)
    attention_chunk = int(attention_chunk)
    if page_table is not None and (window is not None or attention_chunk):
        used = [n for n, on in (("window_size", window is not None),
                                ("attention_chunk", attention_chunk)) if on]
        _refuse(f"{' and '.join(used)} on the paged route is not supported, as JAX asserts")
    if attention_chunk < 0:
        raise ValueError(f"attention_chunk must be >= 0, got {attention_chunk}")
    if attention_chunk and num_splits > 1:
        raise ValueError("attention_chunk composes with the unsplit cache path only (num_splits "
                         "<= 1), as JAX asserts")
    if kv_cache_layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown kv_cache_layout {kv_cache_layout!r}")
    if (k is None) != (v is None):
        raise ValueError("k and v are appended together")
    if qv is not None:
        used = [n for n, on in (("page_table", page_table is not None),
                                ("num_splits > 1", num_splits > 1), ("k", k is not None)) if on]
        if used:
            _refuse(f"qv with {', '.join(used)} is not supported: qv takes the contiguous unsplit "
                    "route without an append, as JAX asserts (absorbed MLA over a latent cache: "
                    "flash_mla_with_kvcache)")
        if softmax_scale is None:
            softmax_scale = (q.shape[-1] + qv.shape[-1]) ** -0.5
    if page_table is not None and cache_batch_idx is not None:
        _refuse("cache_batch_idx with page_table is not supported (the page table already "
                "indirects), as JAX asserts")
    rotary = (rotary_cos, rotary_sin, rotary_seqlens, rotary_interleaved)
    if (rotary_cos is None) != (rotary_sin is None):
        raise ValueError("rotary_cos and rotary_sin go together")
    if cu_seqlens_q is not None:
        return _kvcache_varlen_q(
            q, k_cache, v_cache, k, v, qv, rotary, cache_seqlens, cache_batch_idx,
            cache_leftpad, page_table, cu_seqlens_q, cu_seqlens_k_new, max_seqlen_q,
            max_seqlen_k_new, softmax_scale, causal, window_size, attention_chunk, softcap,
            num_splits, return_softmax_lse, kv_cache_layout,
        )
    if cu_seqlens_k_new is not None:
        # Dense q with ragged appends: q as a varlen batch of equal lengths
        # (its right-aligned padding is the identity). JAX's form fails later
        # with a reshape error without k; the port names the missing k.
        if k is None:
            raise ValueError("cu_seqlens_k_new describes the packed new k / v: pass k and v")
        b, sq, hq, d = q.shape
        cu_q = torch.arange(b + 1, dtype=torch.int32, device=q.device) * sq
        res = _kvcache_varlen_q(
            q.reshape(b * sq, hq, d), k_cache, v_cache, k, v, qv, rotary, cache_seqlens,
            cache_batch_idx, cache_leftpad, page_table, cu_q, cu_seqlens_k_new, sq,
            max_seqlen_k_new, softmax_scale, causal, window_size, attention_chunk, softcap,
            num_splits, return_softmax_lse, kv_cache_layout,
        )
        out, rest = res[0].reshape(b, sq, hq, -1), list(res[1:])
        if return_softmax_lse:
            rest[0] = rest[0].reshape(hq, b, sq).transpose(0, 1)  # [Hq, total] -> [B, Hq, Sq]
        return tuple([out] + rest)
    b, s_new = q.shape[:2]
    dev = q.device
    int8 = k_cache.dtype == torch.int8
    if int8:
        if k_cache_scale is None or v_cache_scale is None:
            raise ValueError(
                "int8 caches need k_cache_scale/v_cache_scale "
                "(ops/kv_quant: [B, Hk, D] contiguous, [Hk, D] paged)"
            )
        if k is not None or s_new != 1:
            raise ValueError(
                "int8 KV caches take the single-token decode step; append with "
                "ops/kv_quant.quantize_kv_append / quantize_pages_append before the call"
            )
        if window is not None:
            raise ValueError("int8 KV caches take no window_size, as JAX asserts")
        for name, used in (("cache_batch_idx", cache_batch_idx is not None),
                           ("rotary_cos", rotary_cos is not None)):
            if used:
                _refuse(f"{name} with int8 caches is not supported, as JAX asserts")
    elif k_cache_scale is not None or v_cache_scale is not None:
        raise ValueError("cache scales go with int8 caches only")
    cache_seqlens = _per_batch(cache_seqlens, b, dev)
    appended = 0 if k is None else k.shape[1]
    if rotary_cos is not None:
        rot_base = cache_seqlens if rotary_seqlens is None else _per_batch(rotary_seqlens, b, dev)
        if causal or window is not None:
            pos_q = rot_base[:, None] + torch.arange(s_new, device=dev)[None]
        else:
            pos_q = rot_base[:, None].expand(b, s_new)
        q = _rotate(q, rotary_cos, rotary_sin, pos_q, rotary_interleaved)
        if k is not None:
            pos_k = rot_base[:, None] + torch.arange(appended, device=dev)[None]
            k = _rotate(k, rotary_cos, rotary_sin, pos_k, rotary_interleaved)
    pos = cache_seqlens.long()[:, None] + torch.arange(appended, device=dev)[None]

    if page_table is not None:
        if kv_cache_layout != "bshd":
            raise ValueError("page pools have their own layout; kv_cache_layout does not apply")
        if cache_leftpad is not None or softcap:
            raise ValueError("cache_leftpad / softcap do not apply to the paged route")
        if v_cache.shape[-1] != k_cache.shape[-1]:
            _refuse("a v_cache of its own head dim on the paged route is not supported, as JAX "
                    "asserts (paged absorbed MLA: flash_mla_with_kvcache)")
        num_pages, page_size, hk, d = k_cache.shape
        if k is not None:
            page_of = torch.gather(page_table.to(dev).long(), 1, pos // page_size).reshape(-1)
            slot = (pos % page_size).reshape(-1)
            k_cache[page_of, slot] = k.reshape(-1, hk, d).to(k_cache.dtype)
            v_cache[page_of, slot] = v.reshape(-1, hk, d).to(v_cache.dtype)
        out, lse = paged_attention_folded(
            q, k_cache, v_cache, cache_seqlens + appended, page_table,
            scale=softmax_scale, causal=causal, return_lse=True,
            k_scale=k_cache_scale, v_scale=v_cache_scale, num_splits=num_splits,
            int8_mma=int8_mma,
        )
    else:
        # The kernels read [B, S, Hk, D] through strides: a head-major
        # cache passes as a transposed view.
        kv = k_cache.transpose(1, 2) if kv_cache_layout == "bhsd" else k_cache
        vv = v_cache.transpose(1, 2) if kv_cache_layout == "bhsd" else v_cache
        idx = None if cache_batch_idx is None else cache_batch_idx.to(dev).long()
        if k is not None:
            rows = torch.arange(b, device=dev) if idx is None else idx
            kv[rows[:, None], pos] = k.to(kv.dtype)
            vv[rows[:, None], pos] = v.to(vv.dtype)
        total = cache_seqlens + appended
        kv_low = cache_leftpad
        mla = qv is not None or v_cache.shape[-1] != k_cache.shape[-1]
        if window is not None or attention_chunk or mla:
            # B1's key range, with the window and chunk or at the MLA
            # shapes, as in JAX, for a single-token step too (head-major
            # [B, Hk, S, D]: a "bshd" cache with several KV heads is
            # copied); the live slots' rows are gathered.
            kh, vh = kv.transpose(1, 2), vv.transpose(1, 2)
            if idx is not None:
                kh, vh = kh[idx], vh[idx]
            out, lse = _cache_attention_b1(q, kh, vh, qv, total, kv_low, softmax_scale, causal,
                                           window, attention_chunk, softcap)
        else:
            out, lse = flash_attention_decode(
                q.transpose(1, 2), kv, vv, kv_bound=total, kv_low=kv_low, scale=softmax_scale,
                softcap=softcap, k_scale=k_cache_scale, v_scale=v_cache_scale, causal=causal,
                num_splits=num_splits, int8_mma=int8_mma, cache_batch_idx=cache_batch_idx,
            )
        out = out.transpose(1, 2)
    result = [out]
    if return_softmax_lse:
        result.append(lse)
    if k is not None:
        result.append((k_cache, v_cache))
    return result[0] if len(result) == 1 else tuple(result)


def _cache_attention_b1(q, kh, vh, qv, total, kv_low, scale, causal, window, attention_chunk,
                        softcap):
    """B1 over head-major caches ``[B, Hk, S, D]`` with the key range
    ``[kv_low, total)`` (bottom-right causal against ``total``), the window,
    chunk and cap; ``qv`` and V's own head dim take B1's MLA kernels. A
    single-token step without a window or chunk folds the GQA group into
    q rows, where bottom-right causality is ``col < total`` for every row,
    as JAX's decode route does. Returns out ``[B, H, S_new, Dv]`` and lse
    ``[B, H, S_new]``."""
    qh = q.transpose(1, 2)
    qvh = None if qv is None else qv.transpose(1, 2)
    b, h, s_new, d = qh.shape
    hk = kh.shape[1]
    if s_new == 1 and window is None and not attention_chunk and hk < h:
        fold = lambda x: x.reshape(b, hk, h // hk, x.shape[-1])  # noqa: E731
        out, lse = flash_attention_masked(
            fold(qh), kh, vh, kv_bound=total, kv_low=kv_low, scale=scale, softcap=softcap,
            return_lse=True, qv=None if qvh is None else fold(qvh),
        )
        return out.reshape(b, h, 1, -1), lse.reshape(b, h, 1)
    return flash_attention_masked(
        qh, kh, vh, kv_bound=total, kv_low=kv_low, scale=scale, bound_causal=causal,
        window=window, attention_chunk=attention_chunk, softcap=softcap, return_lse=True,
        qv=qvh,
    )


def _kvcache_varlen_q(q, k_cache, v_cache, k, v, qv, rotary, cache_seqlens, cache_batch_idx,
                      cache_leftpad, page_table, cu_seqlens_q, cu_seqlens_k_new, max_seqlen_q,
                      max_seqlen_k_new, softmax_scale, causal, window_size, attention_chunk,
                      softcap, num_splits, return_softmax_lse, kv_cache_layout):
    """Varlen-q kvcache attention by padding, as JAX's ``_kvcache_varlen_q``.

    ``q`` packed ``[total_q, H, D]`` with ``cu_seqlens_q`` ``[B + 1]``; new
    ``k`` / ``v`` packed ``[total_k, Hk, D]`` with ``cu_seqlens_k_new``.
    Each sequence's q rows are padded RIGHT-aligned to ``max_seqlen_q``
    (row ``r`` holds query ``r - (Lq - lq)``), so the bottom-right causal /
    window predicate ``col < total - Lq + r + 1`` is exactly ``col < total
    - lq + i + 1`` at every real row; the new rows are padded to
    ``max_seqlen_k_new`` and written where valid (contiguous caches in
    either layout, ``cache_batch_idx``'s slots, or pages); the fixed-shape
    route runs; the rows are re-packed (lse ``[H, total_q]``)."""
    rotary_cos, rotary_sin, rotary_seqlens, rotary_interleaved = rotary
    if max_seqlen_q is None:
        raise ValueError("cu_seqlens_q needs max_seqlen_q (the pad bound), as JAX requires")
    if k_cache.dtype == torch.int8:
        _refuse("varlen q (cu_seqlens_q / cu_seqlens_k_new) with int8 caches is not supported, "
                "as JAX asserts")
    dev = q.device
    b = cu_seqlens_q.numel() - 1
    lq = int(max_seqlen_q)
    cu_q = cu_seqlens_q.to(dev, torch.long)
    seqlens_q = cu_q[1:] - cu_q[:-1]
    total_q, hq, d = q.shape
    if softmax_scale is None:
        softmax_scale = (d + (0 if qv is None else qv.shape[-1])) ** -0.5
    cache_seqlens = _per_batch(cache_seqlens, b, dev)
    rows = torch.arange(lq, device=dev)
    lead = (lq - seqlens_q)[:, None]  # [B, 1] padding rows in front
    q_valid = rows[None] >= lead
    src_q = (cu_q[:-1, None] + rows[None] - lead).clamp(0, total_q - 1).reshape(-1)

    def pad_rows(packed):
        g = packed[src_q].reshape(b, lq, *packed.shape[1:])
        return torch.where(q_valid.reshape(b, lq, *[1] * (packed.dim() - 1)), g, 0)

    q_pad = pad_rows(q)
    qv_pad = None if qv is None else pad_rows(qv)
    rot_base = None
    if rotary_cos is not None:
        rot_base = cache_seqlens if rotary_seqlens is None else _per_batch(rotary_seqlens, b, dev)
    appended = torch.zeros(b, dtype=torch.int32, device=dev)
    if k is not None:
        if cu_seqlens_k_new is None:
            raise ValueError("varlen q with new k / v needs cu_seqlens_k_new")
        cu_k = cu_seqlens_k_new.to(dev, torch.long)
        seqlens_k = cu_k[1:] - cu_k[:-1]
        appended = seqlens_k.to(torch.int32)
        lk = int(max_seqlen_k_new if max_seqlen_k_new is not None else k.shape[0])
        rk = torch.arange(lk, device=dev)
        k_valid = rk[None] < seqlens_k[:, None]  # [B, Lk]
        src_k = (cu_k[:-1, None] + rk[None]).clamp(0, k.shape[0] - 1).reshape(-1)
        k_pad = k[src_k].reshape(b, lk, *k.shape[1:])
        v_pad = v[src_k].reshape(b, lk, *v.shape[1:])
        if rot_base is not None:
            pos_k = (rot_base.long()[:, None] + rk[None]).clamp_min(0)
            k_pad = _rotate(k_pad, rotary_cos, rotary_sin, pos_k, rotary_interleaved)
        pos = cache_seqlens.long()[:, None] + rk[None]
        if page_table is not None:
            psz = k_cache.shape[1]
            pos_c = pos.clamp(0, page_table.shape[1] * psz - 1)
            page_of = torch.gather(page_table.to(dev).long(), 1, pos_c // psz)
            slot = pos_c % psz
            k_cache[page_of[k_valid], slot[k_valid]] = k_pad[k_valid].to(k_cache.dtype)
            v_cache[page_of[k_valid], slot[k_valid]] = v_pad[k_valid].to(v_cache.dtype)
        else:
            kv = k_cache.transpose(1, 2) if kv_cache_layout == "bhsd" else k_cache
            vv = v_cache.transpose(1, 2) if kv_cache_layout == "bhsd" else v_cache
            slots = torch.arange(b, device=dev) if cache_batch_idx is None else \
                cache_batch_idx.to(dev).long()
            bi = slots[:, None].expand(b, lk)
            kv[bi[k_valid], pos[k_valid]] = k_pad[k_valid].to(kv.dtype)
            vv[bi[k_valid], pos[k_valid]] = v_pad[k_valid].to(vv.dtype)
    if rot_base is not None:
        if causal or window_arg(window_size) is not None:
            pos_q = (rot_base.long()[:, None] + rows[None] - lead).clamp_min(0)
        else:
            pos_q = rot_base.long()[:, None].expand(b, lq)
        q_pad = _rotate(q_pad, rotary_cos, rotary_sin, pos_q, rotary_interleaved)
    out_pad, lse_pad = flash_attn_with_kvcache(
        q_pad, k_cache, v_cache, qv=qv_pad, cache_seqlens=cache_seqlens + appended,
        cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad, page_table=page_table,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        attention_chunk=attention_chunk, softcap=softcap, num_splits=num_splits,
        return_softmax_lse=True, kv_cache_layout=kv_cache_layout,
    )
    # Re-pack: token t of sequence seg sits at padded row Lq - lq[seg] + (t - cu_q[seg]).
    tok = torch.arange(total_q, device=dev)
    seg = torch.searchsorted(cu_q[1:].contiguous(), tok, right=True).clamp(0, b - 1)
    row = (tok - cu_q[seg] + lq - seqlens_q[seg]).clamp(0, lq - 1)
    result = [out_pad.reshape(b * lq, hq, -1)[seg * lq + row]]
    if return_softmax_lse:
        result.append(lse_pad[seg, :, row].T.contiguous())
    if k is not None:
        result.append((k_cache, v_cache))
    return result[0] if len(result) == 1 else tuple(result)


def flash_mla_with_kvcache(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    page_table: Optional[torch.Tensor],
    cache_seqlens: torch.Tensor,
    head_dim_v: int,
    *metadata,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    return_softmax_lse: bool = True,
):
    """Absorbed-MLA decode against one latent KV cache (kernel B10).

    The signature of the external ``flash_mla_with_kvcache``: ``kv_cache``
    holds one latent row per token (one KV head); K is the whole row and V
    its first ``head_dim_v`` channels. ``page_table`` may be None for a
    contiguous ``[B, S, 1, D]`` cache. The tile-scheduler ``*metadata`` of
    other backends is accepted and ignored. Returns ``(out, lse)`` (out
    only with ``return_softmax_lse=False``); see
    :func:`~liteattention_torch.ops.mla.mla_decode`.
    """
    del metadata
    return mla_decode(
        q, kv_cache, cache_seqlens, head_dim_v, page_table=page_table,
        scale=softmax_scale, causal=causal, return_lse=return_softmax_lse,
    )


def flash_attn_combine(
    out_partial: torch.Tensor,
    lse_partial: torch.Tensor,
    return_lse: bool = False,
):
    """LSE-weighted merge of partial attentions over KV splits.

    ``out_partial`` ``[N, B, S, H, D]``, ``lse_partial`` ``[N, B, H, S]``
    (natural log). Returns out ``[B, S, H, D]`` in ``out_partial``'s dtype
    (and lse ``[B, H, S]`` fp32 with ``return_lse``); a row whose every
    split is empty gives out 0 and lse -inf.
    """
    out, lse = combine_attention(out_partial.movedim(3, 2), lse_partial, axis=0)
    out = out.movedim(1, 2)
    if return_lse:
        return out, lse
    return out


def get_scheduler_metadata(attn_read_list: torch.Tensor):
    """The compacted ``(kv_idx, count)`` schedule of a skip mask ``[B, H,
    Qt, Kt]`` (:func:`~liteattention_torch.ops.mask.compact_mask`), to
    amortize compaction when one mask drives several calls."""
    return compact_mask(attn_read_list)


__all__ = [
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_with_kvcache",
    "flash_mla_with_kvcache",
    "flash_attn_combine",
    "get_scheduler_metadata",
]
