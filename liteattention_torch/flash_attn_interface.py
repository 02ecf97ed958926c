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
``dropout_seed``, B1's and B7's dropout instantiations, the packed forms
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
  ``[B, Hk, D]``. Every ``S_new`` goes through the kernel; its rows are
  tiled 16 at a time.
* **Paged cache** (``page_table``): the pools ``[num_pages, page_size,
  Hk, D]`` take the new rows by a scatter, then
  :func:`~liteattention_torch.ops.paged_attention.paged_attention_folded`
  (kernel B9b), bf16 or int8 with ``[Hk, D]`` scales.

``num_splits`` 0 or 1 sizes the kernel's grid at one CTA per SM, its
splits balanced over the keys present; n > 1 at n CTAs per (batch, KV
head, 16-row tile) (the result equals the unsplit one up to rounding).

Unlike JAX, the caches are updated in place (a copy of a multi-GB cache
per step would cost more than the step); the return value keeps JAX's
shape: ``out`` [, ``lse``] [, ``(k_cache, v_cache)`` when ``k`` is given].

Not ported yet (ROADMAP A13); each raises ``NotImplementedError`` naming
itself: varlen q (``cu_seqlens_q``, ``cu_seqlens_k_new``),
``rotary_cos``/``rotary_sin``, ``cache_batch_idx``, ``window_size``,
``attention_chunk``, the fp8 descales and ``int8_mma``. ``qv`` and a
``v_cache`` of another head dim than ``k_cache`` raise too: JAX serves
them through B1's per-batch bound channel at the MLA shapes, which the
port's B1 does not take with the bound (its bound, ALiBi and segment
channels, and B7's, run at head dims 64, 80 and 128, B1's bound also at
256, and not at the MLA shapes; ROADMAP A11). Head dim 256 (GPT-J) is
built for ``flash_attn_func`` and ``flash_attn_with_kvcache`` and their
backward (B1, B7 and the decode kernel); its ALiBi, segments (so the
varlen functions) and lite walks raise, naming ROADMAP B-iii 4. ALiBi with ``attn_read_list`` raises, as every mask
channel does on the skip path.

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
from liteattention_torch.ops.flash_bwd import check_head_dim
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
    does, so it is differentiable too. Causal (and the chunk) compare
    positions on the packed axis, which needs the same packing of q and k:
    ``cu_seqlens_q`` equal to ``cu_seqlens_k`` (checked on the host when
    they are not one tensor). ``max_seqlen_*``, ``num_splits``,
    ``pack_gqa``, ``deterministic``, ``sm_margin`` and ``block_sizes`` are
    accepted and ignored. ``dropout_p`` / ``dropout_seed``: attention
    dropout on the packed axis (the keep mask's rows and columns are packed
    positions, as in JAX); the plain versions take it on the CPU, and on
    the card it raises (segments with dropout are not built: ROADMAP B-i
    5). Window and softcap (ROADMAP B-i 3), ``qv`` and the fp8 descales
    raise; so does a head dim the segment kernels are not built for (64,
    80 and 128 are; B-iii 4). The packed
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
    for name, used in (("window_size", window is not None), ("softcap", bool(softcap))):
        if used:
            raise NotImplementedError(f"flash_attn_varlen_func: {name} is not ported yet "
                                      "(ROADMAP B-i 3)")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("q must be [total_q, H, D] and k, v [total_k, Hk, D]")
    check_head_dim(q.shape[-1], True, "flash_attn_varlen_func")
    tq, tk = q.shape[0], k.shape[0]
    if causal or attention_chunk:
        if tq != tk or (cu_seqlens_q is not cu_seqlens_k
                        and not torch.equal(cu_seqlens_q.cpu(), cu_seqlens_k.cpu())):
            raise ValueError("flash_attn_varlen_func: causal and attention_chunk need the same "
                             "packing of q and k (cu_seqlens_q == cu_seqlens_k)")
    seg_q, seg_k = varlen_segment_ids(cu_seqlens_q.to(q.device), cu_seqlens_k.to(q.device),
                                      tq, tk, seqused_q, seqused_k, attention_chunk)
    out, lse = flash_attention_masked(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None], v.transpose(0, 1)[None],
        q_segments=seg_q[None], kv_segments=seg_k[None], scale=softmax_scale, causal=causal,
        return_lse=True, dropout_p=dropout_p, dropout_seed=dropout_seed,
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


def _unported(roadmap="A13", **used) -> None:
    names = [name for name, on in used.items() if on]
    if names:
        raise NotImplementedError(
            f"flash_attn_with_kvcache: {', '.join(names)} not ported yet (ROADMAP {roadmap})"
        )


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
    S_new_k - S_new + i + 1``. ``scheduler_metadata``, ``pack_gqa``,
    ``sm_margin``, ``max_seqlen_q``, ``rotary_seqlens``,
    ``rotary_interleaved``, ``block_sizes`` and ``max_seqlen_k_new`` are
    scheduling or tiling knobs of other backends, accepted and ignored.
    """
    _unported(
        cu_seqlens_q=cu_seqlens_q is not None,
        cu_seqlens_k_new=cu_seqlens_k_new is not None,
        rotary_cos=rotary_cos is not None or rotary_sin is not None,
        cache_batch_idx=cache_batch_idx is not None,
        window_size=tuple(window_size) != (-1, -1),
        attention_chunk=bool(attention_chunk),
        descales=any(x is not None for x in (q_descale, k_descale, v_descale)),
        int8_mma=int8_mma,
    )
    _unported(
        "A11", qv=qv is not None,
        v_cache_head_dim=v_cache.shape[-1] != k_cache.shape[-1],
    )
    if kv_cache_layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown kv_cache_layout {kv_cache_layout!r}")
    if (k is None) != (v is None):
        raise ValueError("k and v are appended together")
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
    elif k_cache_scale is not None or v_cache_scale is not None:
        raise ValueError("cache scales go with int8 caches only")
    if cache_seqlens is None:
        cache_seqlens = 0
    if isinstance(cache_seqlens, int):
        cache_seqlens = torch.full((b,), cache_seqlens, dtype=torch.int32, device=dev)
    cache_seqlens = cache_seqlens.to(device=dev, dtype=torch.int32)
    appended = 0 if k is None else k.shape[1]
    pos = cache_seqlens.long()[:, None] + torch.arange(appended, device=dev)[None]

    if page_table is not None:
        if kv_cache_layout != "bshd":
            raise ValueError("page pools have their own layout; kv_cache_layout does not apply")
        if cache_leftpad is not None or softcap:
            raise ValueError("cache_leftpad / softcap do not apply to the paged route")
        num_pages, page_size, hk, d = k_cache.shape
        if k is not None:
            page_of = torch.gather(page_table.to(dev).long(), 1, pos // page_size).reshape(-1)
            slot = (pos % page_size).reshape(-1)
            k_cache[page_of, slot] = k.reshape(-1, hk, d).to(k_cache.dtype)
            v_cache[page_of, slot] = v.reshape(-1, hk, d).to(v_cache.dtype)
        res = paged_attention_folded(
            q, k_cache, v_cache, cache_seqlens + appended, page_table,
            scale=softmax_scale, causal=causal, return_lse=True,
            k_scale=k_cache_scale, v_scale=v_cache_scale, num_splits=num_splits,
        )
        out, lse = res
    else:
        # The kernel reads [B, S, Hk, D] through strides: a head-major
        # cache passes as a transposed view.
        kv = k_cache.transpose(1, 2) if kv_cache_layout == "bhsd" else k_cache
        vv = v_cache.transpose(1, 2) if kv_cache_layout == "bhsd" else v_cache
        if k is not None:
            bi = torch.arange(b, device=dev)[:, None]
            kv[bi, pos] = k.to(kv.dtype)
            vv[bi, pos] = v.to(vv.dtype)
        out, lse = flash_attention_decode(
            q.transpose(1, 2), kv, vv, kv_bound=cache_seqlens + appended,
            kv_low=cache_leftpad, scale=softmax_scale, softcap=softcap,
            k_scale=k_cache_scale, v_scale=v_cache_scale, causal=causal,
            num_splits=num_splits,
        )
        out = out.transpose(1, 2)
    result = [out]
    if return_softmax_lse:
        result.append(lse)
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
