"""Port parity: the rest of flash_attn_with_kvcache against the JAX package:
varlen q (cu_seqlens_q) and ragged appends (cu_seqlens_k_new) on contiguous
caches in both layouts and on page pools; rotary (interleaved and
half-split, partial rd, rotary_seqlens); cache_batch_idx over a pool of
slots; qv and a V of its own head dim, and B1's key range at the three MLA
shapes; int8_mma on contiguous caches and page pools.

fp32 numpy inputs from a seed; the JAX kernels run in interpret mode.
Tolerance: 2e-5 absolute on out and lse (summation order only), the updated
caches exactly equal, except int8_mma: its int8 q equals JAX's bit for bit,
and its outputs are held within 5e-3 absolute of JAX's int8_mma outputs
(JAX's int8_mma step rounds P to bf16 before P V, the port's plain version
keeps it in fp32: a relative error of 2^-9 on each weight) and within
JAX's own int8_mma bound of the exact dequant path, rel-L2 8e-2 (JAX
tests/test_kv_quant.py). The port updates its caches in place, so each call
gets its own copies.

The reference's fault (ROADMAP C): dense q with cu_seqlens_k_new and no k
fails in JAX with a reshape error; the port raises a ValueError naming the
missing k. test_dense_q_ragged_without_k states that difference.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.flash_attn_interface import flash_attn_with_kvcache as jkv  # noqa: E402
from liteattention_tpu.ops import kv_quant as jq  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache  # noqa: E402
from liteattention_torch.ops import kv_quant as pq  # noqa: E402
from liteattention_torch.ops.flash_decode import pack_rows, quantize_rows  # noqa: E402
from liteattention_torch.ops.flash_fwd import MLA_SHAPES, flash_attention_masked  # noqa: E402

TOL = 2e-5
H, HK, D = 4, 2, 64


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=0)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _both(*arrays):
    """numpy -> (JAX arrays, torch tensors); None passes through."""
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else t(a) for a in arrays])


def _caches(rng, route, b, s_max=96, d=D, dv=None, psz=16):
    """Caches of ``route`` ("bshd", "bhsd" or "paged": a shuffled page
    table) as numpy, with the page table (or None)."""
    dv = dv or d
    if route == "paged":
        pps = s_max // psz
        n_pages = b * pps + 3
        table = rng.permutation(n_pages)[: b * pps].reshape(b, pps).astype(np.int32)
        return _rand(rng, n_pages, psz, HK, d), _rand(rng, n_pages, psz, HK, dv), table
    kc, vc = _rand(rng, b, s_max, HK, d), _rand(rng, b, s_max, HK, dv)
    if route == "bhsd":
        kc, vc = kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy()
    return kc, vc, None


def _run_both(q, kc, vc, k=None, v=None, **kw):
    """The same call through JAX and the port (each on its own copies of the
    caches); returns (JAX result, port result, the port's cache tensors)."""
    names = [n for n, x in kw.items() if isinstance(x, np.ndarray)]
    (jq_, jk, jv, jkn, jvn), (pq_, pk, pv, pkn, pvn) = _both(q, kc, vc, k, v)
    jres = jkv(jq_, jk, jv, jkn, jvn, **{n: jnp.asarray(x) if n in names else x
                                         for n, x in kw.items()})
    pres = flash_attn_with_kvcache(pq_, pk, pv, pkn, pvn,
                                   **{n: t(x) if n in names else x for n, x in kw.items()})
    return jres, pres, (pk, pv)


def _check(jres, pres, caches=None):
    for j, p in zip(jres, pres):
        if isinstance(j, tuple):
            np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
            np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
            if caches is not None:
                assert p[0] is caches[0] and p[1] is caches[1]  # updated in place
        else:
            _close(p, j)


@pytest.mark.parametrize("route", ["bshd", "bhsd", "paged"])
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_q_matches_jax(route, causal):
    # Three sequences of 3, 1 and 4 new tokens (q and k alike) over prior
    # lengths 20, 50 and 0; max_seqlen_k_new pads the appends past the
    # longest.
    rng = np.random.RandomState(1 + causal)
    lq = [3, 1, 4]
    cu = np.cumsum([0] + lq).astype(np.int32)
    kc, vc, table = _caches(rng, route, len(lq))
    q, k, v = _rand(rng, cu[-1], H, D), _rand(rng, cu[-1], HK, D), _rand(rng, cu[-1], HK, D)
    kw = dict(cache_seqlens=np.array([20, 50, 0], np.int32), cu_seqlens_q=cu,
              cu_seqlens_k_new=cu, max_seqlen_q=4, max_seqlen_k_new=6, causal=causal,
              return_softmax_lse=True)
    if route == "paged":
        kw["page_table"] = table
    else:
        kw["kv_cache_layout"] = route
    jres, pres, caches = _run_both(q, kc, vc, k, v, **kw)
    assert pres[0].shape == (cu[-1], H, D) and pres[1].shape == (H, cu[-1])
    _check(jres, pres, caches)


def test_varlen_q_paged_and_rotary_matches_jax():
    # JAX's test_kvcache_varlen_q_paged_and_rotary: varlen q over a paged
    # pool with rotary on q and the new k, causal.
    rng = np.random.RandomState(3)
    lq = [3, 2]
    cu = np.cumsum([0] + lq).astype(np.int32)
    kc, vc, table = _caches(rng, "paged", 2, s_max=64, d=32)
    q, k, v = _rand(rng, 5, H, 32), _rand(rng, 5, HK, 32), _rand(rng, 5, HK, 32)
    ang = rng.uniform(0, 3.0, (64, 16)).astype(np.float32)
    jres, pres, caches = _run_both(
        q, kc, vc, k, v, rotary_cos=np.cos(ang), rotary_sin=np.sin(ang),
        cache_seqlens=np.array([9, 5], np.int32), page_table=table, cu_seqlens_q=cu,
        cu_seqlens_k_new=cu, max_seqlen_q=3, causal=True, return_softmax_lse=True)
    _check(jres, pres, caches)


@pytest.mark.parametrize("route", ["bshd", "paged"])
def test_dense_q_ragged_appends_matches_jax(route):
    # Dense q [B, 2, H, D] with 2, 1 and 0 new key rows a sequence.
    rng = np.random.RandomState(4)
    b, sq = 3, 2
    cu_k = np.array([0, 2, 3, 3], np.int32)
    kc, vc, table = _caches(rng, route, b)
    q, k, v = _rand(rng, b, sq, H, D), _rand(rng, 3, HK, D), _rand(rng, 3, HK, D)
    kw = dict(cache_seqlens=np.array([30, 7, 12], np.int32), cu_seqlens_k_new=cu_k,
              causal=True, return_softmax_lse=True)
    if table is not None:
        kw["page_table"] = table
    jres, pres, caches = _run_both(q, kc, vc, k, v, **kw)
    assert pres[0].shape == (b, sq, H, D) and pres[1].shape == (b, H, sq)
    _check(jres, pres, caches)


def test_dense_q_ragged_without_k():
    # The reference's fault: JAX reads out[0] as the whole result and fails
    # in reshape; the port names the missing k.
    rng = np.random.RandomState(5)
    kc, vc, _ = _caches(rng, "bshd", 2)
    q = _rand(rng, 2, 3, H, D)
    kw = dict(cache_seqlens=np.array([30, 7], np.int32), cu_seqlens_k_new=np.array([0, 1, 2]))
    with pytest.raises((TypeError, ValueError)):
        jkv(*(jnp.asarray(x) for x in (q, kc, vc)),
            **{n: jnp.asarray(x) for n, x in kw.items()})
    with pytest.raises(ValueError, match="pass k and v"):
        flash_attn_with_kvcache(t(q), t(kc), t(vc), **{n: t(x) for n, x in kw.items()})


@pytest.mark.parametrize("interleaved,rd,seqlens,causal,s_new", [
    (True, D, False, True, 3),
    (False, D, False, False, 2),  # non-causal: every q row at rot_base
    (True, 32, True, True, 1),  # partial rotary, rotary_seqlens
    (False, 48, True, False, 3),
])
def test_rotary_matches_jax(interleaved, rd, seqlens, causal, s_new):
    rng = np.random.RandomState(6 + rd + s_new)
    b = 2
    kc, vc, _ = _caches(rng, "bshd", b)
    q, k, v = _rand(rng, b, s_new, H, D), _rand(rng, b, s_new, HK, D), _rand(rng, b, s_new, HK, D)
    ang = rng.uniform(0, 3.0, (128, rd // 2)).astype(np.float32)
    kw = dict(rotary_cos=np.cos(ang), rotary_sin=np.sin(ang), rotary_interleaved=interleaved,
              cache_seqlens=np.array([40, 9], np.int32), causal=causal, return_softmax_lse=True)
    if seqlens:
        kw["rotary_seqlens"] = np.array([60, 3], np.int32)
    jres, pres, caches = _run_both(q, kc, vc, k, v, **kw)
    _check(jres, pres, caches)


@pytest.mark.parametrize("layout,s_new,window", [
    ("bshd", 1, None),  # the decode kernel's route, reading the slots in place
    ("bhsd", 3, None),
    ("bshd", 2, (8, 0)),  # B1's window route, the live slots gathered
])
def test_cache_batch_idx_matches_jax(layout, s_new, window):
    # A pool of 5 slots; three sequences live in slots 4, 0 and 2.
    rng = np.random.RandomState(7 + s_new)
    b, slots = 3, 5
    kc, vc, _ = _caches(rng, layout, slots)
    q, k, v = _rand(rng, b, s_new, H, D), _rand(rng, b, s_new, HK, D), _rand(rng, b, s_new, HK, D)
    idx = np.array([4, 0, 2], np.int32)
    kw = dict(cache_batch_idx=idx, cache_seqlens=np.array([50, 11, 0], np.int32),
              causal=True, kv_cache_layout=layout, return_softmax_lse=True)
    if window is not None:
        kw["window_size"] = window
    jres, pres, caches = _run_both(q, kc, vc, k, v, **kw)
    _check(jres, pres, caches)
    for slot in (1, 3):  # the slots no sequence picked
        np.testing.assert_array_equal(caches[0][slot].numpy(), kc[slot])
        np.testing.assert_array_equal(caches[1][slot].numpy(), vc[slot])


def test_varlen_q_cache_batch_idx_matches_jax():
    rng = np.random.RandomState(9)
    lq = [2, 5]
    cu = np.cumsum([0] + lq).astype(np.int32)
    kc, vc, _ = _caches(rng, "bshd", 4)
    q, k, v = _rand(rng, 7, H, D), _rand(rng, 7, HK, D), _rand(rng, 7, HK, D)
    jres, pres, caches = _run_both(
        q, kc, vc, k, v, cache_batch_idx=np.array([3, 1], np.int32),
        cache_seqlens=np.array([17, 60], np.int32), cu_seqlens_q=cu, cu_seqlens_k_new=cu,
        max_seqlen_q=5, causal=True, return_softmax_lse=True)
    _check(jres, pres, caches)
    for slot in (0, 2):
        np.testing.assert_array_equal(caches[0][slot].numpy(), kc[slot])


@pytest.mark.parametrize("use_qv,s_new", [(True, 1), (False, 1), (True, 3)])
def test_qv_and_unequal_dv_match_jax(use_qv, s_new):
    # JAX's test_kvcache_decode_unequal_dv_and_qv shape (2 x 384, 4 heads,
    # D 64, Dv 128), with cache_leftpad; GQA 4:2, so a single-token step
    # folds the group into q rows.
    rng = np.random.RandomState(10 + use_qv + s_new)
    b, s_max, dv = 2, 384, 128
    q = _rand(rng, b, s_new, H, D)
    kc, vc = _rand(rng, b, s_max, HK, D), _rand(rng, b, s_max, HK, dv)
    qv = _rand(rng, b, s_new, H, dv) if use_qv else None
    kw = dict(cache_seqlens=np.array([s_max, s_max // 2], np.int32),
              cache_leftpad=np.array([0, 31], np.int32), causal=True, return_softmax_lse=True)
    if qv is not None:
        kw["qv"] = qv
    jres, pres, _ = _run_both(q, kc, vc, **kw)
    assert pres[0].shape == (b, s_new, H, dv)
    _check(jres, pres)


@pytest.mark.parametrize("d,dv,use_qv", MLA_SHAPES)
@pytest.mark.parametrize("bound_causal", [True, False])
def test_mla_shapes_key_range_match_jax(d, dv, use_qv, bound_causal):
    # B1's key range at the MLA shapes: a cache of 160 keys, bounds 160 and
    # 77, kv_low 0 and 20, 40 q rows on one KV head of two q heads.
    rng = np.random.RandomState(d + dv + bound_causal)
    b, h, hk, sq, sk = 2, 2, 1, 40, 160
    q, k, v = _rand(rng, b, h, sq, d), _rand(rng, b, hk, sk, d), _rand(rng, b, hk, sk, dv)
    qv = _rand(rng, b, h, sq, dv) if use_qv else None
    bound, low = np.array([160, 77], np.int32), np.array([0, 20], np.int32)
    jargs, pargs = _both(q, k, v, qv, bound, low)
    kw = dict(bound_causal=bound_causal, return_lse=True, scale=0.05)
    jo, jl = jmasked(*jargs[:3], qv=jargs[3], kv_bound=jargs[4], kv_low=jargs[5], **kw)
    po, pl = flash_attention_masked(*pargs[:3], qv=pargs[3], kv_bound=pargs[4],
                                    kv_low=pargs[5], **kw)
    assert po.shape == (b, h, sq, dv)
    _close(po, jo)
    _close(pl, jl)


def _int8_q_of_jax(q):
    """JAX's int8_mma quantization of the packed q rows (its
    _decode_folded / paged_attention_folded arithmetic, in jnp)."""
    qf = jnp.asarray(q, jnp.float32)
    qrs = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-30) / 127.0
    return np.asarray(jnp.round(qf / qrs).astype(jnp.int8)), np.asarray(qrs[..., 0])


@pytest.mark.parametrize("paged", [False, True])
def test_int8_mma_matches_jax(paged):
    # D 128 (JAX's int8 decode takes D % 128 == 0), 8 q heads on 2 KV heads,
    # an outlier channel in K.
    rng = np.random.RandomState(12 + paged)
    b, h, d = 2, 8, 128
    q = _rand(rng, b, 1, h, d)
    if paged:
        kc, vc, table = _caches(rng, "paged", b, s_max=192, d=d, psz=32)
        kc[..., 5] *= 20.0
        jc, pc = jq.quantize_kv_pages(jnp.asarray(kc), jnp.asarray(vc)), \
            pq.quantize_kv_pages(t(kc), t(vc))
        kw = dict(page_table=table)
    else:
        kc, vc, _ = _caches(rng, "bshd", b, s_max=192, d=d)
        kc[..., 5] *= 20.0
        jc, pc = jq.quantize_kv_cache(jnp.asarray(kc), jnp.asarray(vc)), \
            pq.quantize_kv_cache(t(kc), t(vc))
        kw = {}
    lens = np.array([192, 71], np.int32)
    jkw = dict(cache_seqlens=jnp.asarray(lens), k_cache_scale=jc.k_scale,
               v_cache_scale=jc.v_scale, causal=True,
               **{n: jnp.asarray(x) for n, x in kw.items()})
    pkw = dict(cache_seqlens=t(lens), k_cache_scale=pc.k_scale, v_cache_scale=pc.v_scale,
               causal=True, **{n: t(x) for n, x in kw.items()})
    jo = jkv(jnp.asarray(q), jc.k, jc.v, int8_mma=True, **jkw)
    exact = jkv(jnp.asarray(q), jc.k, jc.v, **jkw)
    po = flash_attn_with_kvcache(t(q), pc.k, pc.v, int8_mma=True, **pkw)
    _close(po, jo, tol=5e-3)
    assert rel_l2(po.numpy(), exact) < 8e-2
    assert rel_l2(po.numpy(), exact) > 1e-4  # the int8 q does change the result
    # The int8 q: the k_scale fold, then the rows' quantization, bit for bit.
    hk = kc.shape[2]
    k_scale = pc.k_scale.expand(b, hk, d)  # [Hk, D] of a pool, [B, Hk, D] of a cache
    folded = t(q).transpose(1, 2).reshape(b, hk, h // hk, d) * k_scale[:, :, None]
    rows = pack_rows(folded.reshape(b, h, 1, d), hk)
    q8, qs = quantize_rows(rows)
    j8, js = _int8_q_of_jax(rows.numpy())
    np.testing.assert_array_equal(q8.numpy(), j8)
    np.testing.assert_array_equal(qs.numpy(), js)
