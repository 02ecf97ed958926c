"""Port parity: flash_attn_with_kvcache (liteattention_torch.flash_attn_interface)
against the JAX package, every route the port takes: contiguous caches in
both layouts with appends, leftpad, softcap, causal multi-token steps,
forced KV splits, int8 caches; paged pools (bf16 and int8) with appends;
and each combination that JAX asserts away, which must raise naming
itself (the rest of the API: tests/test_torch_kvcache_rest.py).

fp32 numpy inputs from a seed; the JAX kernels run in interpret mode.
Tolerance: 2e-5 absolute on outputs and lse (summation order only), the
updated caches exactly equal. The port updates its caches in place, so
each call gets its own copies.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_attn_interface import flash_attn_with_kvcache as jkv  # noqa: E402
from liteattention_tpu.ops import kv_quant as jq  # noqa: E402
from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache  # noqa: E402
from liteattention_torch.ops import kv_quant as pq  # noqa: E402

TOL = 2e-5
B, S_MAX, H, HK = 2, 192, 8, 2


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def _inputs(seed, d=64, s_new=1):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, s_new, H, d), kc=f(B, S_MAX, HK, d), vc=f(B, S_MAX, HK, d),
                k=f(B, s_new, HK, d), v=f(B, s_new, HK, d))


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("s_new,causal", [(1, True), (3, True), (2, False)])
def test_contiguous_append_matches_jax(layout, s_new, causal):
    x = _inputs(s_new + (layout == "bhsd"), s_new=s_new)
    kc, vc = x["kc"], x["vc"]
    if layout == "bhsd":
        kc, vc = kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy()
    lens = np.array([100, 37], np.int32)
    kw = dict(cache_seqlens=lens, causal=causal, return_softmax_lse=True, kv_cache_layout=layout)
    jo, jl, (jk, jv) = jkv(jnp.asarray(x["q"]), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(x["k"]), jnp.asarray(x["v"]),
                           **{**kw, "cache_seqlens": jnp.asarray(lens)})
    pk, pv = t(kc), t(vc)
    po, pl, (rk, rv) = flash_attn_with_kvcache(t(x["q"]), pk, pv, t(x["k"]), t(x["v"]),
                                               **{**kw, "cache_seqlens": t(lens)})
    assert rk is pk and rv is pv  # updated in place
    _close(po, jo)
    _close(pl, jl)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_contiguous_leftpad_softcap_d128_matches_jax():
    x = _inputs(4, d=128)
    lens, left = np.array([150, 61], np.int32), np.array([17, 0], np.int32)
    kw = dict(softcap=10.0, return_softmax_lse=True)
    jo, jl = jkv(jnp.asarray(x["q"]), jnp.asarray(x["kc"]), jnp.asarray(x["vc"]),
                 cache_seqlens=jnp.asarray(lens), cache_leftpad=jnp.asarray(left), **kw)
    po, pl = flash_attn_with_kvcache(t(x["q"]), t(x["kc"]), t(x["vc"]), cache_seqlens=t(lens),
                                     cache_leftpad=t(left), **kw)
    _close(po, jo)
    _close(pl, jl)


def test_num_splits_matches_unsplit():
    x = _inputs(5)
    lens = np.array([190, 37], np.int32)
    ref = jkv(jnp.asarray(x["q"]), jnp.asarray(x["kc"]), jnp.asarray(x["vc"]),
              cache_seqlens=jnp.asarray(lens))
    outs = [
        flash_attn_with_kvcache(t(x["q"]), t(x["kc"]), t(x["vc"]), cache_seqlens=t(lens),
                                num_splits=n)
        for n in (1, 3, 8)
    ]
    for o in outs:
        _close(o, ref)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_int8_contiguous_matches_jax(layout):
    x = _inputs(6, d=128)
    lens = np.array([192, 80], np.int32)
    jc = jq.quantize_kv_cache(jnp.asarray(x["kc"]), jnp.asarray(x["vc"]))
    pc = pq.quantize_kv_cache(t(x["kc"]), t(x["vc"]))
    jk, jv, pk, pv = jc.k, jc.v, pc.k, pc.v
    if layout == "bhsd":
        jk, jv = jnp.transpose(jk, (0, 2, 1, 3)), jnp.transpose(jv, (0, 2, 1, 3))
        pk, pv = pk.transpose(1, 2).contiguous(), pv.transpose(1, 2).contiguous()
    jo = jkv(jnp.asarray(x["q"]), jk, jv, cache_seqlens=jnp.asarray(lens), causal=True,
             kv_cache_layout=layout, k_cache_scale=jc.k_scale, v_cache_scale=jc.v_scale)
    po = flash_attn_with_kvcache(t(x["q"]), pk, pv, cache_seqlens=t(lens), causal=True,
                                 kv_cache_layout=layout, k_cache_scale=pc.k_scale,
                                 v_cache_scale=pc.v_scale)
    _close(po, jo)
    with pytest.raises(ValueError, match="k_cache_scale"):
        flash_attn_with_kvcache(t(x["q"]), pk, pv, cache_seqlens=t(lens), kv_cache_layout=layout)
    with pytest.raises(ValueError, match="single-token"):
        flash_attn_with_kvcache(t(x["q"]), pk, pv, t(x["k"]), t(x["v"]), cache_seqlens=t(lens),
                                kv_cache_layout=layout, k_cache_scale=pc.k_scale,
                                v_cache_scale=pc.v_scale)


def _pool(seed, psz=16, pps=6, d=64):
    rng = np.random.RandomState(seed)
    n_pages = B * pps + 2
    kp = rng.randn(n_pages, psz, HK, d).astype(np.float32)
    vp = rng.randn(n_pages, psz, HK, d).astype(np.float32)
    table = rng.permutation(n_pages)[: B * pps].reshape(B, pps).astype(np.int32)
    return kp, vp, table


@pytest.mark.parametrize("s_new", [1, 3])
def test_paged_append_matches_jax(s_new):
    kp, vp, table = _pool(7)
    x = _inputs(8, s_new=s_new)
    lens = np.array([50, 15], np.int32)  # the second append crosses a page
    kw = dict(causal=True, return_softmax_lse=True)
    jo, jl, (jk, jv) = jkv(jnp.asarray(x["q"]), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(x["k"]), jnp.asarray(x["v"]),
                           cache_seqlens=jnp.asarray(lens), page_table=jnp.asarray(table), **kw)
    pk, pv = t(kp), t(vp)
    po, pl, _ = flash_attn_with_kvcache(t(x["q"]), pk, pv, t(x["k"]), t(x["v"]),
                                        cache_seqlens=t(lens), page_table=t(table), **kw)
    _close(po, jo)
    _close(pl, jl)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_paged_int8_matches_jax():
    kp, vp, table = _pool(9, psz=32, pps=3, d=128)
    x = _inputs(10, d=128)
    lens = np.array([70, 33], np.int32)
    jp = jq.quantize_kv_pages(jnp.asarray(kp), jnp.asarray(vp))
    pp = pq.quantize_kv_pages(t(kp), t(vp))
    jp = jq.quantize_pages_append(jp, jnp.asarray(x["k"]), jnp.asarray(x["v"]),
                                  jnp.asarray(table), jnp.asarray(lens))
    pp = pq.quantize_pages_append(pp, t(x["k"]), t(x["v"]), t(table), t(lens))
    jo = jkv(jnp.asarray(x["q"]), jp.k, jp.v, cache_seqlens=jnp.asarray(lens + 1),
             page_table=jnp.asarray(table), causal=True, k_cache_scale=jp.k_scale,
             v_cache_scale=jp.v_scale)
    po = flash_attn_with_kvcache(t(x["q"]), pp.k, pp.v, cache_seqlens=t(lens + 1),
                                 page_table=t(table), causal=True, k_cache_scale=pp.k_scale,
                                 v_cache_scale=pp.v_scale)
    _close(po, jo)


@pytest.mark.parametrize("name,kw", [
    # Ported on the contiguous route (tests/test_torch_window_softcap.py);
    # the paged route refuses them, as JAX asserts.
    ("window_size", dict(window_size=(16, 0), page_table=torch.zeros(B, 1, dtype=torch.int32))),
    ("attention_chunk", dict(attention_chunk=64, page_table=torch.zeros(B, 1, dtype=torch.int32))),
    ("descales", dict(q_descale=torch.ones(1))),
    # Ported (tests/test_torch_kvcache_rest.py); the combinations JAX
    # asserts away raise, naming the argument.
    ("cache_batch_idx", dict(cache_batch_idx=torch.tensor([1, 0]),
                             page_table=torch.zeros(B, 1, dtype=torch.int32))),
    ("qv with page_table", dict(qv=torch.zeros(B, 1, H, 64),
                                page_table=torch.zeros(B, 1, dtype=torch.int32))),
    ("qv with k", dict(qv=torch.zeros(B, 1, H, 64), k=torch.zeros(B, 1, HK, 64),
                       v=torch.zeros(B, 1, HK, 64))),
    ("qv with num_splits", dict(qv=torch.zeros(B, 1, H, 64), num_splits=2)),
    ("v_cache of its own head dim on the paged route",
     dict(page_table=torch.zeros(B, 1, dtype=torch.int32), v_cache=torch.zeros(1, S_MAX, HK, 32))),
    ("rotary_cos with int8", dict(rotary_cos=torch.ones(8, 32), rotary_sin=torch.zeros(8, 32),
                                  int8=True)),
    ("int8 caches", dict(cu_seqlens_q=torch.tensor([0, 1, 2]), max_seqlen_q=1, int8=True)),
])
def test_unported_arguments_raise(name, kw):
    x = _inputs(11)
    kc, vc = t(x["kc"]), t(x["vc"])
    if kw.pop("int8", False):
        c = pq.quantize_kv_cache(kc, vc)
        kc, vc = c.k, c.v
        kw.update(k_cache_scale=c.k_scale, v_cache_scale=c.v_scale)
    vc = kw.pop("v_cache", vc)
    q = t(x["q"])
    if "cu_seqlens_q" in kw:
        q = q[:, 0]
    with pytest.raises(NotImplementedError, match=name):
        flash_attn_with_kvcache(q, kc, vc, cache_seqlens=5, **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(cu_seqlens_q=torch.tensor([0, 1, 2])), "max_seqlen_q"),
    (dict(cu_seqlens_k_new=torch.tensor([0, 1, 2])), "pass k and v"),
    (dict(rotary_cos=torch.ones(8, 32)), "rotary_sin"),
])
def test_kvcache_arguments_checked(kw, match):
    x = _inputs(12)
    q = t(x["q"])
    if "cu_seqlens_q" in kw:
        q = q[:, 0]
    with pytest.raises(ValueError, match=match):
        flash_attn_with_kvcache(q, t(x["kc"]), t(x["vc"]), cache_seqlens=5, **kw)
