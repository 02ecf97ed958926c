"""Port parity at head dim 256 (Gemma-2's and Gemma-3's): B1's key range,
window, attention_chunk, softcap and segment channels and B7's key range,
window, softcap and segments (liteattention_torch.ops.flash_fwd /
flash_bwd, their plain versions on the CPU), and ``flash_attn_func``,
``flash_attn_varlen_func`` and ``flash_attn_with_kvcache`` with them,
against the JAX package (Pallas kernels in interpret mode, BlockSizes(128,
128)).

fp32 inputs from numpy seeds, small shapes (a few heads, Sq and Sk of
150-300, GQA). Tolerances as tests/test_torch_window_softcap.py holds the
same channels at 64 and 128: out, lse and dq / dk / dv within 2e-5
absolute (entries O(1); the two sides differ in summation order only).
Rows that see no key give out 0 and lse -inf on both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu import flash_attn_interface as jfai  # noqa: E402
from liteattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch import flash_attn_interface as api  # noqa: E402
from liteattention_torch.flash_attn_interface import (  # noqa: E402
    flash_attn_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    ALIBI_HEAD_DIMS,
    HEAD_DIMS,
    WINDOW_HEAD_DIMS,
    check_dropout,
    check_head_dim,
    check_window,
    flash_attention_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
)
from liteattention_torch.ops.flash_fwd import flash_attention_masked  # noqa: E402

TOL = 2e-5
BS = JBS(128, 128)
D = 256


def _inputs(seed, b, h, hk, sq, sk):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(b, h, sq, D), f(b, hk, sk, D), f(b, hk, sk, D), f(b, h, sq, D)


def _split(kw):
    """The same channels for JAX (jnp arrays) and the port (tensors)."""
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    pkw = {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    return jkw, pkw


def _close(port, ref, what=""):
    ref = np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port.numpy()), fin, err_msg=what)
    np.testing.assert_allclose(port.numpy()[fin], ref[fin], atol=TOL, rtol=0, err_msg=what)


def _i32(*x):
    return np.asarray(x, np.int32)


# Three packed documents (segment ids, batch 1): boundaries inside 64-key
# and 128-key tiles, so B1's 64-key tiles at 256 read spans that hold two
# ids.
_DOCS = np.repeat(np.arange(3), [70, 80, 50]).astype(np.int32)[None]
# Ragged ids for Sq 150 / Sk 230 (a key id no row carries, rows of an id
# with no key).
_Q_DOCS = np.repeat(np.arange(4), [40, 60, 30, 20]).astype(np.int32)[None]
_K_DOCS = np.repeat(np.asarray([0, 1, 3, 5]), [90, 50, 60, 30]).astype(np.int32)[None]

# name -> ((b, h, hk, sq, sk), channels): the key range with bound_causal
# (rows with no key, a bound below Sq), the window (a side open, Sq != Sk,
# with the key range), the chunk, the cap alone and with the window, and
# segments alone and with the window and the cap.
FWD_CASES = {
    "key_range_bound_causal": ((3, 4, 2, 140, 300), dict(
        kv_bound=_i32(300, 170, 60), kv_low=_i32(5, 64, 0), bound_causal=True)),
    "key_range_not_causal": ((2, 2, 1, 100, 230), dict(kv_bound=_i32(230, 90))),
    "window_causal_gqa": ((1, 4, 2, 200, 300), dict(window=(40, 0), causal=True)),
    "window_both_sides_sq_gt_sk": ((1, 4, 4, 300, 140), dict(window=(10, 10))),
    "window_key_range": ((2, 4, 2, 100, 300), dict(
        window=(40, 3), kv_bound=_i32(300, 170), kv_low=_i32(5, 64), bound_causal=True)),
    "chunk_causal": ((1, 2, 2, 260, 260), dict(attention_chunk=96, causal=True)),
    "softcap": ((1, 4, 2, 150, 230), dict(softcap=5.0)),
    "window_softcap": ((1, 4, 2, 200, 200), dict(window=(30, 0), softcap=3.0, causal=True)),
    "segments_causal": ((1, 4, 2, 200, 200), dict(
        q_segments=_DOCS, kv_segments=_DOCS, causal=True)),
    "segments_ragged": ((1, 4, 2, 150, 230), dict(q_segments=_Q_DOCS, kv_segments=_K_DOCS)),
    "segments_window_softcap": ((1, 4, 2, 200, 200), dict(
        q_segments=_DOCS, kv_segments=_DOCS, window=(30, 0), softcap=4.0, causal=True)),
}


def _forward(name):
    shape, kw = FWD_CASES[name]
    q, k, v, do = _inputs(len(name) + 256, *shape)
    return q, k, v, do, kw


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_matches_jax(name):
    q, k, v, _, kw = _forward(name)
    jkw, pkw = _split(kw)
    jo, jl = jmasked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
                     block_sizes=BS, **jkw)
    po, pl = flash_attention_masked(t(q), t(k), t(v), return_lse=True, **pkw)
    _close(po, jo, "out")
    _close(pl, jl, "lse")
    empty = ~np.isfinite(np.asarray(jl))
    assert np.all(po.numpy()[empty] == 0.0)
    if name == "key_range_bound_causal":  # bound 60 < Sq 140: the first 80 rows see no key
        assert empty[2, :, :80].all() and not empty[2, :, 80:].any() and not empty[0].any()


# Gradients through the key range, the window, the cap and segments
# (attention_chunk has none, as in JAX).
GRAD_CASES = ["key_range_bound_causal", "key_range_not_causal", "window_causal_gqa",
              "window_key_range", "softcap", "window_softcap", "segments_causal",
              "segments_window_softcap"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_jax_vjp(name):
    q, k, v, do, kw = _forward(name)
    jkw, pkw = _split(kw)
    _, vjp = jax.vjp(lambda q_, k_, v_: jmasked(q_, k_, v_, block_sizes=BS, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    flash_attention_masked(tq, tk, tv, **pkw).backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("name", ["window_key_range", "segments_ragged"])
def test_flash_attention_bwd_matches_jax(name):
    # flash_attention_bwd itself (B7's plain one pass) against JAX's
    # flash_attention_bwd on the same forward, and B7a's / B7b's plain
    # versions against the one pass.
    q, k, v, do, kw = _forward(name)
    jkw, pkw = _split(kw)
    scale = D**-0.5
    causal = kw.get("causal", False)
    jkw.pop("causal", None)
    pkw.pop("causal", None)
    jo, jl = jmasked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
                     block_sizes=BS, causal=causal, **jkw)
    jgrads = jbwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl, jnp.asarray(do), scale,
                  causal, block_sizes=BS, **jkw)
    args = (t(q), t(k), t(v), t(jo), t(jl), t(do), scale, causal)
    grads = flash_attention_bwd(*args, **pkw)
    for g, r, n in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")
    delta = (t(jo) * t(do)).sum(-1)
    pargs = (t(q), t(k), t(v), t(do), t(jl), delta, scale, causal)
    np.testing.assert_allclose(flash_bwd_dq_plain(*pargs, **pkw).numpy(), grads[0].numpy(),
                               atol=TOL, rtol=0)
    for g, r in zip(flash_bwd_dkv_plain(*pargs, **pkw), grads[1:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0)


def test_flash_attn_func_matches_jax():
    # Gemma-2's local layer at a small size: causal, window and cap,
    # query_pre_attn_scalar 256 (scale 1/16), [B, S, H, D], GQA.
    kw = dict(causal=True, window_size=(50, 0), softcap=5.0, softmax_scale=D**-0.5)
    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in _inputs(9, 1, 4, 2, 220, 220))
    (jo, jl), vjp = jax.vjp(lambda a, b_, c: jfai.flash_attn_func(
        a, b_, c, return_softmax_lse=True, block_sizes=BS, **kw),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jl)))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    po, pl = flash_attn_func(tq, tk, tv, return_softmax_lse=True, **kw)
    po.backward(t(do))
    _close(po.detach(), jo, "out")
    _close(pl.detach(), jl, "lse")
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("window", [(16, 0), None])
def test_varlen_matches_jax(window):
    # Packed documents (70 and 58 tokens, and 20 past the last) at 256:
    # Gemma-2's local (window and cap) and global (cap) layers, causal; out,
    # lse and the gradients against JAX's varlen function.
    h, hk, cap = 4, 2, 5.0
    rng = np.random.RandomState(256 + (window is None))
    total = 148
    q, do = (rng.randn(total, h, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(total, hk, D).astype(np.float32) for _ in range(2))
    cu = np.asarray([0, 70, 128], np.int32)
    kw = dict(causal=True, softcap=cap, window_size=window or (-1, -1))

    def jax_fn(a, b, c):
        return jfai.flash_attn_varlen_func(a, b, c, jnp.asarray(cu), jnp.asarray(cu),
                                           return_softmax_lse=True, block_sizes=BS, **kw)

    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jl)))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    po, pl = flash_attn_varlen_func(tq, tk, tv, t(cu), t(cu), return_softmax_lse=True, **kw)
    po.backward(t(do))
    _close(po.detach(), jo, "out")
    _close(pl.detach(), jl, "lse")
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("layer", ["local", "global"])
def test_kvcache_prefill_and_step_match_jax(layer, monkeypatch):
    # Gemma-2 served at 256: a multi-token prefill into a cache, then a
    # single-token step, with the cap and (local) the window; every step
    # with the window on B1 (as in JAX), the global single-token step on the
    # decode kernel (the cap alone).
    b, smax, h, hk, s_new = 2, 300, 4, 2, 37
    rng = np.random.RandomState(7 + (layer == "global"))
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    kc, vc = f(b, smax, hk, D), f(b, smax, hk, D)
    steps = [(f(b, s_new, h, D), f(b, s_new, hk, D), f(b, s_new, hk, D)),
             (f(b, 1, h, D), f(b, 1, hk, D), f(b, 1, hk, D))]
    kw = dict(causal=True, softcap=5.0, softmax_scale=D**-0.5, return_softmax_lse=True)
    if layer == "local":
        kw["window_size"] = (40, 0)
    routes = []
    masked, decode = api.flash_attention_masked, api.flash_attention_decode
    monkeypatch.setattr(api, "flash_attention_masked",
                        lambda *a, **k: routes.append("B1") or masked(*a, **k))
    monkeypatch.setattr(api, "flash_attention_decode",
                        lambda *a, **k: routes.append("B8") or decode(*a, **k))
    lens = _i32(120, 70)
    jk, jv, pk, pv = jnp.asarray(kc), jnp.asarray(vc), t(kc), t(vc)
    for q, kn, vn in steps:
        jo, jl, (jk, jv) = jfai.flash_attn_with_kvcache(
            jnp.asarray(q), jk, jv, jnp.asarray(kn), jnp.asarray(vn),
            cache_seqlens=jnp.asarray(lens), **kw)
        po, pl, _ = flash_attn_with_kvcache(t(q), pk, pv, t(kn), t(vn), cache_seqlens=t(lens),
                                            **kw)
        _close(po, jo, "out")
        _close(pl, jl, "lse")
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        lens = lens + q.shape[1]
    assert routes == (["B1", "B1"] if layer == "local" else ["B8", "B8"])


def test_head_dim_256_gates():
    # On the card, 256 takes the key range, segments, the window / chunk and
    # the cap; ALiBi and dropout at 256 still raise before any launch,
    # naming ROADMAP B-iii 4, and the window at 96 as well.
    assert 256 in HEAD_DIMS and 256 in WINDOW_HEAD_DIMS and 256 not in ALIBI_HEAD_DIMS
    for name in ("flash_attention", "flash_bwd"):
        check_head_dim(D, False, name)
        check_window(D, True, True, False, False, name)
        with pytest.raises(ValueError, match="alibi_slopes at head dim 256.*ROADMAP B-iii 4"):
            check_head_dim(D, True, name)
        with pytest.raises(NotImplementedError, match="dropout at head dim 256.*ROADMAP B-iii 4"):
            check_dropout(D, False, name)
        with pytest.raises(NotImplementedError, match="window at head dim 96.*ROADMAP B-iii 4"):
            check_window(96, True, False, False, False, name)
