"""Port parity: B1's window, attention_chunk and softcap channels and B7's
window and softcap channels (liteattention_torch.ops.flash_fwd /
flash_bwd, their plain versions on the CPU), ``flash_attn_func`` and
``flash_attn_with_kvcache`` with them, against the JAX package (Pallas
kernels in interpret mode), and B7's window against torch.autograd of the
fp32 oracle ops/attention_ref.py with the explicit band mask (the
gradient-oracle test the reference lacks for the window).

fp32 inputs from numpy seeds. Tolerances, as tests/test_torch_flash_fwd_
channels.py holds the channel-free forms: out, lse and dq / dk / dv within
2e-5 absolute (entries O(1); the two sides differ in summation order only:
online softmax over 128-key tiles against one exact softmax). Rows that
see no key give out 0 and lse -inf on both sides, and their gradients 0.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_attn_interface import (  # noqa: E402
    flash_attn_func as jfunc,
    flash_attn_with_kvcache as jkv,
)
from liteattention_tpu.modules.mha import alibi_slopes as jalibi_slopes  # noqa: E402
from liteattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch import flash_attn_interface as api  # noqa: E402
from liteattention_torch.flash_attn_interface import (  # noqa: E402
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
)
from liteattention_torch.ops.attention_ref import attention_ref  # noqa: E402
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    WINDOW_HEAD_DIMS,
    check_window,
    flash_attention_bwd,
    flash_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
    window_arg,
    window_hidden,
)
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    flash_attention,
    flash_attention_masked,
    flash_attention_plain,
)

TOL = 2e-5
BS = JBS(128, 128)


def _inputs(seed, b, h, hk, sq, sk, d):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(b, h, sq, d), f(b, hk, sk, d), f(b, hk, sk, d), f(b, h, sq, d)


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


# Three packed documents (segment ids, batch 1).
_DOCS = np.repeat(np.arange(3), [70, 80, 50]).astype(np.int32)[None]

# name -> ((b, h, hk, sq, sk, d), channels). Sq != Sk both ways, GQA, D 64
# and 128; windows open on either side, narrower than a tile, reaching past
# the keys; chunks whose boundaries fall inside tiles, with negative
# positions (Sq > Sk, a short bound); each with the key range (kv_bound,
# kv_low, bound_causal); softcap alone, with the window and with the key
# range; and, on the plain versions, with ALiBi, segments and dropout.
FWD_CASES = {
    "window_both_sides": ((2, 4, 2, 150, 300, 64), dict(window=(20, 5))),
    "window_left_open": ((2, 4, 2, 150, 300, 64), dict(window=(-1, 7))),
    "window_right_open_causal": ((2, 4, 2, 200, 260, 64), dict(window=(30, -1), causal=True)),
    "window_sq_gt_sk": ((1, 4, 4, 300, 140, 64), dict(window=(10, 10))),
    "window_causal_sq_gt_sk_gqa": ((1, 8, 2, 300, 140, 128), dict(window=(40, 0), causal=True)),
    "window_narrower_than_a_tile": ((2, 4, 2, 260, 260, 64), dict(window=(3, 0), causal=True)),
    "window_past_every_key": ((1, 2, 2, 130, 200, 64), dict(window=(5000, 5000))),
    "window_minus_one_both": ((1, 2, 2, 130, 200, 64), dict(window=(-1, -1), causal=True)),
    "window_bound_low_bound_causal": ((3, 4, 2, 140, 500, 64), dict(
        window=(40, 3), kv_bound=_i32(500, 300, 270), kv_low=_i32(5, 128, 140),
        bound_causal=True)),
    "window_bound_not_causal": ((2, 4, 2, 100, 300, 128), dict(
        window=(16, 16), kv_bound=_i32(250, 90))),
    "window_no_key_rows": ((3, 2, 2, 150, 260, 64), dict(
        window=(8, 0), kv_bound=_i32(0, 100, 60), kv_low=_i32(0, 100, 0), bound_causal=True)),
    "chunk_causal": ((2, 4, 2, 300, 300, 64), dict(attention_chunk=64, causal=True)),
    "chunk_inside_tiles": ((1, 4, 2, 260, 400, 128), dict(attention_chunk=100, causal=True)),
    "chunk_negative_pos": ((1, 2, 2, 300, 100, 64), dict(attention_chunk=48)),
    "chunk_negative_pos_short_bound": ((2, 2, 1, 150, 200, 64), dict(
        attention_chunk=32, kv_bound=_i32(10, 0))),
    "chunk_bound_low_bound_causal": ((3, 4, 2, 140, 500, 64), dict(
        attention_chunk=50, kv_bound=_i32(500, 300, 270), kv_low=_i32(5, 128, 140),
        bound_causal=True)),
    "chunk_and_window": ((2, 4, 2, 300, 300, 64), dict(
        attention_chunk=64, window=(20, 0), causal=True)),
    "softcap": ((2, 4, 2, 150, 300, 64), dict(softcap=5.0)),
    "softcap_causal_gqa_d128": ((1, 8, 2, 200, 260, 128), dict(softcap=2.0, causal=True)),
    "softcap_window": ((2, 4, 2, 200, 200, 64), dict(softcap=3.0, window=(30, 0), causal=True)),
    "softcap_key_range": ((3, 4, 2, 140, 500, 64), dict(
        softcap=4.0, kv_bound=_i32(500, 300, 270), kv_low=_i32(5, 128, 140), bound_causal=True)),
    "softcap_window_chunk_bound": ((2, 4, 2, 130, 300, 64), dict(
        softcap=1.5, window=(50, 2), attention_chunk=40, kv_bound=_i32(300, 170),
        bound_causal=True)),
    "window_softcap_alibi": ((2, 4, 2, 150, 300, 64), dict(
        window=(25, 0), softcap=6.0, causal=True, alibi_slopes=np.asarray(jalibi_slopes(4)))),
    "window_softcap_dropout": ((2, 4, 2, 150, 150, 64), dict(
        window=(25, 0), softcap=6.0, causal=True, dropout_p=0.2, dropout_seed=7)),
    "window_softcap_segments": ((1, 4, 2, 200, 200, 64), dict(
        window=(30, 0), softcap=4.0, causal=True, q_segments=_DOCS, kv_segments=_DOCS)),
}


def _forward(name):
    shape, kw = FWD_CASES[name]
    q, k, v, do = _inputs(len(name), *shape)
    return q, k, v, do, kw


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_matches_jax(name):
    q, k, v, _, kw = _forward(name)
    jkw, pkw = _split(kw)
    jo, jl = jmasked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
                     block_sizes=BS, **jkw)
    n0 = flash_attention.window_launches
    po, pl = flash_attention_masked(t(q), t(k), t(v), return_lse=True, **pkw)
    assert flash_attention.window_launches == n0  # the CPU runs the plain version
    _close(po, jo, "out")
    _close(pl, jl, "lse")
    empty = ~np.isfinite(np.asarray(jl))
    assert np.all(po.numpy()[empty] == 0.0)
    if name == "window_no_key_rows":  # bound 0, bound == low, bound < Sq
        assert empty[:2].all() and empty[2, :, :90].all() and not empty[2, :, 90:].any()
    if name == "chunk_negative_pos":  # rows at pos < 0 see no key; the rest do
        assert empty[..., :200].all() and not empty[..., 200:].any()


def test_window_arg_and_window_hidden():
    assert window_arg(None) is None and window_arg((-1, -1)) is None
    assert window_arg([4, -1]) == (4, -1)
    with pytest.raises(ValueError, match=">= -1"):
        window_arg((-2, 0))
    # Chunk positions floor toward -inf: pos -1 lies in chunk [-4, 0).
    row, col = torch.arange(-3, 3)[:, None], torch.arange(-8, 8)[None]
    hid = window_hidden(row, col, 0, None, 4)
    for r in range(-3, 3):
        start = (r // 4) * 4
        want = [not (start <= c < start + 4) for c in range(-8, 8)]
        assert hid[r + 3].tolist() == want


# Gradients through the window and the cap (attention_chunk has none).
GRAD_CASES = ["window_both_sides", "window_causal_sq_gt_sk_gqa", "window_narrower_than_a_tile",
              "window_bound_low_bound_causal", "window_bound_not_causal", "window_no_key_rows",
              "softcap", "softcap_causal_gqa_d128", "softcap_window", "softcap_key_range",
              "window_softcap_alibi", "window_softcap_dropout", "window_softcap_segments"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_jax_vjp(name):
    q, k, v, do, kw = _forward(name)
    jkw, pkw = _split(kw)
    _, vjp = jax.vjp(lambda q_, k_, v_: jmasked(q_, k_, v_, block_sizes=BS, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    n0 = flash_bwd.window_launches
    flash_attention_masked(tq, tk, tv, **pkw).backward(t(do))
    assert flash_bwd.window_launches == n0
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


# flash_attention_bwd itself (B7's plain one pass) against JAX's
# flash_attention_bwd on the same forward, and B7a's / B7b's plain versions
# against the one pass.
BWD_CASES = ["window_bound_low_bound_causal", "window_sq_gt_sk", "softcap_window",
             "softcap_key_range"]


@pytest.mark.parametrize("name", BWD_CASES)
def test_flash_attention_bwd_matches_jax(name):
    q, k, v, do, kw = _forward(name)
    jkw, pkw = _split(kw)
    scale = q.shape[-1] ** -0.5
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


# The window's gradient oracle: (b, h, hk, sq, sk, d), window, causal,
# kv_bound (None: absent), bound_causal.
ORACLE_CASES = {
    "band_causal": ((2, 4, 2, 200, 200, 64), (31, 0), True, None, False),
    "band_both_sides_sq_lt_sk": ((2, 4, 4, 130, 300, 64), (20, 9), False, None, False),
    "band_gqa_d128_sq_gt_sk": ((1, 8, 2, 200, 140, 128), (17, 64), False, None, False),
    "band_over_a_cache": ((2, 4, 2, 64, 300, 64), (50, 0), False, [300, 180], True),
}


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_window_gradients_match_the_fp32_oracle(name):
    # torch.autograd of attention_ref (exact softmax) with the window as an
    # explicit band: -1e30 on every key outside [pos - left, pos + right]
    # (and causal, and the bound). No row here is left without a key.
    (b, h, hk, sq, sk, d), window, causal, bound, bound_causal = ORACLE_CASES[name]
    q, k, v, do = _inputs(sq + sk + d, b, h, hk, sq, sk, d)
    row, col = np.arange(sq)[:, None], np.arange(sk)[None]
    off = np.full((b, 1, 1, 1), sk - sq)
    vis = np.ones((b, 1, sq, sk), bool)
    kw = dict(window=window, causal=causal, bound_causal=bound_causal)
    if causal:
        vis &= col <= row + sk - sq
    if bound is not None:
        kw["kv_bound"] = t(np.asarray(bound, np.int32))
        end = np.asarray(bound)[:, None, None, None]
        off = end - sq
        vis &= col < (end - sq + row + 1 if bound_causal else end)
    left, right = window
    vis &= (col >= row + off - left) & (col <= row + off + right)
    assert vis.any(-1).all() and not vis.all()
    bias = np.broadcast_to(np.where(vis, 0.0, -1e30), (b, h, sq, sk)).astype(np.float32)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_masked(tq, tk, tv, **kw)
    out.backward(t(do))
    rq, rk, rv = (t(x).requires_grad_() for x in (q, k, v))
    group = h // hk
    ro, _ = attention_ref(rq, rk.repeat_interleave(group, 1), rv.repeat_interleave(group, 1),
                          bias=t(bias))
    np.testing.assert_allclose(out.detach().numpy(), ro.detach().numpy(), atol=TOL, rtol=0)
    ro.backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), (rq.grad, rk.grad, rv.grad), "qkv"):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("api_call", ["masked", "flash_attn_func"])
def test_gradient_through_attention_chunk_raises(api_call):
    # JAX's chunked forward has no backward (FA3's asserts the chunk away):
    # the forward runs, a gradient through it raises.
    q, k, v, do = _inputs(3, 1, 2, 2, 130, 130, 64)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    if api_call == "masked":
        out = flash_attention_masked(tq, tk, tv, attention_chunk=64, causal=True)
    else:
        out = flash_attn_func(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                              attention_chunk=64, causal=True)
    assert torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="attention_chunk is forward-only"):
        out.backward(torch.ones_like(out))
    with pytest.raises(ValueError, match="inference-only"):
        flash_attention_masked(tq, tk, tv, attention_chunk=64, dropout_p=0.1)
    with pytest.raises(TypeError):  # B7 has no chunk, as JAX's backward has none
        flash_attention_bwd(tq, tk, tv, tq, tq[..., 0], tq, 0.125, False, attention_chunk=64)


@pytest.mark.parametrize("d,window,softcap,others,item", [
    (96, True, False, {}, "B-iii 4"),
    (80, False, True, {}, "B-iii 4"),
    (96, True, True, {}, "B-iii 4"),
    (64, True, False, dict(alibi=True), "B-i 3's rest"),
    (128, False, True, dict(alibi=True, dropout=True), "B-i 3's rest"),
    (64, True, True, dict(dropout=True), "B-i 3's rest"),
])
def test_card_combinations_left_out_raise(d, window, softcap, others, item):
    # On the card B1's and B7's window instantiations take head dims 64,
    # 128 and 256, with or without the key range, on the dense and the
    # segment walks; the rest raises naming its ROADMAP item (checked before
    # any launch, on the host).
    kw = {**dict(alibi=False, dropout=False), **others}
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        check_window(d, window, softcap, kw["alibi"], kw["dropout"], "flash_bwd")
    for dd in WINDOW_HEAD_DIMS:
        check_window(dd, True, True, False, False, "flash_bwd")


# flash_attn_func and its packed forms, [B, S, H, D].
FUNC_CASES = {
    "window": dict(window_size=(40, 0), causal=True),
    "window_noncausal": dict(window_size=(20, 30)),
    "chunk": dict(attention_chunk=128, causal=True),
    "softcap_window": dict(window_size=(64, 8), softcap=7.5),
}


@pytest.mark.parametrize("name", list(FUNC_CASES))
def test_flash_attn_func_matches_jax(name):
    kw = FUNC_CASES[name]
    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in _inputs(len(name), 1, 4, 2, 300, 300,
                                                                     64))
    jo, jl = jfunc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_softmax_lse=True,
                   block_sizes=BS, **kw)
    po, pl = flash_attn_func(t(q), t(k), t(v), return_softmax_lse=True, **kw)
    _close(po, jo)
    _close(pl, jl)
    kv = np.stack([k, v], axis=2)
    _close(flash_attn_kvpacked_func(t(q), t(kv), **kw), jo)
    qkv = np.stack([q, np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)], axis=2)
    jpo = jfunc(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=2)),
                jnp.asarray(np.repeat(v, 2, axis=2)), block_sizes=BS, **kw)
    _close(flash_attn_qkvpacked_func(t(qkv), **kw), jpo)
    if "attention_chunk" in kw:
        return
    _, vjp = jax.vjp(lambda a, b_, c: jfunc(a, b_, c, block_sizes=BS, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    flash_attn_func(tq, tk, tv, **kw).backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


def test_skip_path_and_varlen_refuse_the_channels():
    q, k, v, _ = (x.transpose(0, 2, 1, 3).copy() for x in _inputs(4, 1, 4, 4, 256, 256, 64))
    m = torch.ones(1, 4, 2, 2, dtype=torch.bool)
    for kw in (dict(window_size=(16, 0)), dict(softcap=5.0), dict(attention_chunk=64)):
        with pytest.raises(ValueError, match="composes with none"):
            flash_attn_func(t(q), t(k), t(v), attn_read_list=m, **kw)
    # The varlen functions take window and softcap on the CPU (held against
    # JAX in tests/test_torch_varlen.py), and on the card too (the segment
    # walk's instantiations: check_window passes); with dropout they raise
    # there (B-i 3's rest).
    cu = torch.tensor([0, 100, 256], dtype=torch.int32)
    for kw in (dict(window_size=(16, 0)), dict(softcap=5.0)):
        assert flash_attn_varlen_func(t(q[0]), t(k[0]), t(v[0]), cu, cu, **kw).shape == q[0].shape
        check_window(64, "window_size" in kw, "softcap" in kw, False, False, "flash_attention")
        with pytest.raises(NotImplementedError, match="B-i 3's rest"):
            check_window(64, "window_size" in kw, "softcap" in kw, False, True, "flash_attention")


KV_B, KV_SMAX, KV_H, KV_HK = 2, 300, 8, 2


def _kv_inputs(seed, s_new, d=64):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(q=f(KV_B, s_new, KV_H, d), kc=f(KV_B, KV_SMAX, KV_HK, d),
                vc=f(KV_B, KV_SMAX, KV_HK, d), k=f(KV_B, s_new, KV_HK, d),
                v=f(KV_B, s_new, KV_HK, d))


# name -> (s_new, layout, channels): single-token and multi-token steps
# (both on B1's window instantiation, as in JAX), the window (also open on
# the left), the chunk with its boundary inside the cache, both, leftpad
# and softcap; causal and not.
KV_CASES = {
    "window_step": (1, "bshd", dict(window_size=(40, 0), causal=True)),
    "window_step_leftpad_softcap": (1, "bhsd", dict(
        window_size=(100, 0), causal=True, cache_leftpad=_i32(10, 60), softcap=4.0)),
    "chunk_step": (1, "bshd", dict(attention_chunk=64, causal=True)),
    "chunk_window_step_noncausal": (1, "bshd", dict(attention_chunk=96, window_size=(20, 5))),
    # A window open on the left (-1, 0: the causal form).
    "open_left_window_step": (1, "bshd", dict(window_size=(-1, 0), causal=True)),
    "open_left_window_step_noncausal": (1, "bhsd", dict(window_size=(-1, 5))),
    "open_left_window_step_leftpad": (1, "bshd", dict(
        window_size=(-1, 8), causal=True, cache_leftpad=_i32(10, 60))),
    "softcap_step": (1, "bhsd", dict(softcap=4.0, causal=True)),
    "window_append": (5, "bshd", dict(window_size=(30, 0), causal=True)),
    "window_append_leftpad_softcap": (7, "bhsd", dict(
        window_size=(50, 2), causal=True, cache_leftpad=_i32(3, 90), softcap=3.0)),
    "chunk_append": (6, "bshd", dict(attention_chunk=64, causal=True)),
    "chunk_window_append_noncausal": (4, "bhsd", dict(attention_chunk=80, window_size=(33, 1))),
}


@pytest.mark.parametrize("name", list(KV_CASES))
def test_kvcache_matches_jax(name, monkeypatch):
    s_new, layout, kw = KV_CASES[name]
    x = _kv_inputs(len(name), s_new)
    kc, vc = x["kc"], x["vc"]
    if layout == "bhsd":
        kc, vc = kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy()
    lens = _i32(120, 70)  # chunk boundaries 64 / 80 / 96 fall inside the cache
    kw = dict(kw, cache_seqlens=lens, return_softmax_lse=True, kv_cache_layout=layout)
    jkw, pkw = _split(kw)
    jo, jl, (jk, jv) = jkv(jnp.asarray(x["q"]), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(x["k"]), jnp.asarray(x["v"]), **jkw)
    # The route: B1's window instantiation for every step with a window or
    # a chunk, as in JAX; the decode kernel for one with the cap alone.
    routes = []
    masked, decode = api.flash_attention_masked, api.flash_attention_decode
    monkeypatch.setattr(api, "flash_attention_masked",
                        lambda *a, **k: routes.append("B1") or masked(*a, **k))
    monkeypatch.setattr(api, "flash_attention_decode",
                        lambda *a, **k: routes.append("B8") or decode(*a, **k))
    pk, pv = t(kc), t(vc)
    po, pl, _ = flash_attn_with_kvcache(t(x["q"]), pk, pv, t(x["k"]), t(x["v"]), **pkw)
    assert routes == (["B1"] if "window_size" in kw or "attention_chunk" in kw else ["B8"])
    _close(po, jo, "out")
    _close(pl, jl, "lse")
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


def test_kvcache_step_without_append_and_the_refusals():
    # A single-token step over a cache filled before the call (k=None), on
    # B1 with the window; the paged route, int8 caches with a
    # window and a chunk with splits raise, as JAX asserts.
    x = _kv_inputs(12, 1)
    lens = _i32(150, 33)
    kw = dict(cache_seqlens=lens, window_size=(24, 0), causal=True, return_softmax_lse=True)
    jkw, pkw = _split(kw)
    jo, jl = jkv(jnp.asarray(x["q"]), jnp.asarray(x["kc"]), jnp.asarray(x["vc"]), **jkw)
    po, pl = flash_attn_with_kvcache(t(x["q"]), t(x["kc"]), t(x["vc"]), **pkw)
    _close(po, jo)
    _close(pl, jl)
    table = torch.zeros(KV_B, 1, dtype=torch.int32)
    for kw in (dict(window_size=(16, 0)), dict(attention_chunk=64)):
        with pytest.raises(NotImplementedError, match="paged route"):
            flash_attn_with_kvcache(t(x["q"]), t(x["kc"]), t(x["vc"]), cache_seqlens=5,
                                    page_table=table, **kw)
    with pytest.raises(ValueError, match="num_splits"):
        flash_attn_with_kvcache(t(x["q"]), t(x["kc"]), t(x["vc"]), cache_seqlens=5,
                                attention_chunk=64, num_splits=2)
    i8 = torch.zeros(KV_B, KV_SMAX, KV_HK, 64, dtype=torch.int8)
    sc = torch.ones(KV_B, KV_HK, 64)
    with pytest.raises(ValueError, match="window_size"):
        flash_attn_with_kvcache(t(x["q"]), i8, i8, cache_seqlens=5, window_size=(8, 0),
                                k_cache_scale=sc, v_cache_scale=sc)


def test_plain_window_equals_masked_keys():
    # The plain forward with a window equals the channel-free plain forward
    # over each row's own keys (window_hidden's band, built here by hand).
    q, k, v, _ = _inputs(21, 1, 2, 2, 70, 90, 64)
    out = flash_attention_plain(t(q), t(k), t(v), window=(9, 2), causal=True)[0]
    for r in (0, 33, 69):
        pos = r + 20
        lo, hi = max(pos - 9, 0), min(pos, 89) + 1
        want = flash_attention_plain(t(q[:, :, r : r + 1]), t(k[:, :, lo:hi]),
                                     t(v[:, :, lo:hi]))[0]
        torch.testing.assert_close(out[:, :, r : r + 1], want, rtol=0, atol=1e-6)
