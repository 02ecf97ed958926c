"""Port parity: B1's per-batch channels (kv_bound, kv_low, bound_causal and
ALiBi) of liteattention_torch.ops.flash_fwd.flash_attention_masked, through
the kernel's plain version on the CPU, against the JAX Pallas kernel in
interpret mode.

Tolerances, fp32: out and lse within 2e-5 absolute (the two differ in
summation order only: online softmax over 128-key tiles against one exact
softmax), as tests/test_torch_flash_fwd.py holds the plain forms, and the
gradients through each channel within 2e-5 of JAX's VJP. Rows that see no
key must give out 0 and lse -inf in both.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.modules.mha import alibi_slopes as jalibi_slopes  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch.modules.mha import alibi_slopes  # noqa: E402
from liteattention_torch.ops.flash_bwd import HEAD_DIMS, check_head_dim  # noqa: E402
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    check_dropout,
    flash_attention,
    flash_attention_masked,
)

TOL = 2e-5
GRAD_TOL = 2e-5  # dq, dk, dv against JAX's VJP (fp32, O(1) entries)


def _inputs(seed, b, h, hk, sq, sk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    return q, k, v


def _compare(q, k, v, **kw):
    """Run both sides on the same numpy inputs (per-batch arrays given as
    numpy in ``kw``) and hold out and lse to TOL; returns the port's lse."""
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    pkw = {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    jo, jl = jmasked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
                     block_sizes=JBS(128, 128), **jkw)
    launches = flash_attention.bound_launches + flash_attention.alibi_launches
    po, pl = flash_attention_masked(t(q), t(k), t(v), return_lse=True, **pkw)
    assert flash_attention.bound_launches + flash_attention.alibi_launches == launches
    jl = np.asarray(jl)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl.numpy()), fin)
    np.testing.assert_allclose(pl.numpy()[fin], jl[fin], atol=TOL, rtol=0)
    assert np.all(po.numpy()[~fin] == 0.0)
    return pl.numpy()


# (b, h, hk, sq, sk, d), kv_bound, kv_low (None: absent), causal, bound_causal
BOUND_CASES = {
    "bound": ((3, 4, 2, 200, 300, 64), [300, 131, 7], None, False, False),
    "bound_causal_mask": ((3, 4, 2, 200, 300, 64), [300, 131, 250], None, True, False),
    "bound_causal": ((3, 4, 2, 130, 400, 64), [400, 131, 260], None, False, True),
    "bound_causal_and_causal": ((2, 2, 1, 100, 300, 128), [350, 160], None, True, True),
    "low": ((3, 4, 4, 150, 300, 64), None, [0, 129, 255], False, False),
    "all_three": ((3, 4, 2, 140, 500, 64), [500, 300, 270], [5, 128, 140], False, True),
    # Rows that see no key: bound 0, bound <= low, bound_causal with bound < Sq.
    "no_key_rows": ((4, 2, 2, 150, 260, 64), [0, 100, 90, 260], [0, 100, 120, 0], False, True),
    # Head dims 80 (BTLM) and 96 (GPT-NeoX-20B).
    "bound_causal_d80": ((3, 4, 2, 130, 400, 80), [400, 131, 260], None, False, True),
    "all_three_d80": ((3, 4, 2, 140, 500, 80), [500, 300, 270], [5, 128, 140], False, True),
    "bound_low_causal_d96": ((2, 4, 2, 200, 300, 96), [300, 131], [0, 7], True, False),
}


@pytest.mark.parametrize("name", list(BOUND_CASES))
def test_bound_low_channels_match_jax(name):
    shape, bound, low, causal, bound_causal = BOUND_CASES[name]
    q, k, v = _inputs(len(name), *shape)
    kw = dict(causal=causal, bound_causal=bound_causal)
    if bound is not None:
        kw["kv_bound"] = np.asarray(bound, np.int32)
    if low is not None:
        kw["kv_low"] = np.asarray(low, np.int32)
    lse = _compare(q, k, v, **kw)
    if name == "no_key_rows":  # bound 0, bound == low, bound < low; the last sees keys
        assert np.isneginf(lse[:3]).all() and np.isfinite(lse[3]).all()


def test_bound_causal_rows_before_the_bound_see_no_key():
    # bound_causal with bound < Sq: the first Sq - bound rows see nothing.
    q, k, v = _inputs(5, 1, 2, 2, 200, 256, 64)
    lse = _compare(q, k, v, kv_bound=np.asarray([60], np.int32), bound_causal=True)
    assert np.isneginf(lse[0, :, :140]).all() and np.isfinite(lse[0, :, 140:]).all()


# (b, h, hk, sq, sk, d), slopes per batch, causal, scale (None: 1/sqrt(d); "d": 1/d)
ALIBI_CASES = {
    "h_noncausal_sq_lt_sk": ((2, 4, 2, 130, 300, 64), False, False, None),
    "h_causal_sq_lt_sk": ((2, 4, 2, 130, 300, 64), False, True, None),
    "bh_noncausal_sq_gt_sk": ((2, 4, 4, 300, 140, 64), True, False, "d"),
    "bh_causal_sq_gt_sk": ((2, 4, 1, 300, 140, 128), True, True, None),
    "h_noncausal_d128_scale_d": ((1, 4, 2, 200, 200, 128), False, False, "d"),
    "bh_causal_scale_d": ((2, 6, 2, 257, 257, 64), True, True, "d"),
    # BTLM's attention: head dim 80, causal, scale 1/d; and head dim 96.
    "h_causal_d80_scale_d": ((2, 4, 2, 257, 257, 80), False, True, "d"),
    "bh_noncausal_d80_sq_lt_sk": ((2, 4, 4, 130, 300, 80), True, False, "d"),
    "h_causal_d96": ((1, 4, 2, 200, 300, 96), False, True, None),
}


@pytest.mark.parametrize("name", list(ALIBI_CASES))
def test_alibi_matches_jax(name):
    shape, per_batch, causal, scale = ALIBI_CASES[name]
    b, h, _, _, _, d = shape
    q, k, v = _inputs(len(name) + 1, *shape)
    slopes = np.asarray(jalibi_slopes(h))
    if per_batch:
        slopes = (slopes[None] * (1.0 + 0.5 * np.arange(b))[:, None]).astype(np.float32)
    _compare(q, k, v, alibi_slopes=slopes, causal=causal,
             scale=1.0 / d if scale == "d" else None)


@pytest.mark.parametrize("s_new,offset", [(1, 37), (3, 140), (100, 0)])
@pytest.mark.parametrize("causal", [False, True])
def test_alibi_with_bound_causal_over_a_cache(s_new, offset, causal):
    # MHA's cached steps: the whole cache (Sk = S_max > bound), kv_bound =
    # offset + s_new, bound_causal, ALiBi at JAX's static distance (lse
    # carries slope * (S_max - bound) per row).
    q, k, v = _inputs(s_new + offset, 2, 4, 2, s_new, 256, 64)
    bound = np.asarray([offset + s_new, offset + s_new], np.int32)
    slopes = np.asarray(jalibi_slopes(4))
    _compare(q, k, v, kv_bound=bound, bound_causal=True, causal=causal, alibi_slopes=slopes)


def test_alibi_cache_capacity_moves_only_lse():
    # The same keys in a cache of the bound's length and in a 2048-key
    # cache: out equal, lse apart by exactly slope * (capacity - bound),
    # JAX's static distance (the port drops the constant from the scores).
    q, k, v = _inputs(11, 2, 4, 2, 1, 2048, 64)
    bound = torch.tensor([700, 1500], dtype=torch.int32)
    slopes = alibi_slopes(4)
    kw = dict(kv_bound=bound, bound_causal=True, alibi_slopes=slopes, return_lse=True)
    big_o, big_l = flash_attention_masked(t(q), t(k), t(v), **kw)
    for i, n in enumerate(bound.tolist()):
        kw_i = dict(kw, kv_bound=bound[i : i + 1])
        o, lse = flash_attention_masked(t(q[i : i + 1]), t(k[i : i + 1, :, :n]),
                                        t(v[i : i + 1, :, :n]), **kw_i)
        torch.testing.assert_close(big_o[i : i + 1], o, rtol=0, atol=1e-6)
        torch.testing.assert_close(big_l[i : i + 1] + slopes[None, :, None] * (2048 - n), lse,
                                   rtol=0, atol=1e-4)


def _doc_ids(lengths, dead=(), marker=-1):
    ids = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    ids[list(dead)] = marker
    return ids[None]


# The segment channel (batch 1): (h, hk, sq, sk, d), q ids, key ids, causal.
# Packed documents with dead rows (-1) and keys (-2); ids in no order; Sq !=
# Sk with rows of an id no key has; head dims 80 and 128.
SEGMENT_CASES = {
    "docs_noncausal": ((4, 2, 300, 300, 64), ([120, 1, 130, 49], range(5, 9)),
                       ([120, 1, 130, 49], range(250, 260)), False),
    "docs_causal_gqa": ((4, 1, 300, 300, 64), ([128, 128, 44], ()), ([128, 128, 44], ()), True),
    "unsorted_causal": ((2, 2, 200, 200, 64), "random", "random", True),
    "sq_lt_sk_empty_rows": ((2, 2, 150, 260, 64), ([60, 60, 30], ()), ([100, 160], ()), False),
    "docs_causal_d80": ((4, 2, 257, 257, 80), ([57, 200], range(0, 3)), ([57, 200], ()), True),
    "docs_noncausal_d128": ((2, 2, 140, 140, 128), ([70, 70], ()), ([70, 70], ()), False),
}


def _segment_case(name):
    shape, qdoc, kdoc, causal = SEGMENT_CASES[name]
    q, k, v = _inputs(len(name) + 2, 1, *shape)
    rng = np.random.RandomState(len(name))
    ids = []
    for doc, n, marker in ((qdoc, shape[2], -1), (kdoc, shape[3], -2)):
        ids.append(rng.randint(-1, 3, (1, n)).astype(np.int32) if doc == "random"
                   else _doc_ids(*doc, marker=marker))
    return q, k, v, ids[0], ids[1], causal


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_segments_match_jax(name):
    q, k, v, qs, ks, causal = _segment_case(name)
    n0 = flash_attention.segment_launches
    lse = _compare(q, k, v, q_segments=qs, kv_segments=ks, causal=causal)
    assert flash_attention.segment_launches == n0
    if name == "sq_lt_sk_empty_rows":  # id 2 carries no key
        assert np.isneginf(lse[0, :, 120:]).all() and np.isfinite(lse[0, :, :120]).all()


@pytest.mark.parametrize("n", range(1, 65))
def test_alibi_slopes_match_jax(n):
    np.testing.assert_allclose(alibi_slopes(n).numpy(), np.asarray(jalibi_slopes(n)),
                               rtol=1e-7, atol=0)
    assert alibi_slopes(n).dtype == torch.float32 and alibi_slopes(n).shape == (n,)


@pytest.mark.parametrize("channel", ["kv_bound", "kv_low", "alibi_slopes"])
def test_gradient_through_a_channel_raises(channel):
    # Once pinned the raise of a gradient through a channel; B7 now takes
    # the channels, so the gradient through each is held against jax.vjp
    # of JAX's flash_attention_masked (GRAD_TOL; see
    # tests/test_torch_flash_bwd_channels.py for every combination).
    q, k, v = _inputs(9, 2, 2, 2, 64, 64, 64)
    do = np.random.RandomState(19).randn(*q.shape).astype(np.float32)
    kw = {"kv_bound": dict(kv_bound=np.asarray([64, 30], np.int32), bound_causal=True),
          "kv_low": dict(kv_low=np.asarray([0, 3], np.int32)),
          "alibi_slopes": dict(alibi_slopes=np.asarray(jalibi_slopes(2)))}[channel]
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    _, vjp = jax.vjp(lambda q_, k_, v_: jmasked(q_, k_, v_, block_sizes=JBS(128, 128), **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    pkw = {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    flash_attention_masked(tq, tk, tv, **pkw).backward(t(do))
    for g, r, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_wrappers_take_the_built_head_dims(d):
    # B1's and B7's wrappers check the head dim with check_head_dim before
    # any launch: 64, 80, 96, 128 and 256 pass; with B1's channels all but
    # 96 and 256, and B1's key range alone (forwards) all but 96.
    check_head_dim(d, False, "flash_attention")
    if d in (96, 256):
        with pytest.raises(ValueError, match="ROADMAP B-iii 4"):
            check_head_dim(d, True, "flash_attention")
    else:
        check_head_dim(d, True, "flash_attention")
    if d == 96:
        with pytest.raises(ValueError, match="ROADMAP B-iii 4"):
            check_head_dim(d, True, "flash_attention", key_range_only=True)
    else:
        check_head_dim(d, True, "flash_attention", key_range_only=True)
    assert d in HEAD_DIMS


@pytest.mark.parametrize("d,item", [(32, "B-iii 4"), (72, "B-iii 4"), (112, "B-iii 4"),
                                    (192, "B-iii 4"), (512, "B-iii 4")])
def test_wrappers_raise_at_other_head_dims(d, item):
    for channels in (False, True):
        with pytest.raises(ValueError, match=f"head dim {d} not built.*ROADMAP {item}"):
            check_head_dim(d, channels, "flash_bwd")


def test_channel_shapes_and_unported_channels():
    q, k, v = (t(x) for x in _inputs(10, 2, 4, 2, 64, 64, 64))
    with pytest.raises(ValueError, match="kv_bound"):
        flash_attention_masked(q, k, v, kv_bound=torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention_masked(q, k, v, alibi_slopes=torch.ones(3))
    for name, kw in (("window", dict(window=(8, 0))), ("softcap", dict(softcap=5.0))):
        with pytest.raises(NotImplementedError, match=name):
            flash_attention_masked(q, k, v, **kw)
    # Dropout is ported (tests/test_torch_dropout.py); with ALiBi it is not
    # built on the card (ROADMAP B-i 5), and runs here on the plain version.
    with pytest.raises(NotImplementedError, match="alibi_slopes with dropout.*B-i 5"):
        check_dropout(64, True, False, "flash_attention")
    alibi = flash_attention_masked(q, k, v, alibi_slopes=torch.ones(4), dropout_p=0.1)
    assert alibi.shape == q.shape and torch.isfinite(alibi).all()
    # Segments (ported): batch 1 as in JAX, both ids, not with the per-batch
    # channels.
    seg = dict(q_segments=torch.zeros(1, 64), kv_segments=torch.zeros(1, 64))
    with pytest.raises(ValueError, match="batch of 1"):
        flash_attention_masked(q, k, v, **seg)
    with pytest.raises(ValueError, match="go together"):
        flash_attention_masked(q[:1], k[:1], v[:1], q_segments=seg["q_segments"])
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        flash_attention_masked(q[:1], k[:1], v[:1], kv_bound=torch.tensor([9]), **seg)
    # bound_causal without a bound does nothing, as in JAX.
    torch.testing.assert_close(flash_attention_masked(q, k, v, bound_causal=True),
                               flash_attention(q, k, v), rtol=0, atol=0)
