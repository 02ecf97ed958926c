"""Port parity: B7 with B1's per-batch channels (kv_bound, kv_low,
bound_causal and ALiBi) -- liteattention_torch.ops.flash_bwd's plain
versions on the CPU, and autograd through flash_attention_masked -- against
the JAX package's flash_attention_bwd and jax.vjp of its
flash_attention_masked (Pallas kernels in interpret mode), and against
torch.autograd of the fp32 oracle ops/attention_ref.py with the explicit
mask and bias.

fp32 inputs from numpy seeds. Tolerances: dq, dk, dv within 2e-5 absolute
of JAX (largest entries here O(1); the two differ in summation order only),
forward out within 2e-5 as tests/test_torch_flash_fwd_channels.py holds
it. With ALiBi and bound_causal over a cache past the bound, JAX's scores
carry slope * (Sk - bound) (tens to hundreds in log2 units, where fp32
keeps ~1e-5), which the port leaves out of the scores and the lse it
recomputes P against: there JAX's own rounding sets the limit, 1e-4. The
port is held against itself at a cache of the bound's length within 2e-5
absolute plus 2e-5 relative: B1 returns lse less slope * shift and B7 adds
it back, so lse comes back rounded at that constant's magnitude (its last
bit moves P by ~1e-5 relative), and the two capacities cannot give the
same bits.
Gradients of hidden keys (at or past the bound, before kv_low) and of q
rows that see no key must be exactly 0.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.modules.mha import alibi_slopes as jalibi_slopes  # noqa: E402
from liteattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch.ops.attention_ref import attention_ref  # noqa: E402
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    flash_attention_bwd,
    flash_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
    flash_bwd_plain,
)
from liteattention_torch.ops.flash_bwd import check_window  # noqa: E402
from liteattention_torch.ops.flash_fwd import check_dropout, flash_attention_masked  # noqa: E402

TOL = 2e-5
JAX_SHIFTED_TOL = 1e-4
BS = JBS(128, 128)

# (b, h, hk, sq, sk, d), kv_bound, kv_low (None: absent), causal,
# bound_causal, ALiBi slopes ("h": [H], "bh": [B, H], None)
CASES = {
    "bound": ((3, 4, 2, 200, 300, 64), [300, 131, 7], None, False, False, None),
    "bound_causal_mask": ((3, 4, 2, 200, 300, 64), [300, 131, 250], None, True, False, None),
    "bound_causal": ((3, 4, 2, 130, 400, 64), [400, 131, 260], None, False, True, None),
    "bound_causal_and_causal": ((2, 2, 1, 100, 300, 128), [350, 160], None, True, True, None),
    "low": ((3, 4, 4, 150, 300, 64), None, [0, 129, 255], False, False, None),
    "all_three": ((3, 4, 2, 140, 500, 64), [500, 300, 270], [5, 128, 140], False, True, None),
    # Rows that see no key: bound 0, bound == low, bound < low; bound_causal
    # with bound < Sq (the first rows of the last batch).
    "no_key_rows": ((4, 2, 2, 150, 260, 64), [0, 100, 90, 100], [0, 100, 120, 0], False, True,
                    None),
    "alibi_h_noncausal_sq_lt_sk": ((2, 4, 2, 130, 300, 64), None, None, False, False, "h"),
    "alibi_bh_causal_sq_gt_sk": ((2, 4, 1, 300, 140, 128), None, None, True, False, "bh"),
    "alibi_bh_causal_gqa": ((2, 6, 2, 257, 257, 64), None, None, True, False, "bh"),
    "alibi_bound_low_noncausal": ((2, 4, 2, 100, 300, 64), [250, 131], [3, 0], False, False, "h"),
    # Head dims 80 (BTLM: causal ALiBi, its cached steps) and 96.
    "all_three_d80": ((3, 4, 2, 140, 500, 80), [500, 300, 270], [5, 128, 140], False, True, None),
    "alibi_bh_causal_d80": ((2, 4, 2, 257, 257, 80), None, None, True, False, "bh"),
    "alibi_bound_causal_cache_d80": ((2, 4, 2, 20, 300, 80), [260, 150], None, False, True, "h"),
    "bound_causal_d96": ((2, 4, 2, 130, 300, 96), [300, 160], None, True, True, None),
    "alibi_h_noncausal_d96": ((2, 4, 4, 130, 200, 96), None, None, False, False, "h"),
}


def _inputs(seed, b, h, hk, sq, sk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, do


def _slopes(kind, b, h):
    slopes = np.asarray(jalibi_slopes(h))
    if kind == "bh":
        return (slopes[None] * (1.0 + 0.5 * np.arange(b))[:, None]).astype(np.float32)
    return slopes


def _case(name):
    """(q, k, v, do, causal, channels as numpy) of CASES[name]."""
    shape, bound, low, causal, bound_causal, alibi = CASES[name]
    q, k, v, do = _inputs(len(name) + 3, *shape)
    kw = dict(bound_causal=bound_causal)
    if bound is not None:
        kw["kv_bound"] = np.asarray(bound, np.int32)
    if low is not None:
        kw["kv_low"] = np.asarray(low, np.int32)
    if alibi is not None:
        kw["alibi_slopes"] = _slopes(alibi, shape[0], shape[1])
    return q, k, v, do, causal, kw


def _jax_kw(kw):
    return {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}


def _port_kw(kw):
    return {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}


def _jax_fwd_bwd(q, k, v, do, causal, kw):
    """JAX's forward (out, lse) and its flash_attention_bwd on them."""
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jkw = _jax_kw(kw)
    jo, jl = jmasked(jq, jk, jv, causal=causal, return_lse=True, block_sizes=BS, **jkw)
    d = q.shape[-1]
    ref = jbwd(jq, jk, jv, jo, jl, jnp.asarray(do), d**-0.5, causal, block_sizes=BS,
               interpret=True, **jkw)
    return jo, jl, [np.asarray(r) for r in ref]


def _hidden_keys(kw, b, sk):
    """Bool [B, Sk]: keys no q row of the batch sees (at or past the bound,
    before kv_low)."""
    col = np.arange(sk)[None]
    hidden = np.zeros((b, sk), bool)
    if "kv_bound" in kw:
        hidden |= col >= kw["kv_bound"][:, None]
    if "kv_low" in kw:
        hidden |= col < kw["kv_low"][:, None]
    return hidden


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_bwd_channels_match_jax(name):
    q, k, v, do, causal, kw = _case(name)
    jo, jl, ref = _jax_fwd_bwd(q, k, v, do, causal, kw)
    d = q.shape[-1]
    n0 = (flash_bwd.launches, flash_bwd.bound_launches, flash_bwd.alibi_launches)
    got = flash_attention_bwd(t(q), t(k), t(v), t(jo), t(jl), t(do), d**-0.5, causal,
                              **_port_kw(kw))
    assert (flash_bwd.launches, flash_bwd.bound_launches, flash_bwd.alibi_launches) == n0
    for g, r, n in zip(got, ref, ("dq", "dk", "dv")):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=0, err_msg=n)
    hidden = _hidden_keys(kw, q.shape[0], k.shape[2])
    for g in got[1:]:
        assert np.all(g.numpy().transpose(0, 2, 1, 3)[hidden] == 0.0)
    if name == "no_key_rows":
        empty = ~np.isfinite(np.asarray(jl))
        assert empty[:3].all() and empty[3, :, :50].all() and not empty[3, :, 50:].any()
        assert np.all(got[0].numpy()[empty] == 0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_versions_match_the_one_pass(name):
    # B7a's and B7b's plain versions (whole rows of keys, chunks of q rows)
    # against the one pass over 128-key tiles, on the port's own forward.
    q, k, v, do, causal, kw = _case(name)
    pkw = _port_kw(kw)
    o, lse = flash_attention_masked(t(q), t(k), t(v), causal=causal, return_lse=True, **pkw)
    d = q.shape[-1]
    one = flash_bwd_plain(t(q), t(k), t(v), o, lse, t(do), d**-0.5, causal, **pkw)
    delta = (o * t(do)).sum(-1)
    args = (t(q), t(k), t(v), t(do), lse, delta, d**-0.5, causal)
    two = (flash_bwd_dq_plain(*args, **pkw), *flash_bwd_dkv_plain(*args, **pkw))
    for a, b_, n in zip(one, two, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["bound_causal_mask", "all_three", "alibi_bh_causal_gqa",
                                  "alibi_bound_low_noncausal", "alibi_bh_causal_d80",
                                  "bound_causal_d96"])
def test_masked_autograd_matches_jax_vjp(name):
    q, k, v, do, causal, kw = _case(name)
    jkw = _jax_kw(kw)
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: jmasked(q_, k_, v_, causal=causal, block_sizes=BS, **jkw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_masked(tq, tk, tv, causal=causal, **_port_kw(kw))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), atol=TOL, rtol=0)
    out.backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("sq", [4, 100])
def test_alibi_bound_causal_at_two_cache_capacities(sq):
    # MHA's route over a KV cache: ALiBi with bound_causal over a cache of
    # the bound's length and over one well past it. The port's gradients of
    # the valid keys agree across the capacities, and with JAX at each;
    # the keys past the bound get exactly 0.
    b, h, hk, d, cap = 2, 4, 2, 64, 1024
    bound = np.asarray([300, 131], np.int32)
    q, k, v, do = _inputs(sq, b, h, hk, sq, cap, d)
    slopes = _slopes("h", b, h)
    kw = dict(kv_bound=bound, bound_causal=True, alibi_slopes=slopes)
    grads = {}
    for n in (int(bound.max()), cap):
        kn, vn = k[:, :, :n], v[:, :, :n]
        jo, jl, ref = _jax_fwd_bwd(q, kn, vn, do, False, kw)
        tq, tk, tv = (t(x).requires_grad_() for x in (q, kn, vn))
        out = flash_attention_masked(tq, tk, tv, **_port_kw(kw))
        out.backward(t(do))
        got = (tq.grad, tk.grad, tv.grad)
        tol = TOL if n == int(bound.max()) else JAX_SHIFTED_TOL
        for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), r, atol=tol, rtol=0, err_msg=f"{name} at {n}")
        grads[n] = got
    small, big = grads[int(bound.max())], grads[cap]
    np.testing.assert_allclose(big[0].numpy(), small[0].numpy(), atol=TOL, rtol=TOL)
    for g_big, g_small in zip(big[1:], small[1:]):
        for i, n in enumerate(bound.tolist()):
            np.testing.assert_allclose(g_big[i, :, :n].numpy(), g_small[i, :, :n].numpy(),
                                       atol=TOL, rtol=TOL)
            assert g_big[i, :, n:].abs().max().item() == 0.0


# The segment channel (batch 1): (h, hk, sq, sk, d), q document lengths,
# key document lengths (or "random" ids), causal. Dead rows and keys carry
# -1 / -2; ids of no key leave rows without a key, ids of no row keys
# without a gradient.
SEGMENT_CASES = {
    "docs_causal_gqa": ((4, 2, 300, 300, 64), [120, 1, 130, 49], [120, 1, 130, 49], True),
    "docs_noncausal": ((2, 1, 257, 257, 64), [128, 129], [128, 129], False),
    "unsorted_noncausal": ((2, 2, 200, 230, 64), "random", "random", False),
    "sq_lt_sk_unmatched": ((2, 2, 150, 260, 64), [60, 60, 30], [100, 100, 40, 20], False),
    "docs_causal_d80": ((4, 4, 200, 200, 80), [57, 143], [57, 143], True),
    "docs_causal_d128": ((2, 1, 140, 140, 128), [70, 70], [70, 70], True),
}


def _segment_case(name):
    shape, qdoc, kdoc, causal = SEGMENT_CASES[name]
    q, k, v, do = _inputs(len(name) + 5, 1, *shape)
    rng = np.random.RandomState(len(name))
    ids = []
    for doc, n, marker in ((qdoc, shape[2], -1), (kdoc, shape[3], -2)):
        if doc == "random":
            ids.append(rng.randint(-1, 3, (1, n)).astype(np.int32))
        else:
            x = np.repeat(np.arange(len(doc)), doc).astype(np.int32)
            x[rng.rand(n) < 0.05] = marker
            ids.append(x[None])
    return q, k, v, do, causal, dict(q_segments=ids[0], kv_segments=ids[1])


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_segments_bwd_match_jax(name):
    # flash_attention_bwd (the one pass's plain version) and B7a's / B7b's
    # plain versions on JAX's forward against JAX's backward; autograd of
    # flash_attention_masked against jax.vjp; keys of no row's id and rows
    # of no key's id get exactly 0.
    q, k, v, do, causal, kw = _segment_case(name)
    jo, jl, ref = _jax_fwd_bwd(q, k, v, do, causal, kw)
    d = q.shape[-1]
    pkw = _port_kw(kw)
    n0 = flash_bwd.segment_launches
    got = flash_attention_bwd(t(q), t(k), t(v), t(jo), t(jl), t(do), d**-0.5, causal, **pkw)
    assert flash_bwd.segment_launches == n0
    delta = (t(jo) * t(do)).sum(-1)
    args = (t(q), t(k), t(v), t(do), t(jl), delta, d**-0.5, causal)
    split = (flash_bwd_dq_plain(*args, **pkw), *flash_bwd_dkv_plain(*args, **pkw))
    for g, s_, r, n in zip(got, split, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=0, err_msg=n)
        np.testing.assert_allclose(s_.numpy(), r, atol=TOL, rtol=0, err_msg=n)
    unseen = ~np.isin(kw["kv_segments"][0], kw["q_segments"][0])
    empty = ~np.isfinite(np.asarray(jl))
    for g in got[1:]:
        assert np.all(g.numpy()[0][:, unseen] == 0.0)
    assert np.all(got[0].numpy()[empty] == 0.0)
    if name == "sq_lt_sk_unmatched":
        assert unseen.any()
    jkw = _jax_kw(kw)
    _, vjp = jax.vjp(lambda a, b, c: jmasked(a, b, c, causal=causal, block_sizes=BS, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    flash_attention_masked(tq, tk, tv, causal=causal, **pkw).backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do)), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


ORACLE_CASES = {
    "alibi_causal_gqa": ((2, 4, 2, 150, 150, 64), None, None, True, False, "h"),
    "alibi_bh_noncausal_sq_lt_sk": ((2, 4, 4, 100, 230, 64), None, None, False, False, "bh"),
    "alibi_bound_causal_cache": ((2, 4, 2, 20, 300, 64), [260, 150], None, False, True, "h"),
    "bound_low_causal": ((2, 2, 1, 140, 200, 128), [200, 100], [0, 7], True, False, None),
    "alibi_causal_gqa_d80": ((2, 4, 2, 150, 150, 80), None, None, True, False, "h"),
    "alibi_bound_causal_cache_d80": ((2, 4, 2, 20, 300, 80), [260, 150], None, False, True, "h"),
    "bound_causal_d96": ((2, 2, 1, 100, 230, 96), [230, 180], None, True, True, None),
}


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_gradients_match_the_fp32_oracle(name):
    # torch.autograd of attention_ref (exact softmax) with the channels as
    # an explicit additive bias: the ALiBi distance (natural units, not
    # scaled) and -1e30 on hidden keys. No row here is left without a key.
    (b, h, hk, sq, sk, d), bound, low, causal, bound_causal, alibi = ORACLE_CASES[name]
    q, k, v, do = _inputs(sq + sk, b, h, hk, sq, sk, d)
    row, col = np.arange(sq)[:, None], np.arange(sk)[None]
    vis = np.ones((b, 1, sq, sk), bool)
    if causal:
        vis &= col <= row + sk - sq
    kw = dict(bound_causal=bound_causal)
    if bound is not None:
        kw["kv_bound"] = np.asarray(bound, np.int32)
        end = kw["kv_bound"][:, None, None, None]
        vis &= col < (end - sq + row + 1 if bound_causal else end)
    if low is not None:
        kw["kv_low"] = np.asarray(low, np.int32)
        vis &= col >= kw["kv_low"][:, None, None, None]
    bias = np.zeros((b, h, sq, sk), np.float32)
    if alibi is not None:
        kw["alibi_slopes"] = _slopes(alibi, b, h)
        dist = (row + sk - sq - col).astype(np.float32)
        slopes = np.broadcast_to(kw["alibi_slopes"].reshape(-1, h), (b, h))
        bias = -slopes[:, :, None, None] * (dist if causal else np.abs(dist))
    bias = np.where(vis, bias, -1e30).astype(np.float32)
    assert vis.any(-1).all()
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_masked(tq, tk, tv, causal=causal, **_port_kw(kw))
    out.backward(t(do))
    rq, rk, rv = (t(x).requires_grad_() for x in (q, k, v))
    group = h // hk
    ro, _ = attention_ref(rq, rk.repeat_interleave(group, 1), rv.repeat_interleave(group, 1),
                          bias=t(bias))
    np.testing.assert_allclose(out.detach().numpy(), ro.detach().numpy(), atol=TOL, rtol=0)
    ro.backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), (rq.grad, rk.grad, rv.grad), "qkv"):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0, err_msg=f"d{n}")


def test_unported_channels_and_shapes_raise():
    x = torch.zeros(2, 2, 128, 64)
    lse = torch.zeros(2, 2, 128)
    args = (x, x, x, x, lse, x, 0.125, False)
    # Window and softcap are ported (tests/test_torch_window_softcap.py): the
    # plain one pass takes them; on the card with segments too, but not with
    # dropout (ROADMAP B-i 3's rest) nor at head dim 80 (B-iii 4).
    for name, val in (("window", (4, 4)), ("softcap", 5.0)):
        grads = flash_attention_bwd(*args, **{name: val})
        assert all(g.shape == x.shape and torch.isfinite(g).all() for g, x in zip(grads, args))
        with pytest.raises(NotImplementedError, match=f"{name} with dropout.*B-i 3's rest"):
            check_window(64, name == "window", name == "softcap", False, True, "flash_bwd")
        with pytest.raises(NotImplementedError, match=f"{name} at head dim 80.*B-iii 4"):
            check_window(80, name == "window", name == "softcap", False, False, "flash_bwd")
    # Dropout is ported (tests/test_torch_dropout.py): a seed alone does
    # nothing, as in JAX; on the card head dims 64 and 128 are built.
    for a, b in zip(flash_attention_bwd(*args, dropout_seed=3), flash_attention_bwd(*args)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="head dim 80.*B-iii 4"):
        check_dropout(80, False, "flash_bwd")
    # Segments (ported): batch 1, both ids, not with the per-batch channels.
    seg = dict(q_segments=torch.zeros(1, 128), kv_segments=torch.zeros(1, 128))
    with pytest.raises(ValueError, match="batch of 1"):
        flash_attention_bwd(*args, **seg)
    one = tuple(a[:1] if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError, match="go together"):
        flash_attention_bwd(*one, kv_segments=seg["kv_segments"])
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        flash_attention_bwd(*one, alibi_slopes=torch.ones(2), **seg)
    with pytest.raises(ValueError, match="kv_bound"):
        flash_attention_bwd(*args, kv_bound=torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention_bwd(*args, alibi_slopes=torch.ones(3))
    # bound_causal without a bound does nothing, as in JAX.
    q, k, v, do = (t(a) for a in _inputs(1, 2, 2, 2, 130, 130, 64))
    o, lse = flash_attention_masked(q, k, v, kv_low=torch.zeros(2, dtype=torch.int32),
                                    return_lse=True)
    a = flash_attention_bwd(q, k, v, o, lse, do, 0.125, False, bound_causal=True)
    b_ = flash_attention_bwd(q, k, v, o, lse, do, 0.125, False)
    for x_, y_ in zip(a, b_):
        assert torch.equal(x_, y_)
