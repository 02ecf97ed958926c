"""Port parity: the varlen functions (flash_attn_varlen_func and its
qkvpacked / kvpacked forms) and the segment channel of B1 and B7 under
them (flash_attention_masked / flash_attention_bwd with q_segments and
kv_segments), through the plain versions on the CPU, against the JAX
package (Pallas kernels in interpret mode); and the segment walks' ranges
(ops/segments.py) against a brute-force count.

fp32 inputs from numpy seeds. Tolerance: out, lse and dq, dk, dv within
2e-5 absolute of JAX (entries O(1); the two differ in summation order
only). Rows that see no key give out 0 and lse -inf in both.
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
from liteattention_torch import (  # noqa: E402
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
)
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    flash_attention_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
)
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    check_dropout,
    flash_attention,
    flash_attention_masked,
)
from liteattention_torch.ops.segments import id_spans, segment_walk, walk_ranges  # noqa: E402

TOL = 2e-5
BS = JBS(128, 128)
# Sequence lengths of the packed batch (one of 1 token, boundaries inside
# and on 128-row tiles), and the tokens past the last sequence.
LENGTHS = [100, 1, 130, 27, 98]
TAIL = 20


def _packed(seed, h, hk, d, tail=TAIL):
    rng = np.random.RandomState(seed)
    total = sum(LENGTHS) + tail
    cu = np.concatenate([[0], np.cumsum(LENGTHS)]).astype(np.int32)
    q = rng.randn(total, h, d).astype(np.float32)
    k = rng.randn(total, hk, d).astype(np.float32)
    v = rng.randn(total, hk, d).astype(np.float32)
    do = rng.randn(total, h, d).astype(np.float32)
    return q, k, v, do, cu


def _args(kw, conv):
    return {n: conv(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}


USED_Q = np.asarray([90, 1, 100, 27, 50], np.int32)
USED_K = np.asarray([80, 0, 130, 20, 98], np.int32)
# (h, hk, causal, extra arguments)
CASES = {
    "noncausal_gqa": (4, 2, False, {}),
    "causal_gqa": (4, 2, True, {}),
    "causal_mha_seqused": (2, 2, True, dict(seqused_q=USED_Q, seqused_k=USED_K)),
    "noncausal_seqused_q": (4, 1, False, dict(seqused_q=USED_Q)),
    "causal_chunk": (4, 2, True, dict(attention_chunk=64)),
    "noncausal_chunk_seqused": (2, 1, False, dict(attention_chunk=32, seqused_k=USED_K)),
    "causal_scale": (4, 2, True, dict(softmax_scale=0.3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_varlen_matches_jax(name):
    h, hk, causal, kw = CASES[name]
    q, k, v, _, cu = _packed(len(name), h, hk, 64)
    jo, jl = jfai.flash_attn_varlen_func(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu), jnp.asarray(cu),
        causal=causal, return_softmax_lse=True, block_sizes=BS, **_args(kw, jnp.asarray))
    n0 = flash_attention.segment_launches
    po, pl = flash_attn_varlen_func(t(q), t(k), t(v), t(cu), t(cu), causal=causal,
                                    return_softmax_lse=True, **_args(kw, t))
    assert flash_attention.segment_launches == n0  # the CPU runs the plain version
    jl = np.asarray(jl)
    assert po.shape == q.shape and pl.shape == (h, q.shape[0])
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl.numpy()), fin)
    np.testing.assert_allclose(pl.numpy()[fin], jl[fin], atol=TOL, rtol=0)
    assert np.all(po.numpy().transpose(1, 0, 2)[~fin] == 0.0)
    if "seqused_q" in kw:  # dead rows, the phantom segment's among them
        assert not fin.all() and not fin[:, -TAIL:].any()


@pytest.mark.parametrize("name", ["noncausal_gqa", "causal_mha_seqused", "causal_chunk"])
def test_varlen_gradients_match_jax_vjp(name):
    h, hk, causal, kw = CASES[name]
    q, k, v, do, cu = _packed(len(name) + 7, h, hk, 64)
    jkw = _args(kw, jnp.asarray)
    _, vjp = jax.vjp(
        lambda a, b, c: jfai.flash_attn_varlen_func(a, b, c, jnp.asarray(cu), jnp.asarray(cu),
                                                    causal=causal, block_sizes=BS, **jkw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    flash_attn_varlen_func(tq, tk, tv, t(cu), t(cu), causal=causal, **_args(kw, t)).backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


def test_packed_forms_match_jax():
    q, k, v, _, cu = _packed(3, 4, 4, 64)
    qkv = np.stack([q, k, v], 1)
    kv = np.stack([k, v], 1)
    jo = jfai.flash_attn_varlen_qkvpacked_func(jnp.asarray(qkv), jnp.asarray(cu), causal=True,
                                               block_sizes=BS)
    po = flash_attn_varlen_qkvpacked_func(t(qkv), t(cu), causal=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    jo = jfai.flash_attn_varlen_kvpacked_func(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(cu),
                                              jnp.asarray(cu), block_sizes=BS)
    po = flash_attn_varlen_kvpacked_func(t(q), t(kv), t(cu), t(cu))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    assert torch.equal(po, flash_attn_varlen_func(t(q), t(k), t(v), t(cu), t(cu)))


def _unsorted_ids(seed, sq, sk):
    rng = np.random.RandomState(seed)
    return (rng.randint(-1, 4, (1, sq)).astype(np.int32),
            rng.randint(-1, 4, (1, sk)).astype(np.int32))


@pytest.mark.parametrize("causal,sq,sk", [(False, 200, 300), (True, 260, 260)])
def test_masked_unsorted_segments_match_jax(causal, sq, sk):
    # Ids in no order (the kernels then walk every tile): the forward, JAX's
    # flash_attention_bwd on JAX's out / lse, and jax.vjp through the masked
    # forward, against the port's.
    rng = np.random.RandomState(sq)
    q = rng.randn(1, 4, sq, 64).astype(np.float32)
    k = rng.randn(1, 2, sk, 64).astype(np.float32)
    v = rng.randn(1, 2, sk, 64).astype(np.float32)
    do = rng.randn(1, 4, sq, 64).astype(np.float32)
    qs, ks = _unsorted_ids(sk, sq, sk)
    jkw = dict(q_segments=jnp.asarray(qs), kv_segments=jnp.asarray(ks))
    pkw = dict(q_segments=t(qs), kv_segments=t(ks))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jo, jl = jmasked(jq, jk, jv, causal=causal, return_lse=True, block_sizes=BS, **jkw)
    po, pl = flash_attention_masked(t(q), t(k), t(v), causal=causal, return_lse=True, **pkw)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_array_equal(np.isfinite(pl.numpy()), fin)
    np.testing.assert_allclose(pl.numpy()[fin], np.asarray(jl)[fin], atol=TOL, rtol=0)
    ref = jbwd(jq, jk, jv, jo, jl, jnp.asarray(do), 0.125, causal, block_sizes=BS,
               interpret=True, **jkw)
    got = flash_attention_bwd(t(q), t(k), t(v), t(jo), t(jl), t(do), 0.125, causal, **pkw)
    delta = (t(jo) * t(do)).sum(-1)
    pargs = (t(q), t(k), t(v), t(do), t(jl), delta, 0.125, causal)
    split = (flash_bwd_dq_plain(*pargs, **pkw), *flash_bwd_dkv_plain(*pargs, **pkw))
    for g, s, r, n in zip(got, split, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=n)
        np.testing.assert_allclose(s.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=n)
    _, vjp = jax.vjp(lambda a, b, c: jmasked(a, b, c, causal=causal, block_sizes=BS, **jkw),
                     jq, jk, jv)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    flash_attention_masked(tq, tk, tv, causal=causal, **pkw).backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do)), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")


def _brute(a, b, tile):
    """Per tile of a: the indices of b whose id one of its ids is."""
    out = []
    for t0 in range(0, a.numel(), tile):
        ids = set(a[t0 : t0 + tile].tolist())
        out.append([j for j in range(b.numel()) if b[j].item() in ids])
    return out


@pytest.mark.parametrize("kind", ["packed", "markers_disjoint", "markers_shared", "unsorted",
                                  "missing_ids"])
def test_walk_ranges_against_brute_force(kind):
    # Every index of b whose id a tile of a carries lies inside the tile's
    # range; for a packed batch (ids in order, -1 / -2 markers, every id on
    # both sides) the range starts at the first such index and ends at the
    # last but for markers after it; tiles with no live id walk nothing.
    g = torch.Generator().manual_seed(len(kind))
    exact = kind in ("packed", "markers_disjoint")
    for trial in range(12):
        n = int(torch.randint(1, 420, (1,), generator=g))
        base = torch.sort(torch.randint(0, 9, (n,), generator=g)).values
        a, b = base.clone(), base.clone()
        if kind == "markers_disjoint":
            a[torch.rand(n, generator=g) < 0.2] = -1
            b[torch.rand(n, generator=g) < 0.2] = -2
        elif kind == "markers_shared":
            a[torch.rand(n, generator=g) < 0.2] = -1
            b[torch.rand(n, generator=g) < 0.2] = -1
        elif kind == "unsorted":
            b = b[torch.randperm(n, generator=g)]
        elif kind == "missing_ids":
            b = torch.sort(torch.randint(0, 9, (n + 50,), generator=g)).values
            b[b == 4] = 5
        for tile in (128, 64):
            r = walk_ranges(a, b, tile)
            assert r.dtype == torch.int32
            spans = id_spans(a, tile)
            for i, idx in enumerate(_brute(a, b, tile)):
                lo, hi = r[i].tolist()
                assert all(lo <= j < hi for j in idx), (kind, trial, tile, i)
                part = a[i * tile : (i + 1) * tile]
                assert spans[i].tolist() == [part.min().item(), part.max().item()]
                if exact and idx:
                    assert lo == min(idx) and hi > max(idx) and (b[max(idx) + 1 : hi] < 0).all()
                if exact and not idx:
                    assert (lo, hi) == (0, 0)
                if kind == "unsorted" or (kind == "markers_shared" and (part == -1).any()):
                    assert (lo, hi) == (0, b.numel())


def test_segment_walk_pads_with_the_last_id():
    w = segment_walk(torch.tensor([[0, 0, 1]]), torch.tensor([[0, 1, 1, 1, 2]]))
    for x in (w.q, w.k, w.fwd_range, w.bwd_range, w.k_span, w.q_span):  # the kernels' int / int2
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert w.q.shape == (128,) and (w.q[2:] == 1).all() and (w.k[4:] == 2).all()
    assert w.fwd_range.tolist() == [[0, 4]] and w.bwd_range.tolist() == [[0, 3]]
    assert w.q_span.tolist() == [[0, 1]] and w.k_span.tolist() == [[0, 2]]


def test_varlen_raises():
    q, k, v, _, cu = (t(x) for x in _packed(1, 2, 2, 64))
    for kw, exc, match in (
        (dict(window_size=(8, 0)), NotImplementedError, "B-i 3"),
        (dict(softcap=5.0), NotImplementedError, "B-i 3"),
        (dict(qv=q), NotImplementedError, "qv"),
        (dict(q_descale=torch.ones(1)), NotImplementedError, "descale"),
    ):
        with pytest.raises(exc, match=match):
            flash_attn_varlen_func(q, k, v, cu, cu, **kw)
    q96 = torch.zeros(q.shape[0], 2, 96)
    with pytest.raises(ValueError, match="head dim 96.*ROADMAP B-iii 4"):
        flash_attn_varlen_func(q96, q96, q96, cu, cu)
    other = cu.clone()
    other[1] += 1
    with pytest.raises(ValueError, match="same packing"):
        flash_attn_varlen_func(q, k, v, cu, other, causal=True)
    # Non-causal cross packing is taken.
    assert flash_attn_varlen_func(q, k, v, cu, other).shape == q.shape
    # Dropout is taken on the packed axis by the plain versions, as JAX's
    # varlen takes it; segments with dropout are not built on the card
    # (ROADMAP B-i 5).
    drop = flash_attn_varlen_func(q, k, v, cu, cu, dropout_p=0.1, dropout_seed=7, causal=True)
    assert drop.shape == q.shape and not torch.equal(
        drop, flash_attn_varlen_func(q, k, v, cu, cu, causal=True))
    with pytest.raises(NotImplementedError, match="segments.*B-i 5"):
        check_dropout(q.shape[-1], False, True, "flash_attention")
