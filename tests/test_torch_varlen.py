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
from liteattention_torch.ops.dropout import dropout_threshold  # noqa: E402
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    check_dropout,
    check_window,
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


def test_varlen_window_and_softcap_match_jax():
    """JAX's own case (``tests/test_parity_extras.py::
    test_varlen_window_and_softcap``: lengths 70 and 58, causal, window (16,
    0), cap 5.0) at head dim 64, the varlen function's least built one:
    out, lse and the gradients against JAX's varlen function within TOL,
    and out within JAX's 3e-4 of the float64 oracle."""
    lens, h, d, window, cap = [70, 58], 2, 64, (16, 0), 5.0
    rng = np.random.RandomState(144)
    q, k, v, do = (rng.randn(sum(lens), h, d).astype(np.float32) for _ in range(4))
    cu = np.asarray([0, 70, 128], np.int32)
    kw = dict(causal=True, window_size=window, softcap=cap)

    def jax_fn(a, b, c):
        return jfai.flash_attn_varlen_func(a, b, c, jnp.asarray(cu), jnp.asarray(cu),
                                           return_softmax_lse=True, block_sizes=BS, **kw)

    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jl)))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    po, pl = flash_attn_varlen_func(tq, tk, tv, t(cu), t(cu), return_softmax_lse=True, **kw)
    po.backward(t(do))
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")
    off = 0
    for n in lens:
        qf, kf, vf = (x[off:off + n].astype(np.float64) for x in (q, k, v))
        s = cap * np.tanh(np.einsum("qhd,khd->hqk", qf, kf) / np.sqrt(d) / cap)
        row, col = np.arange(n)[:, None], np.arange(n)[None, :]
        s = np.where(((col <= row) & (col >= row - window[0]))[None], s, -1e30)
        p = np.exp(s - s.max(-1, keepdims=True))
        ref = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), vf)
        np.testing.assert_allclose(po.detach().numpy()[off:off + n], ref, atol=3e-4, rtol=0)
        off += n


# Attention dropout on the packed axis (p 0.1, seed 7), alone and with the
# window and the cap, causal and not: (extra arguments).
DROPOUT_CASES = {
    "dropout_causal": dict(causal=True),
    "dropout_noncausal": dict(causal=False),
    "dropout_window_softcap_causal": dict(causal=True, window_size=(16, 0), softcap=5.0),
    "dropout_window_softcap_noncausal": dict(causal=False, window_size=(16, 0), softcap=5.0),
}


@pytest.mark.parametrize("name", list(DROPOUT_CASES))
def test_varlen_dropout_matches_jax(name):
    """flash_attn_varlen_func with dropout against JAX's on JAX's lengths 70
    and 58 (head dim 64, JAX in interpret mode): out, lse and the gradients
    through jax.vjp within TOL. The keep mask's rows and columns are packed
    positions on both sides, so a mask that moved by one row or column
    would differ by O(1)."""
    lens, h, d = [70, 58], 2, 64
    rng = np.random.RandomState(len(name))
    q, k, v, do = (rng.randn(sum(lens), h, d).astype(np.float32) for _ in range(4))
    cu = np.asarray([0, 70, 128], np.int32)
    kw = dict(dropout_p=0.1, **DROPOUT_CASES[name])

    def jax_fn(a, b, c):
        return jfai.flash_attn_varlen_func(a, b, c, jnp.asarray(cu), jnp.asarray(cu),
                                           return_softmax_lse=True, block_sizes=BS,
                                           dropout_seed=jnp.int32(7), **kw)

    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jl)))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    n0 = (flash_attention.segment_dropout_launches, flash_attention.segment_window_launches)
    po, pl = flash_attn_varlen_func(tq, tk, tv, t(cu), t(cu), return_softmax_lse=True,
                                    dropout_seed=7, **kw)
    po.backward(t(do))
    # the CPU runs the plain versions
    assert (flash_attention.segment_dropout_launches,
            flash_attention.segment_window_launches) == n0
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0, err_msg=f"d{n}")
    # Dropout moved the output: the same call without it differs.
    plain = flash_attn_varlen_func(t(q), t(k), t(v), t(cu), t(cu),
                                   **{n: x for n, x in kw.items() if n != "dropout_p"})
    assert (po.detach() - plain).abs().max().item() > 1e-2


class _Entries:
    """A stand-in for the kernel library: records each entry called and its
    arguments, and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


# The card's table for the varlen functions' channels at the segment walk:
# (head dim, window, softcap, dropout, alibi) -> the ROADMAP item a refusal
# names, or None where B1's and B7's segment instantiations of the channels
# take the call (Mistral-7B's window, Gemma-2's cap with and without it at
# head dims 128 and 256, BERT's dropout).
CARD_TABLE = [
    (64, True, False, False, False, None),
    (128, True, False, False, False, None),
    (128, True, True, False, False, None),
    (64, False, True, False, False, None),
    (128, False, True, False, False, None),
    (64, False, False, True, False, None),
    (128, False, False, True, False, None),
    (64, True, False, True, False, "B-i 3's rest"),
    (128, False, True, True, False, "B-i 3's rest"),
    (64, True, True, False, True, "B-i 3's rest"),
    (64, False, False, True, True, "B-i 5"),
    (80, True, False, False, False, "B-iii 4"),
    (96, False, True, False, False, "B-iii 4"),
    (96, False, False, True, False, "B-iii 4"),
    (256, False, False, True, False, "B-iii 4"),
    (256, True, False, False, False, None),
    (256, False, True, False, False, None),
    (256, True, True, False, False, None),
]


@pytest.mark.parametrize("d,window,softcap,dropout,alibi,item", CARD_TABLE)
def test_card_checks_of_the_varlen_channels(monkeypatch, d, window, softcap, dropout, alibi,
                                            item):
    # The checks B1's and B7's wrappers make on the card before a launch;
    # where they pass, the segment walk's launchers call the channels' entry
    # (a stand-in library records it) with the channels' arguments, and
    # count it under the segment counters of that channel.
    from liteattention_torch.ops import _build
    from liteattention_torch.ops import flash_bwd as bwd_mod
    from liteattention_torch.ops import flash_fwd as fwd_mod

    def card_checks(name):
        if window or softcap:
            check_window(d, window, softcap, alibi, dropout, name)
        if dropout:
            check_dropout(d, alibi, name)

    if item is not None:
        for name in ("flash_attention", "flash_bwd"):
            with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
                card_checks(name)
        return
    card_checks("flash_attention")
    card_checks("flash_bwd")
    lib = _Entries()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    ids = torch.tensor([[0] * 70 + [1] * 58], dtype=torch.int32)
    walk = segment_walk(ids, ids)
    q = torch.zeros(1, 4, 128, d, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 128, d, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 128)
    kw = dict(dropout_p=0.1 if dropout else 0.0, dropout_seed=7 if dropout else None,
              window=(4095, 0) if window else None, softcap=50.0 if softcap else 0.0)
    kind = "dropout" if dropout else "window"
    counters = [(fwd_mod.flash_attention, f"segment_{kind}_launches"),
                (bwd_mod.flash_bwd, f"segment_{kind}_launches"),
                (fwd_mod.flash_attention, "segment_launches"),
                (bwd_mod.flash_bwd, "segment_launches")]
    before = [getattr(fn, attr) for fn, attr in counters]
    fwd_mod._launch_segments(q, kv, kv, 0.125, True, walk, **kw)
    bwd_mod._flash_bwd_segments(q, kv, kv, q, lse, q, 0.125, True, walk, **kw)
    assert [getattr(fn, attr) - n for (fn, attr), n in zip(counters, before)] == [1, 1, 0, 0]
    (fwd_name, fwd_args), (bwd_name, bwd_args) = lib.calls
    assert (fwd_name, bwd_name) == ("lite_flash_fwd_segments_channels",
                                    "lite_flash_bwd_segments_channels")
    assert len(fwd_args) == len(_build.SIGNATURES[fwd_name])
    assert len(bwd_args) == len(_build.SIGNATURES[bwd_name])
    # (seed pointer, ..., win_left, win_right, [chunk,] softcap, keep_threshold, keep_scale)
    assert (fwd_args[9] is None) == (not dropout) and (bwd_args[17] is None) == (not dropout)
    sides = (4095, 0) if window else (-1, -1)
    assert fwd_args[17:19] == sides and fwd_args[19] == 0 and bwd_args[25:27] == sides
    assert fwd_args[20] == bwd_args[27] == kw["softcap"]
    assert fwd_args[21] == bwd_args[28] == (dropout_threshold(0.1) if dropout else 0)


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
        (dict(qv=q), NotImplementedError, "qv"),
        (dict(q_descale=torch.ones(1)), NotImplementedError, "descale"),
    ):
        with pytest.raises(exc, match=match):
            flash_attn_varlen_func(q, k, v, cu, cu, **kw)
    q112 = torch.zeros(q.shape[0], 2, 112)
    with pytest.raises(ValueError, match="head dim 112.*ROADMAP B-iii 4"):
        flash_attn_varlen_func(q112, q112, q112, cu, cu)
    other = cu.clone()
    other[1] += 1
    with pytest.raises(ValueError, match="same packing"):
        flash_attn_varlen_func(q, k, v, cu, other, causal=True)
    # Window and softcap are taken by the plain versions (held against JAX
    # in test_varlen_window_and_softcap_match_jax); a window needs the same
    # packing. On the card the segment walk takes either, not with dropout
    # (B-i 3's rest; the table in test_card_checks_of_the_varlen_channels).
    with pytest.raises(ValueError, match="same packing"):
        flash_attn_varlen_func(q, k, v, cu, other, window_size=(8, 0))
    for kw in (dict(window_size=(8, 0)), dict(softcap=5.0)):
        assert flash_attn_varlen_func(q, k, v, cu, cu, **kw).shape == q.shape
        check_window(q.shape[-1], "window_size" in kw, "softcap" in kw, False, False,
                     "flash_attention")
        with pytest.raises(NotImplementedError, match="with dropout.*B-i 3's rest"):
            check_window(q.shape[-1], "window_size" in kw, "softcap" in kw, False, True,
                         "flash_attention")
    # Non-causal cross packing is taken.
    assert flash_attn_varlen_func(q, k, v, cu, other).shape == q.shape
    # Dropout is taken on the packed axis by the plain versions, as JAX's
    # varlen takes it (held against JAX in
    # test_varlen_dropout_matches_jax); on the card the segment walk takes it,
    # not with ALiBi (ROADMAP B-i 5).
    drop = flash_attn_varlen_func(q, k, v, cu, cu, dropout_p=0.1, dropout_seed=7, causal=True)
    assert drop.shape == q.shape and not torch.equal(
        drop, flash_attn_varlen_func(q, k, v, cu, cu, causal=True))
    check_dropout(q.shape[-1], False, "flash_attention")
    with pytest.raises(NotImplementedError, match="alibi_slopes with dropout.*B-i 5"):
        check_dropout(q.shape[-1], True, "flash_attention")
