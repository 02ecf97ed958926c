"""Port parity: the coarse and super-tile modes of the lite forward (kernel
B4's plain version on CPU) and head folding (B5), against the JAX
``lite_flash_attention`` in interpret mode.

Inputs: 1 x 4 q-heads on 2 kv-heads (GQA), Sq 600 / Sk 700 (ragged tails
at every tile size), D 64, f32, coherent q/k from a seed. Tolerances: out
and lse within 2e-5 (summation order only); schedules and masks exact;
votes exact at every tile whose vote is the same at thr - 1e-3 and
thr + 1e-3 in the port (the rest sit within 1e-3 of thr, where the two
packages' fp32 scores may round either way).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import coherent_qkv, t  # noqa: E402
from liteattention_tpu.ops.lite_flash_fwd import (  # noqa: E402
    lite_flash_attention as jlite,
)
from liteattention_tpu.ops.mask import compact_mask as jcompact  # noqa: E402
from liteattention_tpu.ops.mask import compact_mask_fine as jcompact_fine  # noqa: E402
from liteattention_tpu.ops.mask import compact_mask_gather as jcompact_gather  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch.ops.attention_ref import DEFAULT_MASK_VALUE  # noqa: E402
from liteattention_torch.ops.lite_flash_fwd import (  # noqa: E402
    LN2,
    PLAIN_Q_TILES,
    _chunk_scores,
    _coarse_walk,
    lite_flash_attention,
    lite_flash_attention_coarse_plain,
)
from liteattention_torch.ops.mask import compact_mask, compact_mask_fine  # noqa: E402
from liteattention_torch.ops.schedule_pack import pack_schedule  # noqa: E402
from liteattention_torch.ops.tile_sizes import BlockSizes  # noqa: E402

SQ, SK = 600, 700
MARGIN = 1e-3
INF = float("inf")


def _qkv(seed):
    return coherent_qkv(np.random.RandomState(seed), 1, 4, SQ, SK, 64, hk=2)


def _check_out(po, pl, jo, jl):
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isinf(pl.numpy()), np.isinf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(pl.numpy()[fin], jl[fin], atol=2e-5, rtol=0)


def _check_votes(run, thr, jv, where):
    """Port votes at ``thr`` equal JAX's at ``where`` except where the
    port's own vote moves between thr -/+ MARGIN."""
    pv = run(thr)[2].numpy()
    jv = np.asarray(jv)
    if np.isfinite(thr):
        stable = run(thr - MARGIN)[2].numpy() == run(thr + MARGIN)[2].numpy()
    else:
        stable = np.ones_like(pv, bool)
    assert (stable | ~where).sum() > 0.95 * stable.size
    np.testing.assert_array_equal(pv[where & stable], jv[where & stable])
    return pv


def test_compact_mask_fine_matches_jax():
    rng = np.random.RandomState(0)
    m = rng.rand(2, 3, 7, 9) < 0.3
    m[0, 1, 2] = False  # a fine row with nothing live
    m[1, 2] = False  # a whole head with nothing live
    for qs, ks in ((1, 1), (2, 2), (2, 3), (4, 8), (1, 32)):
        got = compact_mask_fine(t(m), qs, ks)
        want = jcompact_fine(jnp.asarray(m), qs, ks)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        compact_mask_fine(t(m), 4, 16)


@pytest.mark.parametrize("thr", [-2.0, INF, -INF])
@pytest.mark.parametrize("bq,bk", [(128, 256), (256, 256), (256, 128)])
def test_coarse_matches_jax(bq, bk, thr):
    q, k, v = _qkv(1)
    qt, kt = -(-SQ // bq), -(-SK // bk)
    rng = np.random.RandomState(bq + bk)
    m = rng.rand(1, 4, qt, kt) < 0.6
    m[0, 1, 1] = False  # a coarse row with nothing live: tile 0 computed
    m[0, 2, :, -1] = True  # the ragged last tile hangs past the keys
    jidx, jcount = jcompact(jnp.asarray(m))
    jo, jl, jv = jlite(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jidx, jcount,
        jnp.float32(thr), block_sizes=JBS(bq, bk),
    )
    idx, count = compact_mask(t(m))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    def run(th):
        return lite_flash_attention(
            t(q), t(k), t(v), idx, count, th, block_sizes=BlockSizes(bq, bk),
            fine_schedule=False,
        )

    po, pl, _ = run(thr)
    _check_out(po, pl, jo, jl)
    # A dead row still computes tile 0 (count >= 1): no row is empty.
    assert np.isfinite(pl.numpy()).all()
    visited = m | ~m.any(-1, keepdims=True) & (np.arange(kt) == 0)
    pv = _check_votes(run, thr, jv, visited)
    assert (pv[~visited] == 1).all()  # unvisited tiles keep the neutral vote
    anchors = idx.numpy()[..., :1]  # each row's first entry votes 0
    np.testing.assert_array_equal(np.take_along_axis(pv, anchors, -1), 0)
    if thr == INF:  # nothing passes: only the first entries vote 0
        want = np.ones_like(pv)
        np.put_along_axis(want, anchors, 0, -1)
        np.testing.assert_array_equal(pv, want)
    if thr == -INF:
        assert (pv[visited] == 0).all()


@pytest.mark.parametrize("thr", [-2.0, INF, -INF])
@pytest.mark.parametrize("bq,bk", [(128, 256), (256, 256), (256, 128)])
def test_super_tile_matches_jax(bq, bk, thr):
    q, k, v = _qkv(2)
    qtf, ktf = -(-SQ // 128), -(-SK // 128)
    rng = np.random.RandomState(bq * 3 + bk)
    m = rng.rand(1, 4, qtf, ktf) < 0.45
    m[0, 0, 1] = False  # a fine row with nothing live: out 0, lse -inf
    m[0, 3, :, 0] = False  # rows whose first live tile is not tile 0
    qs, ks = bq // 128, bk // 128
    jidx, jcount, jbits = jcompact_fine(jnp.asarray(m), qs, ks)
    jo, jl, jv = jlite(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jidx, jcount,
        jnp.float32(thr), kv_bits=jbits, block_sizes=JBS(bq, bk),
    )
    idx, count, bits = compact_mask_fine(t(m), qs, ks)

    def run(th):
        return lite_flash_attention(
            t(q), t(k), t(v), idx, count, th, kv_bits=bits,
            block_sizes=BlockSizes(bq, bk), fine_schedule=False,
        )

    po, pl, _ = run(thr)
    _check_out(po, pl, jo, jl)
    rows = slice(128, 256)
    assert (po[0, 0, rows] == 0).all() and torch.isinf(pl[0, 0, rows]).all()
    live = np.zeros(np.asarray(jv).shape, bool)
    live[..., :qtf, :ktf] = m
    pv = _check_votes(run, thr, jv, live)
    assert (pv[~live] == 1).all()
    if thr == -INF:
        assert (pv[live] == 0).all()


def test_coarse_at_fine_tiles_equals_gather():
    # At BlockSizes(128, 128) the coarse walk visits the gather walk's
    # tiles in its order, one vote step each.
    q, k, v = _qkv(3)
    rng = np.random.RandomState(3)
    m = rng.rand(1, 4, 5, 6) < 0.6
    m[..., 0] = True
    idx, count = compact_mask(t(m))
    co, cl, cv = lite_flash_attention(
        t(q), t(k), t(v), idx, count, -2.0, fine_schedule=False
    )
    go, gl, gv = lite_flash_attention(t(q), t(k), t(v), idx, count, -2.0, t(m))
    torch.testing.assert_close(co, go, atol=1e-6, rtol=0)
    torch.testing.assert_close(cl, gl, atol=1e-6, rtol=0)
    assert torch.equal(cv[t(m)], gv[t(m)])


def test_fold_h_equals_unfolded_and_must_divide():
    q, k, v = _qkv(4)
    rng = np.random.RandomState(4)
    m = rng.rand(1, 4, 5, 6) < 0.5
    m[..., 0] = True
    fidx, count = pack_schedule(t(m))
    base = lite_flash_attention(t(q), t(k), t(v), fidx, count, -2.0, t(m))
    for fold in (2, 4):
        got = lite_flash_attention(t(q), t(k), t(v), fidx, count, -2.0, t(m), fold_h=fold)
        for a, b in zip(got, base):
            assert torch.equal(a, b)
    # A fold that does not divide the heads: JAX rounds it down silently
    # (to 2 here, the same results as unfolded); the port raises.
    jf, jc, jq = jcompact_gather(jnp.asarray(m), 1)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jf, jc, jnp.float32(-2.0))
    kw = dict(kv_bits=jq, block_sizes=JBS(128, 128), fine_schedule=True)
    j3 = jlite(*args, fold_h=3, **kw)
    j1 = jlite(*args, **kw)
    for a, b in zip(j3, j1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="fold_h"):
        lite_flash_attention(t(q), t(k), t(v), fidx, count, -2.0, t(m), fold_h=3)


def test_mode_arguments_are_checked():
    q, k, v = _qkv(5)
    m = np.ones((1, 4, 5, 6), bool)
    fidx, count = pack_schedule(t(m))
    with pytest.raises(ValueError):  # the gather path needs its mask
        lite_flash_attention(t(q), t(k), t(v), fidx, count, -2.0)
    with pytest.raises(ValueError):  # gather-only arguments
        lite_flash_attention(t(q), t(k), t(v), fidx, count, -2.0, fine_schedule=False,
                             fold_h=2)
    with pytest.raises(ValueError):  # a coarse grid that does not match
        lite_flash_attention(t(q), t(k), t(v), fidx, count, -2.0, fine_schedule=False,
                             block_sizes=BlockSizes(256, 256))


def _walk_plan(kv_idx, count, kv_bits, qsub, ksub, seqlen_q, seqlen_k):
    """The order in which B4's kernel walks (``flash_fwd.cu``'s coarse walks),
    per fine q-tile: ``plan[b][h][qt]``
    is the list of visited places ``(e, coarse tile, fine k-tile, start)`` in
    order, ``start`` True at the first place of each entry (a vote step
    starts there), from :func:`_coarse_walk` with the fine tiles at or past
    the fine k-tile count left out (they hold no key). The kernel visits
    ``max(len(places), 1)`` tiles: a walk with no place computes tile 0 with
    every key hidden and votes nothing."""
    qtf, ktf = -(-seqlen_q // 128), -(-seqlen_k // 128)
    tiles, live = _coarse_walk(kv_idx, count, kv_bits, qsub, ksub, qtf)
    live = (live & (tiles < ktf)).tolist()
    tiles, idx = tiles.tolist(), kv_idx.tolist()
    plan = []
    for b, rows_b in enumerate(live):
        plan.append([])
        for h, rows_h in enumerate(rows_b):
            plan[b].append([])
            for qt, entries in enumerate(rows_h):
                places = []
                for e, subs in enumerate(entries):
                    visits = [s for s, on in enumerate(subs) if on]
                    places += [(e, idx[b][h][qt // qsub][e], tiles[b][h][qt][e][s], s == visits[0])
                               for s in visits]
                plan[b][h].append(places)
    return plan


def _walk_reference(q, k, v, idx, count, thr, bits, qsub, ksub):
    """B4's kernel on the CPU, place by place along _walk_plan: per
    fine q-tile the visited tiles' keys only, m_prev the running row max
    (log2) from before each step's first place, votes stored as the kernel
    stores them (0 into votes filled with 1; the first entry 0). Scores are
    computed as the plain version computes them, so maxima agree exactly."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / np.sqrt(d)
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    step = PLAIN_Q_TILES * 128
    s = torch.cat([_chunk_scores(q[:, :, r:r + step], kf, scale) for r in range(0, sq, step)], 2)
    plan = _walk_plan(idx, count, bits, qsub, ksub, sq, sk)
    qtc, ktc = idx.shape[2], idx.shape[3]
    votes = torch.ones((b, h, qtc, ktc) if bits is None else (b, h, qtc * qsub, ktc * ksub),
                       dtype=torch.int32)
    out = torch.zeros(q.shape)
    lse = torch.full((b, h, sq), -INF)
    mask_value = DEFAULT_MASK_VALUE
    for bi in range(b):
        for hi in range(h):
            for qt, places in enumerate(plan[bi][hi]):
                rows = slice(qt * 128, min(sq, qt * 128 + 128))
                crow = qt // qsub
                if not places:  # one tile with every key hidden: out 0, lse -inf, no vote
                    continue
                if bits is None and count[bi, hi, crow] > 0:
                    votes[bi, hi, crow, idx[bi, hi, crow, 0]] = 0
                elif bits is not None and places[0][0] == 0:
                    votes[bi, hi, qt, places[0][2]] = 0
                m = torch.full((rows.stop - rows.start,), -INF)
                m_prev, cols = m, []
                for e, ci, tile, start in places:
                    c = torch.arange(tile * 128, min(sk, tile * 128 + 128))
                    mx = s[bi, hi, rows][:, c].amax(-1)
                    if start:
                        m_prev = m
                    mp = torch.full_like(m, -INF) if e == 0 else m_prev.clamp(min=mask_value)
                    if bool(((mx.clamp(min=mask_value) - mp) > thr).any()):
                        votes[bi, hi, qt if bits is not None else crow,
                              tile if bits is not None else ci] = 0
                    m = torch.maximum(m, mx)
                    cols.append(c)
                c = torch.cat(cols)
                x = s[bi, hi, rows][:, c]
                p = torch.exp2(x - m[:, None])
                l = p.sum(-1)
                out[bi, hi, rows] = (p @ vf[bi, hi, c]) / l[:, None]
                lse[bi, hi, rows] = m * LN2 + torch.log(l)
    return out, lse, votes


# Sq 700 (6 fine q-tiles), Sk 600 (5 fine k-tiles): at block_k 256 and 384
# the last coarse tile hangs past the keys. Super-tile masks get a fine row
# with no bit set.
@pytest.mark.parametrize("mode,bq,bk", [
    ("coarse", 256, 256), ("coarse", 128, 256), ("coarse", 256, 384),
    ("super", 256, 256), ("super", 128, 384),
])
def test_coarse_walk_plan_gives_the_plain_result(mode, bq, bk):
    """The walk B4's kernel follows (_walk_plan: visited tiles in
    increasing order, a step start at each entry's first place, n >= 1 per
    fine q-tile) gives lite_flash_attention_coarse_plain's out and lse
    (within 2e-5) and its votes exactly, at a threshold inside the
    headroom and at -inf and +inf."""
    sq, sk = 700, 600
    q, k, v = (t(x) for x in coherent_qkv(np.random.RandomState(bq + bk), 1, 4, sq, sk, 64, hk=2))
    rng = np.random.RandomState(bk)
    qs, ks = bq // 128, bk // 128
    qtf, ktf = -(-sq // 128), -(-sk // 128)
    if mode == "super":
        fine = t(rng.rand(1, 4, qtf, ktf) < 0.45)
        fine[0, 1, 2] = False  # a fine row with nothing live
        idx, count, bits = compact_mask_fine(fine, qs, ks)
    else:
        idx, count = compact_mask(t(rng.rand(1, 4, -(-sq // bq), -(-sk // bk)) < 0.6))
        bits = None
    plan = _walk_plan(idx, count, bits, qs, ks, sq, sk)
    for places in (p for head in plan[0] for p in head):
        assert max(len(places), 1) >= 1
        assert [pl[3] for pl in places] == [i == 0 or places[i - 1][0] != pl[0]
                                           for i, pl in enumerate(places)]
        assert all(a[2] < b[2] for a, b in zip(places, places[1:]))
        assert all(pl[2] < ktf for pl in places)
    if mode == "super":
        assert plan[0][1][2] == []
    else:
        assert any(c * ks + ks > ktf for c in idx.unique().tolist())  # a tile hangs past Sk
    head = lite_flash_attention_coarse_plain(q, k, v, idx, count, 0.0, bits, qsub=qs, ksub=ks,
                                             return_headroom=True)[3]
    mid = head[torch.isfinite(head)].median().item()
    for thr in (mid, -INF, INF):
        ro, rl, rv = lite_flash_attention_coarse_plain(q, k, v, idx, count, thr, bits,
                                                       qsub=qs, ksub=ks)
        wo, wl, wv = _walk_reference(q, k, v, idx, count, thr, bits, qs, ks)
        np.testing.assert_allclose(wo.numpy(), ro.numpy(), atol=2e-5, rtol=0)
        assert torch.equal(torch.isinf(wl), torch.isinf(rl))
        fin = torch.isfinite(rl)
        np.testing.assert_allclose(wl[fin].numpy(), rl[fin].numpy(), atol=2e-5, rtol=0)
        assert torch.equal(wv, rv)
