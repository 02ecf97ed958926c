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
from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention  # noqa: E402
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
