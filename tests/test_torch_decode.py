"""Port parity: the decode entries of kernels B8, B9a and B9b
(flash_attention_decode, paged_attention, paged_attention_folded; their
plain versions on the CPU) and combine_attention, against the JAX
package with its Pallas kernels in interpret mode.

Inputs are fp32 numpy arrays from a seed. Tolerance: 2e-5 absolute on
outputs and lse (O(1) values; the two differ in summation order only:
one exact softmax against an online softmax over chunks or pages); the
int8 paths compare the same int8 values and scales, so the same bound
holds. Rows with no valid key give out 0 and lse -inf in both. The
kernel's own split of the work (``split_plan``: units' key tiles end to
end, cut into equal chunks over its grid) and merge, in ``decode_plain(
grid=...)``, are held against the same references and against the
unsplit plain result.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.ops.combine import combine_attention as jcombine  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_decode as jdecode  # noqa: E402
from liteattention_tpu.ops.kv_quant import quantize_kv_cache as jquant  # noqa: E402
from liteattention_tpu.ops.kv_quant import quantize_kv_pages as jquant_pages  # noqa: E402
from liteattention_tpu.ops.paged_attention import paged_attention as jpaged  # noqa: E402
from liteattention_tpu.ops.paged_attention import (  # noqa: E402
    paged_attention_folded as jpaged_folded,
)
from liteattention_torch.ops.combine import combine_attention  # noqa: E402
from liteattention_torch.ops.flash_decode import (  # noqa: E402
    decode_plain,
    pack_rows,
    split_plan,
    unpack_rows,
)
from liteattention_torch.ops.flash_fwd import flash_attention_decode  # noqa: E402
from liteattention_torch.ops.kv_quant import quantize_kv_cache, quantize_kv_pages  # noqa: E402
from liteattention_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_folded,
)

TOL = 2e-5


def _close(port, ref):
    ref = np.asarray(ref)
    port = port.numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin)
    np.testing.assert_allclose(port[fin], ref[fin], atol=TOL, rtol=0)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("group,d,sq,softcap", [
    (1, 64, 1, 0.0),
    (4, 128, 1, 0.0),
    (8, 64, 1, 20.0),
    (1, 128, 2, 0.0),
    (4, 64, 2, 0.0),
    (8, 128, 1, 5.0),
])
def test_flash_attention_decode_matches_jax(group, d, sq, softcap):
    rng = np.random.RandomState(group * d + sq)
    b, hk, s = 3, 2, 300
    q = _rand(rng, b, hk * group, sq, d)
    k, v = _rand(rng, b, s, hk, d), _rand(rng, b, s, hk, d)
    bound = np.array([300, 171, 40], np.int32)
    low = np.array([0, 23, 40], np.int32)  # batch 2 has no valid key
    jo, jl = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_bound=jnp.asarray(bound),
                     kv_low=jnp.asarray(low), softcap=softcap, interpret=True)
    po, pl = flash_attention_decode(t(q), t(k), t(v), kv_bound=t(bound), kv_low=t(low),
                                    softcap=softcap)
    assert po.shape == (b, hk * group, sq, d) and pl.shape == (b, hk * group, sq)
    _close(po, jo)
    _close(pl, jl)
    assert not np.isfinite(pl[2].numpy()).any() and po[2].abs().max() == 0
    # The plain version of the kernel's split merge gives the same result.
    so, sl = flash_attention_decode(t(q), t(k), t(v), kv_bound=t(bound), kv_low=t(low),
                                    softcap=softcap, num_splits=4)
    _close(so, jo)
    _close(sl, jl)
    assert flash_attention_decode.launches == 0  # CPU tensors never launch


def test_flash_attention_decode_int8_matches_jax():
    rng = np.random.RandomState(7)
    b, h, hk, s, d = 2, 8, 2, 384, 128
    q = _rand(rng, b, h, 1, d)
    k, v = _rand(rng, b, s, hk, d), _rand(rng, b, s, hk, d)
    k[..., 5] *= 20.0  # an outlier channel
    bound = np.array([384, 251], np.int32)
    jc = jquant(jnp.asarray(k), jnp.asarray(v))
    pc = quantize_kv_cache(t(k), t(v))
    jo, jl = jdecode(jnp.asarray(q), jc.k, jc.v, kv_bound=jnp.asarray(bound), k_scale=jc.k_scale,
                     v_scale=jc.v_scale, interpret=True, int8_mma=False)
    po, pl = flash_attention_decode(t(q), pc.k, pc.v, kv_bound=t(bound), k_scale=pc.k_scale,
                                    v_scale=pc.v_scale)
    _close(po, jo)
    _close(pl, jl)
    with pytest.raises(ValueError, match="k_scale"):
        flash_attention_decode(t(q), pc.k, pc.v)
    with pytest.raises(NotImplementedError, match="int8_mma"):
        flash_attention_decode(t(q), pc.k, pc.v, k_scale=pc.k_scale, v_scale=pc.v_scale,
                               int8_mma=True)


def test_flash_attention_decode_causal_rows():
    # Port extension: bottom-right causality per q position, against
    # bottom-right causal attention over each batch's prefix.
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    rng = np.random.RandomState(8)
    b, h, hk, sq, s, d = 2, 4, 2, 3, 64, 64
    q, k, v = _rand(rng, b, h, sq, d), _rand(rng, b, s, hk, d), _rand(rng, b, s, hk, d)
    bound = np.array([64, 20], np.int32)
    po, pl = flash_attention_decode(t(q), t(k), t(v), kv_bound=t(bound), causal=True)
    for i, n in enumerate(bound):
        kk = t(k[i, :n]).permute(1, 0, 2).repeat_interleave(h // hk, 0)[None]
        vv = t(v[i, :n]).permute(1, 0, 2).repeat_interleave(h // hk, 0)[None]
        ro, rl = flash_attention_plain(t(q[i : i + 1]), kk, vv, causal=True)
        np.testing.assert_allclose(po[i].numpy(), ro[0].numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(pl[i].numpy(), rl[0].numpy(), atol=TOL, rtol=0)


def _pages(rng, n_pages, psz, hk, d, b, pages_per_seq):
    kp, vp = _rand(rng, n_pages, psz, hk, d), _rand(rng, n_pages, psz, hk, d)
    table = rng.permutation(n_pages)[: b * pages_per_seq].reshape(b, pages_per_seq)
    return kp, vp, table.astype(np.int32)


@pytest.mark.parametrize("psz,group,sq,d", [
    (16, 1, 1, 64),
    (64, 4, 1, 128),
    (16, 4, 3, 64),  # causal append rows
])
def test_paged_attention_matches_jax(psz, group, sq, d):
    rng = np.random.RandomState(psz + sq)
    b, hk, pps = 3, 2, 4
    kp, vp, table = _pages(rng, 14, psz, hk, d, b, pps)
    q = _rand(rng, b, sq, hk * group, d)
    lengths = np.array([pps * psz, psz + 3, 0], np.int32)  # the last: empty
    lengths[2] = 0 if sq == 1 else sq
    kh, vh = np.ascontiguousarray(kp.transpose(2, 0, 1, 3)), np.ascontiguousarray(vp.transpose(2, 0, 1, 3))
    jo, jl = jpaged(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(lengths),
                    jnp.asarray(table), return_lse=True, interpret=True)
    po, pl = paged_attention(t(q), t(kh), t(vh), t(lengths), t(table), return_lse=True)
    _close(po, jo)
    _close(pl, jl)
    # Decode rank [B, Hq, D] in, same rank out.
    if sq == 1:
        _close(paged_attention(t(q[:, 0]), t(kh), t(vh), t(lengths), t(table)), jo[:, 0])


@pytest.mark.parametrize("psz,group,sq,int8", [
    (16, 4, 1, False),
    (64, 8, 2, False),
    (64, 4, 1, True),
    (16, 1, 1, True),
])
def test_paged_attention_folded_matches_jax(psz, group, sq, int8):
    rng = np.random.RandomState(psz * group + sq)
    b, hk, pps, d = 2, 2, 5, 128
    kp, vp, table = _pages(rng, 12, psz, hk, d, b, pps)
    q = _rand(rng, b, sq, hk * group, d)
    lengths = np.array([pps * psz - 1, 2 * psz + 1], np.int32)
    jkw, pkw = {}, {}
    jk, jv, pk, pv = jnp.asarray(kp), jnp.asarray(vp), t(kp), t(vp)
    if int8:
        jpool, ppool = jquant_pages(jk, jv), quantize_kv_pages(pk, pv)
        jk, jv, pk, pv = jpool.k, jpool.v, ppool.k, ppool.v
        jkw = dict(k_scale=jpool.k_scale, v_scale=jpool.v_scale, int8_mma=False)
        pkw = dict(k_scale=ppool.k_scale, v_scale=ppool.v_scale)
    jo, jl = jpaged_folded(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(table),
                           return_lse=True, interpret=True, **jkw)
    po, pl = paged_attention_folded(t(q), pk, pv, t(lengths), t(table), return_lse=True,
                                    pages_per_step=3, **pkw)
    _close(po, jo)
    _close(pl, jl)
    assert paged_attention_folded.launches == 0


def test_combine_attention_matches_jax():
    rng = np.random.RandomState(9)
    outs = _rand(rng, 3, 2, 4, 5, 16)
    lses = _rand(rng, 3, 2, 4, 5)
    lses[:, 0, 1, 2] = -np.inf  # every split empty: out 0, lse -inf
    lses[1, 1, 0, :] = -np.inf  # one empty split
    jo, jl = jcombine(jnp.asarray(outs), jnp.asarray(lses))
    po, pl = combine_attention(t(outs), t(lses))
    _close(po, jo)
    _close(pl, jl)
    assert po[0, 1, 2].abs().max() == 0


# (group, d, sq, keys per tile, grid, min tiles): the kernel's 128-key tiles
# and 64- and 256-key ones, grids from one chunk to more chunks than tiles,
# the default's 2-tile floor and a multi-row-tile unit (sq 5 x group 4 = 20
# rows).
SPLIT_CASES = [
    (4, 128, 1, 128, 7, 1),
    (4, 128, 1, 128, 132, 2),
    (1, 64, 1, 256, 3, 1),
    (8, 64, 1, 128, 1, 1),
    (4, 64, 5, 64, 11, 1),
    (2, 128, 2, 256, 40, 1),
]


def _split_inputs(rng, group, d, sq, b=5, hk=2, s=700):
    q = _rand(rng, b, hk * group, sq, d)
    k, v = _rand(rng, b, s, hk, d), _rand(rng, b, s, hk, d)
    # A full row, an empty one, one shorter than a tile, two ragged ones.
    bound = np.array([s, 0, 37, 650, 400], np.int32)
    low = np.array([0, 0, 3, 70, 129], np.int32)
    return q, k, v, bound, low


@pytest.mark.parametrize("group,d,sq,kt,grid,min_tiles", SPLIT_CASES)
def test_split_plan_matches_jax_and_unsplit(group, d, sq, kt, grid, min_tiles):
    rng = np.random.RandomState(group * d + kt + grid)
    q, k, v, bound, low = _split_inputs(rng, group, d, sq)
    hk, s = k.shape[2], k.shape[1]
    qp = pack_rows(t(q), hk)
    kh, vh = t(k).transpose(1, 2), t(v).transpose(1, 2)
    scale = d**-0.5
    args = (qp, kh, vh, t(bound), t(low), group, False, scale)
    so, sl = decode_plain(*args, grid=grid, keys_per_tile=kt, min_tiles=min_tiles)
    uo, ul = decode_plain(*args)
    np.testing.assert_allclose(so.numpy(), uo.numpy(), atol=TOL, rtol=0)
    np.testing.assert_array_equal(np.isfinite(sl.numpy()), np.isfinite(ul.numpy()))
    fin = np.isfinite(ul.numpy())
    np.testing.assert_allclose(sl.numpy()[fin], ul.numpy()[fin], atol=TOL, rtol=0)
    jo, jl = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_bound=jnp.asarray(bound),
                     kv_low=jnp.asarray(low), interpret=True)
    po, pl = unpack_rows(so, sl, hk * group, sq)
    _close(po, jo)
    _close(pl, jl)
    plan = split_plan(t(bound), t(low), qp.shape[2], group, False, s, hk, kt, grid, min_tiles)
    rtiles = -(-qp.shape[2] // 16)
    assert len(plan) == q.shape[0] * hk * rtiles
    # The empty row has no piece; the pieces of a unit tile its keys.
    for bi, h, rt, pieces in plan:
        if bound[bi] <= low[bi]:
            assert pieces == []
        else:
            assert pieces[0][0] == low[bi] and pieces[-1][1] == bound[bi]
            assert all(a[1] == b_[0] for a, b_ in zip(pieces, pieces[1:]))
    if grid > 1:
        assert any(len(pieces) > 1 for *_, pieces in plan)


@pytest.mark.parametrize("psz,grid", [(16, 9), (64, 132)])
def test_split_plan_paged_matches_jax(psz, grid):
    # The chunking over a page table's dense view against JAX's paged
    # kernels (head-major pools), causal append rows included.
    rng = np.random.RandomState(psz + grid)
    b, hk, pps, group, sq, d = 4, 2, 8, 4, 2, 64
    kp, vp, table = _pages(rng, b * pps + 3, psz, hk, d, b, pps)
    q = _rand(rng, b, sq, hk * group, d)
    lengths = np.array([pps * psz, sq, psz // 2 + sq, 3 * psz + 5], np.int32)
    kh = np.ascontiguousarray(kp.transpose(2, 0, 1, 3))
    vh = np.ascontiguousarray(vp.transpose(2, 0, 1, 3))
    jo, jl = jpaged(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(lengths),
                    jnp.asarray(table), return_lse=True, interpret=True)
    tbl = t(table).long()
    dense = lambda x: t(x)[tbl].reshape(b, pps * psz, hk, d).transpose(1, 2)  # noqa: E731
    qp = pack_rows(t(q).transpose(1, 2), hk)
    so, sl = decode_plain(qp, dense(kp), dense(vp), t(lengths), None, group, True, d**-0.5,
                          grid=grid, keys_per_tile=128, min_tiles=1)
    po, pl = unpack_rows(so, sl, hk * group, sq)
    _close(po.transpose(1, 2), jo)
    _close(pl, jl)


def test_split_plan_causal_rows_match_unsplit():
    # Bottom-right causal rows (a port extension): the chunking of rows
    # whose limits differ within a 16-row tile, against the unsplit result.
    rng = np.random.RandomState(31)
    q, k, v, bound, low = _split_inputs(rng, 4, 64, 6)
    qp = pack_rows(t(q), 2)
    args = (qp, t(k).transpose(1, 2), t(v).transpose(1, 2), t(bound), t(low), 4, True, 0.125)
    uo, ul = decode_plain(*args)
    for grid in (2, 13, 300):
        so, sl = decode_plain(*args, grid=grid, keys_per_tile=128)
        np.testing.assert_allclose(so.numpy(), uo.numpy(), atol=TOL, rtol=0)
        fin = np.isfinite(ul.numpy())
        np.testing.assert_array_equal(np.isfinite(sl.numpy()), fin)
        np.testing.assert_allclose(sl.numpy()[fin], ul.numpy()[fin], atol=TOL, rtol=0)
