"""Port parity: absorbed-MLA decode (liteattention_torch.ops.mla, kernel
B10's plain version on the CPU) and ``flash_mla_with_kvcache`` against the
JAX package's ``mla_decode`` in interpret mode.

Tolerances: fp32, out within 2e-5 and lse within 2e-4 absolute, the JAX
package's own (tests/test_mla.py): the two differ in summation order
(the JAX kernel's online softmax over its ring steps against one exact
softmax) and in the mask value (JAX masks with a finite value, the port
with -inf; both give weight 0).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_attn_interface import (  # noqa: E402
    flash_mla_with_kvcache as jflash_mla,
)
from liteattention_tpu.ops.mla import mla_decode as jmla  # noqa: E402
from liteattention_torch.flash_attn_interface import flash_mla_with_kvcache  # noqa: E402
from liteattention_torch.ops.combine import combine_attention  # noqa: E402
from liteattention_torch.ops.mla import (  # noqa: E402
    MIN_SPLIT_TILES,
    TILE_KEYS,
    mla_decode,
    mla_decode_plain,
    split_plan,
)

OUT_TOL, LSE_TOL = 2e-5, 2e-4


def _inputs(seed, b, sq, hq, d, s, lens, lanes=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, hq, d).astype(np.float32)
    kv = rng.randn(b, s, lanes or d).astype(np.float32)
    return q, kv, np.asarray(lens, np.int32)


def _both(q, kv, lens, dv, table=None, causal=True):
    """(JAX out, lse), (port out, lse) on the same numpy inputs."""
    jt = None if table is None else jnp.asarray(table)
    jo, jl = jmla(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(lens), dv, page_table=jt,
                  causal=causal, return_lse=True, interpret=True)
    pt = None if table is None else t(table)
    po, pl = mla_decode(t(q), t(kv), t(lens), dv, page_table=pt, causal=causal,
                        return_lse=True)
    return (np.asarray(jo), np.asarray(jl)), (po.numpy(), pl.numpy())


def _close(j, p):
    (jo, jl), (po, pl) = j, p
    assert po.shape == jo.shape and pl.shape == jl.shape
    np.testing.assert_allclose(po, jo, atol=OUT_TOL, rtol=0)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl), fin)
    np.testing.assert_allclose(pl[fin], jl[fin], atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize(
    "b,sq,hq,d,dv,s,paged",
    [
        (2, 1, 16, 576, 512, 1024, False),  # DeepSeek absorbed decode
        (2, 2, 32, 576, 512, 512, False),  # MTP 2-token verify, causal
        (1, 1, 8, 256, 128, 320, False),  # odd length tail
        (2, 1, 16, 576, 512, 1024, True),  # paged (page_size 64)
    ],
)
def test_mla_decode_matches_jax(b, sq, hq, d, dv, s, paged):
    q, kv, lens = _inputs(3, b, sq, hq, d, s, [s, s // 2][:b] if b > 1 else [s - 7])
    table = None
    if paged:
        kv = kv.reshape(b * s // 64, 64, d)
        table = np.arange(b * s // 64, dtype=np.int32).reshape(b, s // 64)
    _close(*_both(q, kv, lens, dv, table))
    assert mla_decode.launches == 0  # CPU tensors never launch


def test_mla_decode_permuted_page_table():
    """Pages scattered through the pool by a random permutation (and a
    pool larger than the table needs)."""
    b, hq, d, dv, ps, pps = 2, 16, 576, 512, 64, 6
    rng = np.random.RandomState(11)
    n_pages = b * pps + 3
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    pool = rng.randn(n_pages, ps, d).astype(np.float32)
    table = rng.permutation(n_pages)[: b * pps].astype(np.int32).reshape(b, pps)
    lens = np.asarray([pps * ps, 201], np.int32)
    _close(*_both(q, pool, lens, dv, table))
    # The same keys laid out contiguously give the same result.
    flat = pool[table].reshape(b, pps * ps, d)
    po, pl = mla_decode(t(q), t(flat), t(lens), dv, return_lse=True)
    ro, rl = mla_decode(t(q), t(pool), t(lens), dv, page_table=t(table), return_lse=True)
    np.testing.assert_allclose(po.numpy(), ro.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pl.numpy(), rl.numpy(), atol=1e-6, rtol=0)


def test_mla_decode_640_lane_cache():
    """A cache at the TPU's 640-lane stride (extra lanes garbage) decodes as
    the tight 576 one, in both packages."""
    b, hq, d, dv, s = 2, 8, 576, 512, 256
    q, kv, lens = _inputs(5, b, 1, hq, d, s, [s, 200])
    garbage = np.random.RandomState(6).randn(b, s, 64).astype(np.float32) * 50.0
    wide = np.concatenate([kv, garbage], axis=-1)
    j, p = _both(q, wide, lens, dv)
    _close(j, p)
    tight = mla_decode(t(q), t(kv), t(lens), dv, return_lse=True)
    np.testing.assert_array_equal(p[0], tight[0].numpy())
    np.testing.assert_array_equal(p[1], tight[1].numpy())


def test_mla_decode_rank3_q_and_empty_row():
    """Rank-3 q gives [B, Hq, Dv]; a request of length 0 gives out 0 and
    lse -inf in both packages, never NaN."""
    b, hq, d, dv, s = 3, 4, 256, 128, 192
    q, kv, lens = _inputs(7, b, 1, hq, d, s, [s, 0, 65])
    q3 = q[:, 0]
    jo, jl = jmla(jnp.asarray(q3), jnp.asarray(kv), jnp.asarray(lens), dv,
                  return_lse=True, interpret=True)
    po, pl = mla_decode(t(q3), t(kv), t(lens), dv, return_lse=True)
    assert po.shape == (b, hq, dv) and pl.shape == (b, hq, 1)
    _close((np.asarray(jo), np.asarray(jl)), (po.numpy(), pl.numpy()))
    assert (po[1] == 0).all() and torch.isneginf(pl[1]).all()
    assert np.all(np.asarray(jo)[1] == 0) and np.all(np.isneginf(np.asarray(jl)[1]))
    assert torch.isfinite(po).all()


def test_mla_decode_too_many_rows_raises():
    """Sq * Hq = 136 > 128: JAX asserts, the port raises."""
    q, kv, lens = _inputs(9, 1, 2, 68, 256, 64, [64])
    with pytest.raises(AssertionError):
        jmla(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(lens), 128, interpret=True)
    with pytest.raises(ValueError, match="Sq\\*Hq = 136"):
        mla_decode(t(q), t(kv), t(lens), 128)


def test_flash_mla_with_kvcache_matches_jax():
    """The external flash_mla signature: a [B, S, 1, D] cache, no page
    table, *metadata ignored, (out, lse) returned."""
    b, hq, d, dv, s = 2, 16, 576, 512, 256
    q, kv, lens = _inputs(4, b, 1, hq, d, s, [s, s - 100])
    kv4 = kv[:, :, None]
    jo, jl = jflash_mla(jnp.asarray(q), jnp.asarray(kv4), None, jnp.asarray(lens), dv,
                        causal=True)
    po, pl = flash_mla_with_kvcache(t(q), t(kv4), None, t(lens), dv, "tile-metadata", 4,
                                    causal=True)
    _close((np.asarray(jo), np.asarray(jl)), (po.numpy(), pl.numpy()))
    assert pl.shape == (b, hq, 1)
    only = flash_mla_with_kvcache(t(q), t(kv4), None, t(lens), dv, return_softmax_lse=False)
    assert torch.equal(only, po)
    ro, rl = mla_decode_plain(t(q), t(kv4), t(lens), dv, return_lse=True)
    assert torch.equal(ro, po) and torch.equal(rl, pl)


# Ragged lengths with an empty request, one under a 64-key tile and some
# ending mid-page; pages of 64, of 16 (several a tile) and of 48 (64 does
# not divide it: a tile spans pages).
SPLIT_LENS = [0, 37, 200, 333, 450]


def _split_plain(q, pool, table, lens, dv, plan):
    """B10's split and in-kernel merge in plain PyTorch: each piece [k0,
    k1) of a request's keys (``plan``, from split_plan) attended alone by
    mla_decode_plain, a request's pieces merged by combine_attention."""
    b, sq, hq, _ = q.shape
    keys = pool[table.long()].reshape(b, -1, pool.shape[-1])
    out = torch.zeros(b, sq, hq, dv)
    lse = torch.full((b, hq, sq), -torch.inf)
    for i, pieces in enumerate(plan):
        parts = [mla_decode_plain(q[i : i + 1], keys[i : i + 1, k0:k1],
                                  torch.tensor([k1 - k0], dtype=torch.int32), dv,
                                  return_lse=True) for k0, k1 in pieces]
        if parts:
            o, l = combine_attention(torch.stack([o[0] for o, _ in parts]),
                                     torch.stack([l[0].transpose(0, 1) for _, l in parts]))
            out[i], lse[i] = o, l.transpose(0, 1)
    return out, lse


@pytest.mark.parametrize("page_size", [64, 16, 48])
def test_mla_decode_split_plain_matches_jax(page_size):
    """B10's device split (split_plan for a card of 8 SMs: its pieces cut
    the requests at 64-key tiles across chunks) and its in-kernel merge
    (combine_attention) against JAX's mla_decode, and against the unsplit
    plain result within 1e-5 (the merge's arithmetic)."""
    b, hq, d, dv, sms = len(SPLIT_LENS), 8, 256, 128, 8
    pps = -(-512 // page_size)
    rng = np.random.RandomState(page_size)
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    pool = rng.randn(b * pps + 1, page_size, d).astype(np.float32)
    table = rng.permutation(b * pps + 1)[: b * pps].astype(np.int32).reshape(b, pps)
    lens = np.asarray(SPLIT_LENS, np.int32)
    plan = split_plan(t(lens), pps * page_size, hq, sms)
    assert plan[0] == [] and max(len(pieces) for pieces in plan) > 1
    jo, jl = jmla(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(lens), dv,
                  page_table=jnp.asarray(table), return_lse=True, interpret=True)
    so, sl = _split_plain(t(q), t(pool), t(table), t(lens), dv, plan)
    _close((np.asarray(jo), np.asarray(jl)), (so.numpy(), sl.numpy()))
    wo, wl = mla_decode_plain(t(q), t(pool), t(lens), dv, page_table=t(table), return_lse=True)
    np.testing.assert_allclose(so.numpy(), wo.numpy(), atol=1e-5, rtol=0)
    fin = torch.isfinite(wl)
    assert torch.equal(fin, torch.isfinite(sl)) and not fin[0].any()
    np.testing.assert_allclose(sl[fin].numpy(), wl[fin].numpy(), atol=1e-5, rtol=0)
    assert (so[0] == 0).all()


@pytest.mark.parametrize("rows,sms,capacity", [(16, 8, 512), (128, 132, 8192), (128, 16, 4096)])
def test_mla_split_plan_cuts_every_request(rows, sms, capacity):
    """split_plan's pieces cover each request's keys [0, len) in order, cut
    at 64-key tiles, and its chunks hold equal tile counts (within one) of
    at least MIN_SPLIT_TILES tiles where there are enough."""
    rng = np.random.RandomState(rows + sms)
    lens = rng.randint(0, capacity + 1, size=37)
    lens[:3] = [0, 1, capacity + 100]  # empty, one key, past the capacity
    plan = split_plan(torch.as_tensor(lens), capacity, rows, sms)
    total = sum(-(-n // TILE_KEYS) for n in np.minimum(lens, capacity))
    chunks = min(max(1, sms // -(-rows // 64)), max(1, total // MIN_SPLIT_TILES))
    lo, hi = total // chunks, -(-total // chunks)
    tiles = []
    for n, pieces in zip(np.minimum(lens, capacity), plan):
        starts = [k0 for k0, _ in pieces]
        assert starts == ([0] + [k1 for _, k1 in pieces[:-1]] if n else [])
        assert (pieces[-1][1] if pieces else 0) == n
        assert all(k0 % TILE_KEYS == 0 for k0, _ in pieces)
        sizes = [-(-(k1 - k0) // TILE_KEYS) for k0, k1 in pieces]
        assert all(x <= hi for x in sizes) and all(lo <= x for x in sizes[1:-1])
        tiles += sizes
    assert sum(tiles) == total and len(tiles) >= chunks
