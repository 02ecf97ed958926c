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
from liteattention_torch.ops.mla import mla_decode, mla_decode_plain  # noqa: E402

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
