"""Port parity: ``flash_attn_func`` and its packed forms
(``liteattention_torch.flash_attn_interface``) against the JAX API, with
the port's plain versions on CPU and the JAX kernels in interpret mode.

Routes: no mask (dense B1, plain and causal), a fine 128 x 128
``attn_read_list`` (B2 + B3) and a mask at ``block_sizes`` granularity
(coarse B4). Inputs ``[B, S, H, D]`` f32 from a seed, Sq 600 / Sk 700, 4
q-heads on 2 kv-heads. Tolerances: out and lse within 2e-5 (summation
order only); the returned masks exact (the thresholds keep every vote's
margin clear; the test checks it by moving thr by 1e-3 either way).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_attn_interface import (  # noqa: E402
    flash_attn_func as jfunc,
    flash_attn_kvpacked_func as jkvpacked,
    flash_attn_qkvpacked_func as jqkvpacked,
)
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch.flash_attn_interface import (  # noqa: E402
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
)
from liteattention_torch.ops.tile_sizes import BlockSizes  # noqa: E402

SQ, SK = 600, 700


def _bshd(seed, sq=SQ, sk=SK, h=4, hk=2, d=64):
    rng = np.random.RandomState(seed)
    base = rng.randn(1, max(sq, sk), 1, d)
    q = base[:, :sq] + 0.4 * rng.randn(1, sq, h, d)
    k = base[:, :sk] + 0.4 * rng.randn(1, sk, hk, d)
    v = rng.randn(1, sk, hk, d)
    return tuple(x.astype(np.float32) for x in (q, k, v))


def _close(p, j, atol=2e-5):
    j = np.asarray(j)
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(p.numpy()), fin)
    np.testing.assert_allclose(p.numpy()[fin], j[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_and_packed_match_jax(causal):
    q, k, v = _bshd(0, sq=300, sk=300, hk=4)
    jo, jl = jfunc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   return_softmax_lse=True, block_sizes=JBS(128, 128))
    po, pl = flash_attn_func(t(q), t(k), t(v), causal=causal, return_softmax_lse=True)
    _close(po, jo)
    _close(pl, jl)
    qkv = np.stack([q, k, v], axis=2)
    got = flash_attn_qkvpacked_func(t(qkv), causal=causal)
    want = jqkvpacked(jnp.asarray(qkv), causal=causal, block_sizes=JBS(128, 128))
    _close(got, want)
    kv = np.stack([k, v], axis=2)
    got = flash_attn_kvpacked_func(t(q), t(kv), causal=causal)
    want = jkvpacked(jnp.asarray(q), jnp.asarray(kv), causal=causal,
                     block_sizes=JBS(128, 128))
    _close(got, want)
    assert torch.equal(got, po)


def _stable_mask(run, thr):
    """The port's evolved mask at thr, checked to be the same at thr -/+
    1e-3 (every vote clear of the margin)."""
    mask = run(thr)[2]
    assert torch.equal(mask, run(thr - 1e-3)[2]) and torch.equal(mask, run(thr + 1e-3)[2])
    return mask


@pytest.mark.parametrize("thr", [-2.0, float("inf")])
def test_fine_mask_matches_jax(thr):
    q, k, v = _bshd(1)
    rng = np.random.RandomState(1)
    m = rng.rand(1, 4, 5, 6) < 0.6
    m[..., 0] = True
    m[0, 2, 3] = False  # a row with nothing live: out 0, lse -inf
    must = np.zeros(6, bool)
    must[4] = True  # tile 4 is never newly skipped
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(thr=thr, return_softmax_lse=True, return_skip_mask=True)
    jo, jl, jm = jfunc(*args, attn_read_list=jnp.asarray(m),
                       attn_must_do_list=jnp.asarray(must), block_sizes=JBS(128, 128), **kw)

    def run(th):
        return flash_attn_func(t(q), t(k), t(v), attn_read_list=t(m),
                               attn_must_do_list=t(must), **{**kw, "thr": th})

    po, pl, pm = run(thr)
    _close(po, jo)
    _close(pl, jl)
    if np.isfinite(thr):
        pm = _stable_mask(run, thr)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert (pm.numpy() <= m).all() and pm.numpy()[..., 4][m[..., 4]].all()
    # At JAX's own default tiles (a union over several fine q-rows) the
    # outputs are the same; only the vote steps differ.
    jo2 = jfunc(*args, attn_read_list=jnp.asarray(m), thr=thr)
    _close(po, jo2)


@pytest.mark.parametrize("bq,bk", [(256, 256), (128, 256), (256, 128)])
def test_coarse_mask_matches_jax(bq, bk):
    q, k, v = _bshd(2)
    qt, kt = -(-SQ // bq), -(-SK // bk)
    rng = np.random.RandomState(bq + 2 * bk)
    m = rng.rand(1, 4, qt, kt) < 0.6
    m[..., 0] = True
    kw = dict(thr=-2.0, return_softmax_lse=True, return_skip_mask=True)
    jo, jl, jm = jfunc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       attn_read_list=jnp.asarray(m), block_sizes=JBS(bq, bk), **kw)

    def run(th):
        return flash_attn_func(t(q), t(k), t(v), attn_read_list=t(m),
                               block_sizes=BlockSizes(bq, bk), **{**kw, "thr": th})

    po, pl, _ = run(-2.0)
    _close(po, jo)
    _close(pl, jl)
    np.testing.assert_array_equal(_stable_mask(run, -2.0).numpy(), np.asarray(jm))


@pytest.mark.parametrize("causal", [False, True])
def test_alibi_matches_jax(causal):
    # B1's ALiBi channel through the API: [H] slopes on flash_attn_func and
    # the packed forms, [B, H] on flash_attn_func (Sq != Sk, GQA).
    q, k, v = _bshd(4, sq=300, sk=400)
    slopes = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
    kw = dict(causal=causal, return_softmax_lse=True)
    jo, jl = jfunc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), alibi_slopes=jnp.asarray(
        slopes[None]), block_sizes=JBS(128, 128), **kw)
    po, pl = flash_attn_func(t(q), t(k), t(v), alibi_slopes=t(slopes[None]), **kw)
    _close(po, jo)
    _close(pl, jl)
    q, k, v = _bshd(5, sq=300, sk=300, hk=4)
    qkv = np.stack([q, k, v], axis=2)
    jo, jl = jqkvpacked(jnp.asarray(qkv), alibi_slopes=jnp.asarray(slopes), **kw)
    po, pl = flash_attn_qkvpacked_func(t(qkv), alibi_slopes=t(slopes), **kw)
    _close(po, jo)
    _close(pl, jl)
    kv = np.stack([k, v], axis=2)
    jo, jl = jkvpacked(jnp.asarray(q), jnp.asarray(kv), alibi_slopes=jnp.asarray(slopes), **kw)
    po, pl = flash_attn_kvpacked_func(t(q), t(kv), alibi_slopes=t(slopes), **kw)
    _close(po, jo)
    _close(pl, jl)


def test_return_order_and_unported_options():
    q, k, v = _bshd(3, sq=256, sk=256)
    m = t(np.ones((1, 4, 2, 2), bool))
    out = flash_attn_func(t(q), t(k), t(v), attn_read_list=m)
    assert out.shape == q.shape  # out alone
    out, mask = flash_attn_func(t(q), t(k), t(v), attn_read_list=m,
                                return_skip_mask=True, thr=float("-inf"))
    assert mask.dtype == torch.bool and mask.all()
    for kw in (dict(window_size=(16, 0)), dict(softcap=5.0), dict(attention_chunk=64)):
        with pytest.raises(NotImplementedError, match=next(iter(kw)).split("_")[0]):
            flash_attn_func(t(q), t(k), t(v), **kw)
    # Dropout is ported on the dense path (tests/test_torch_dropout.py);
    # the skip path is inference-only and refuses it, as JAX asserts.
    assert flash_attn_func(t(q), t(k), t(v), dropout_p=0.1, dropout_seed=4).shape == q.shape
    with pytest.raises(ValueError, match="dropout"):
        flash_attn_func(t(q), t(k), t(v), attn_read_list=m, dropout_p=0.1)
    with pytest.raises(ValueError, match="alibi_slopes"):  # not on the skip path
        flash_attn_func(t(q), t(k), t(v), attn_read_list=m, alibi_slopes=torch.ones(4))
    with pytest.raises(ValueError):  # the skip path is non-causal
        flash_attn_func(t(q), t(k), t(v), attn_read_list=m, causal=True)
    with pytest.raises(ValueError):  # a grid of neither granularity
        flash_attn_func(t(q), t(k), t(v), attn_read_list=t(np.ones((1, 4, 3, 2), bool)))
