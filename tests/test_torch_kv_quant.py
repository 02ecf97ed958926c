"""Port parity: int8 KV-cache quantization (liteattention_torch.ops.kv_quant)
against the JAX package on numpy inputs made from a seed.

The int8 values must be equal bit for bit (the same fp32 division and a
round-half-to-even in both); the scales within 1e-7 absolute (one fp32
division of the same absmax). Dequantized caches within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.ops import kv_quant as jq  # noqa: E402
from liteattention_torch.ops import kv_quant as pq  # noqa: E402

B, S, HK, D = 2, 40, 2, 64


def _cache(seed, shape=(B, S, HK, D)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    # Outlier channels, exact .5 steps (round-half-to-even) and zeros.
    x[..., 3] *= 30.0
    x[..., 5] = np.round(x[..., 5] * 2) / 2
    x[0, :, 0, 7] = 0.0
    return x


def _same(port, ref, scales=False):
    ref = np.asarray(ref)
    if scales:
        np.testing.assert_allclose(port.numpy(), ref, atol=1e-7, rtol=0)
    else:
        assert port.dtype == torch.int8
        np.testing.assert_array_equal(port.numpy(), ref)


def test_quantize_kv_cache_and_append():
    k, v = _cache(0), _cache(1)
    jc = jq.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v))
    pc = pq.quantize_kv_cache(t(k), t(v))
    for a, b_, sc in zip(pc, jc, (False, False, True, True)):
        _same(a, b_, sc)
    rng = np.random.RandomState(2)
    kn, vn = (3 * rng.randn(B, 3, HK, D)).astype(np.float32), rng.randn(B, 3, HK, D).astype(np.float32)
    pos = np.array([5, 31], np.int32)
    jc2 = jq.quantize_kv_append(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
    pc2 = pq.quantize_kv_append(pc, t(kn), t(vn), t(pos))
    assert pc2.k is pc.k  # in place
    for a, b_, sc in zip(pc2, jc2, (False, False, True, True)):
        _same(a, b_, sc)
    jd = jq.dequantize_kv_cache(jc2, jnp.float32)
    pd = pq.dequantize_kv_cache(pc2, torch.float32)
    for a, b_ in zip(pd, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-6, rtol=0)


def test_quantize_native_layout():
    k, v = _cache(3, (B, HK, S, D)), _cache(4, (B, HK, S, D))
    jc = jq.quantize_kv_cache_native(jnp.asarray(k), jnp.asarray(v))
    pc = pq.quantize_kv_cache_native(t(k), t(v))
    for a, b_, sc in zip(pc, jc, (False, False, True, True)):
        _same(a, b_, sc)
    rows = (5 * np.random.RandomState(5).randn(B, HK, 2, D)).astype(np.float32)  # clamps
    _same(pq.quantize_rows_native(t(rows), pc.k_scale),
          jq.quantize_rows_native(jnp.asarray(rows), jc.k_scale))


def test_quantize_pages_and_append():
    n_pages, psz = 6, 16
    k, v = _cache(6, (n_pages, psz, HK, D)), _cache(7, (n_pages, psz, HK, D))
    jp = jq.quantize_kv_pages(jnp.asarray(k), jnp.asarray(v))
    pp = pq.quantize_kv_pages(t(k), t(v))
    for a, b_, sc in zip(pp, jp, (False, False, True, True)):
        _same(a, b_, sc)
    table = np.array([[4, 1, 0], [2, 5, 3]], np.int32)
    pos = np.array([14, 20], np.int32)  # the first append crosses a page
    rng = np.random.RandomState(8)
    kn, vn = rng.randn(2, 3, HK, D).astype(np.float32), rng.randn(2, 3, HK, D).astype(np.float32)
    jp2 = jq.quantize_pages_append(jp, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
                                   jnp.asarray(pos))
    pp2 = pq.quantize_pages_append(pp, t(kn), t(vn), t(table), t(pos))
    assert pp2.v is pp.v  # in place
    for a, b_, sc in zip(pp2, jp2, (False, False, True, True)):
        _same(a, b_, sc)
