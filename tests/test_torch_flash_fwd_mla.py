"""Port parity: B1's MLA channels -- V with its own head dim and the ``qv``
score term (liteattention_torch.ops.flash_fwd.flash_attention, the plain
version on the CPU) -- against the JAX package's ``flash_attention`` in
interpret mode, and ``flash_attn_func(qv=)`` against JAX's.

Tolerance: fp32 within 2e-5 absolute, as the JAX package's own test
(tests/test_mla.py): the two differ only in summation order (online
softmax over 128-key tiles against one exact softmax).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_attn_interface import flash_attn_func as jfunc  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention as jflash  # noqa: E402
from liteattention_torch.flash_attn_interface import (  # noqa: E402
    flash_attn_func,
    flash_attn_with_kvcache,
)
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    flash_attention,
    flash_attention_masked,
)

TOL = 2e-5


@pytest.mark.parametrize(
    "d,dv,use_qv,causal",
    [
        (576, 512, False, False),  # absorbed widths, no qv
        (192, 128, False, False),  # DeepSeek's non-absorbed prefill shape
        (64, 512, True, False),  # the qv . v term
        (192, 128, False, True),  # ... causal, as the prefill runs it
    ],
)
def test_mla_shapes_match_jax(d, dv, use_qv, causal):
    b, h, sq, sk = 2, 3, 192, 320
    rng = np.random.RandomState(d + dv)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, dv).astype(np.float32)
    qv = rng.randn(b, h, sq, dv).astype(np.float32) if use_qv else None
    scale = (d + (dv if use_qv else 0)) ** -0.5
    jo, jl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                    causal=causal, qv=None if qv is None else jnp.asarray(qv),
                    return_lse=True, interpret=True)
    po, pl = flash_attention(t(q), t(k), t(v), scale=scale, causal=causal,
                             qv=None if qv is None else t(qv), return_lse=True)
    assert po.shape == (b, h, sq, dv) and pl.shape == (b, h, sq)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    # flash_attention_masked routes the same shapes to the same function.
    mo = flash_attention_masked(t(q), t(k), t(v), scale=scale, causal=causal,
                                qv=None if qv is None else t(qv))
    assert torch.equal(mo, po)
    # CPU tensors never launch.
    assert flash_attention.mla_launches == 0 and flash_attention.mla_v512_launches == 0


@pytest.mark.parametrize(
    "d,dv,use_qv,h,sq,sk",
    [
        (576, 512, False, 3, 100, 200),  # absorbed widths, one KV head, Sq < Sk
        (576, 512, False, 4, 200, 130),  # ... Sq > Sk: early rows see no key
        (64, 512, True, 3, 100, 200),  # the qv . v term, one KV head
        (64, 512, True, 4, 200, 130),
        (192, 128, False, 3, 70, 257),  # the prefill shape, one KV head, ragged
    ],
)
def test_mla_gqa_causal_matches_jax(d, dv, use_qv, h, sq, sk):
    """The MLA shapes with every head on one KV head (GQA group 3 or 4),
    causal bottom-right with Sq != Sk, against JAX in interpret mode at
    the file's tolerance; rows with no key give out 0 and lse -inf in
    both."""
    rng = np.random.RandomState(d + dv + sq)
    q = rng.randn(1, h, sq, d).astype(np.float32)
    k = rng.randn(1, 1, sk, d).astype(np.float32)
    v = rng.randn(1, 1, sk, dv).astype(np.float32)
    qv = rng.randn(1, h, sq, dv).astype(np.float32) if use_qv else None
    scale = (d + (dv if use_qv else 0)) ** -0.5
    jo, jl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, causal=True,
                    qv=None if qv is None else jnp.asarray(qv), return_lse=True, interpret=True)
    po, pl = flash_attention(t(q), t(k), t(v), scale=scale, causal=True,
                             qv=None if qv is None else t(qv), return_lse=True)
    assert po.shape == (1, h, sq, dv) and pl.shape == (1, h, sq)
    jl = np.asarray(jl)
    dead = np.isneginf(jl)
    assert dead.any() == (sq > sk)
    np.testing.assert_array_equal(np.isneginf(pl.numpy()), dead)
    assert not po.numpy()[dead].any()
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_allclose(pl.numpy()[~dead], jl[~dead], atol=TOL, rtol=0)
    assert flash_attention.mla_launches == 0 and flash_attention.mla_v512_launches == 0


def test_flash_attn_func_qv_default_scale_matches_jax():
    """qv through the public API; the default scale covers D + Dv."""
    b, s, h, d, dv = 1, 256, 2, 64, 128
    rng = np.random.RandomState(1)
    q, k = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    v, qv = (rng.randn(b, s, h, dv).astype(np.float32) for _ in range(2))
    jo = jfunc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qv=jnp.asarray(qv))
    po, pl = flash_attn_func(t(q), t(k), t(v), qv=t(qv), return_softmax_lse=True)
    assert po.shape == (b, s, h, dv) and pl.shape == (b, h, s)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    explicit = flash_attn_func(t(q), t(k), t(v), qv=t(qv), softmax_scale=(d + dv) ** -0.5)
    assert torch.equal(explicit, po)


def test_mla_backward_raises_and_kvcache_mla_raises():
    """The MLA shapes are forward-only (JAX: "inference-only"); the kvcache
    API's qv and other-Dv caches are not ported (ROADMAP A11)."""
    rng = np.random.RandomState(2)
    q = t(rng.randn(1, 2, 64, 192).astype(np.float32)).requires_grad_()
    k = t(rng.randn(1, 2, 64, 192).astype(np.float32)).requires_grad_()
    v = t(rng.randn(1, 2, 64, 128).astype(np.float32)).requires_grad_()
    out = flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    qv = t(rng.randn(1, 2, 64, 192).astype(np.float32))
    out = flash_attention(q, k, k, qv=qv)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    kc = torch.zeros(1, 128, 2, 64)
    with pytest.raises(NotImplementedError, match="qv"):
        flash_attn_with_kvcache(torch.zeros(1, 1, 2, 64), kc, kc, qv=torch.zeros(1, 1, 2, 64),
                                cache_seqlens=4)
    with pytest.raises(NotImplementedError, match="v_cache_head_dim"):
        flash_attn_with_kvcache(torch.zeros(1, 1, 2, 64), kc, torch.zeros(1, 128, 2, 128),
                                cache_seqlens=4)
