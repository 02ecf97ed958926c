"""Port parity: dense forward (liteattention_torch.ops.flash_fwd, kernel B1's
plain version on CPU) against the JAX Pallas kernel in interpret mode.

Tolerances: f32 within 2e-5 (the two differ only in summation order:
online softmax over 128-key tiles vs one exact softmax); bf16 within 2e-2
(the JAX kernel rounds P to bf16 before PV, the plain version does not).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.ops.attention_ref import attention_ref as jref  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention as jflash  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch.ops.attention_ref import attention_ref  # noqa: E402
from liteattention_torch.ops.flash_fwd import flash_attention  # noqa: E402
from liteattention_torch.ops.tile_sizes import BlockSizes  # noqa: E402


@pytest.mark.parametrize(
    "b,h,hk,sq,sk,d,dtype,tol,causal",
    [
        (1, 4, 2, 300, 555, 64, "float32", 2e-5, False),  # ragged Sq/Sk, GQA 2
        (2, 2, 2, 256, 130, 128, "float32", 2e-5, False),  # D 128, ragged Sk
        (1, 4, 1, 200, 384, 64, "bfloat16", 2e-2, False),  # MQA, bf16
        (1, 4, 2, 300, 555, 64, "float32", 2e-5, True),  # causal, Sq < Sk
        (1, 2, 2, 256, 256, 128, "bfloat16", 2e-2, True),  # causal, bf16
        (1, 8, 2, 300, 200, 128, "float32", 2e-5, True),  # rows with no key, serving GQA
        (1, 8, 2, 4, 1059, 128, "bfloat16", 2e-2, True),  # the verify step
        (2, 4, 1, 1000, 77, 64, "float32", 2e-5, False),  # Sk < one tile, MQA
        (1, 4, 2, 300, 555, 80, "float32", 2e-5, False),  # D 80 (BTLM), ragged
        (1, 8, 2, 300, 200, 80, "float32", 2e-5, True),  # D 80, rows with no key
        (2, 4, 4, 200, 333, 96, "float32", 2e-5, True),  # D 96 (GPT-NeoX-20B), causal
        (1, 4, 2, 256, 130, 96, "bfloat16", 2e-2, False),  # D 96, bf16
        (1, 2, 2, 200, 300, 256, "float32", 2e-5, True),  # D 256 (GPT-J), causal, Sq < Sk
        (1, 4, 2, 130, 200, 256, "bfloat16", 2e-2, False),  # D 256, bf16, GQA
    ],
)
def test_flash_attention_matches_jax(b, h, hk, sq, sk, d, dtype, tol, causal):
    rng = np.random.RandomState(sq + sk)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    jd = jnp.dtype(dtype)
    jo, jl = jflash(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        return_lse=True, block_sizes=JBS(128, 128), causal=causal,
    )
    td = getattr(torch, dtype)
    po, pl = flash_attention(
        t(q).to(td), t(k).to(td), t(v).to(td), return_lse=True,
        block_sizes=BlockSizes(128, 128), causal=causal,
    )
    assert po.dtype == td and pl.dtype == torch.float32
    np.testing.assert_allclose(
        po.detach().float().numpy(), np.asarray(jo, np.float32), atol=tol, rtol=0
    )
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), atol=tol, rtol=0)
    assert flash_attention.launches == 0  # CPU tensors never launch


def test_attention_ref_matches_jax():
    # The fp32 oracle itself, with causal and tile-mask channels.
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 2, 260, 64).astype(np.float32) for _ in range(3))
    tm = rng.rand(1, 2, 3, 3) < 0.6
    tm[..., 0] = True
    for kw in ({"causal": True}, {"tile_mask": tm, "block_q": 128, "block_k": 128}):
        jkw = dict(kw, tile_mask=jnp.asarray(tm)) if "tile_mask" in kw else kw
        pkw = dict(kw, tile_mask=t(tm)) if "tile_mask" in kw else kw
        jo, jl = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
        po, pl = attention_ref(t(q), t(k), t(v), **pkw)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)


def test_unported_channels_raise():
    # Causal (test_torch_flash_bwd.py), qv (test_torch_flash_fwd_mla.py)
    # and dropout (test_torch_dropout.py) are ported; the MLA shapes are
    # inference-only, so dropout with them raises, as a rate of 1 does.
    x = torch.zeros(1, 1, 128, 64)
    assert flash_attention(x, x, x, dropout_p=0.1).shape == x.shape
    with pytest.raises(NotImplementedError, match="MLA shapes"):
        flash_attention(x, x, x[..., :32], dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention(x, x, x, dropout_p=1.0)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, block_sizes=BlockSizes(256, 128))
