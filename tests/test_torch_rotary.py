"""Port parity: rotary embeddings (liteattention_torch.layers.rotary) against
the JAX package on numpy inputs.

Both rotate in fp32 with the same tables, so fp32 outputs agree to a few
ulps (tolerance 1e-6 absolute on O(1) values); the cos/sin tables within
1e-6 (fp32 sin/cos of the same fp32 angles, two libm implementations).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.layers import rotary as jrot  # noqa: E402
from liteattention_torch.layers.rotary import (  # noqa: E402
    RotaryEmbedding,
    apply_rotary_emb,
    rotary_freqs,
)


@pytest.mark.parametrize("seqlen,rotary_dim,base,offset", [
    (7, 64, 10000.0, 0),
    (5, 32, 500000.0, 1021),
])
def test_rotary_freqs_match_jax(seqlen, rotary_dim, base, offset):
    jc, js = jrot.rotary_freqs(seqlen, rotary_dim, base, offset)
    pc, ps = rotary_freqs(seqlen, rotary_dim, base, offset, device="cpu")
    assert pc.shape == (seqlen, rotary_dim // 2) and pc.dtype == torch.float32
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6, rtol=0)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("head_dim,rotary_dim", [(64, 64), (128, 32)])  # full, partial
@pytest.mark.parametrize("offset", [0, 37])
def test_rotary_module_matches_jax(interleaved, head_dim, rotary_dim, offset):
    rng = np.random.RandomState(head_dim + offset)
    q = rng.randn(2, 9, 4, head_dim).astype(np.float32)
    k = rng.randn(2, 9, 2, head_dim).astype(np.float32)
    jmod = jrot.RotaryEmbedding(rotary_dim, 10000.0, interleaved)
    jq, jk = jmod.apply({}, jnp.asarray(q), jnp.asarray(k), seqlen_offset=offset)
    pq, pk = RotaryEmbedding(rotary_dim, 10000.0, interleaved)(t(q), t(k), seqlen_offset=offset)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    # The pass-through features are untouched.
    np.testing.assert_array_equal(pq[..., rotary_dim:].numpy(), q[..., rotary_dim:])


def test_rotary_bf16_matches_jax():
    # bf16 in, fp32 rotation, bf16 out: one rounding of the same fp32
    # values (2^-8 relative), so the outputs agree to one bf16 ulp.
    rng = np.random.RandomState(1)
    x = rng.randn(1, 6, 2, 64).astype(np.float32)
    jc, js = jrot.rotary_freqs(6, 64, offset=3)
    pc, ps = rotary_freqs(6, 64, offset=3, device="cpu")
    j = jrot.apply_rotary_emb(jnp.asarray(x, jnp.bfloat16), jc, js)
    p = apply_rotary_emb(t(x).bfloat16(), pc, ps)
    assert p.dtype == torch.bfloat16
    np.testing.assert_allclose(p.float().numpy(), np.asarray(j, np.float32), atol=2e-2, rtol=8e-3)
