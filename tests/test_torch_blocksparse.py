"""Port parity: the FA1-era block-sparse API
(``liteattention_torch.flash_blocksparse``) against the JAX module, on CPU:
the kernel route (a layout uniform per 8 rows, through ``flash_attn_func``
with a fine mask) and the exact 16 x 256 path (non-uniform layouts,
causal, ragged ``cu_seqlens``, key padding, probabilities, gradients).

Inputs f32 from a seed. Tolerances: converted masks exact; outputs within
2e-5 of JAX (summation order only); lse within 1e-4. Dropout draws other
random numbers than JAX (a ``torch.Generator``), so that case checks its
own properties instead of parity.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_blocksparse import (  # noqa: E402
    FlashBlocksparseAttention as JModule,
    convert_blockmask as jconvert,
    flash_blocksparse_attn_func as jfunc,
)
from liteattention_torch.flash_blocksparse import (  # noqa: E402
    FlashBlocksparseAttention,
    _no_kernel,
    convert_blockmask,
    flash_blocksparse_attn_func,
)


def _layout(rng, s, density=0.6, uniform=True):
    """A 16 x 256 layout; uniform within 8-row groups when ``uniform``."""
    coarse = rng.rand(-(-s // 128), -(-s // 256)) < density
    coarse[0, 0] = True
    bm = np.repeat(coarse, 8, axis=0)
    if not uniform:
        bm[3, 0] = not bm[3, 0]
    return bm


def _packed(seed, b, s, h=2, d=64):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b * s, 3, h, d).astype(np.float32)
    return qkv, np.arange(0, (b + 1) * s, s, dtype=np.int32)


def _close(p, j, atol=2e-5):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_convert_blockmask_matches_jax():
    rng = np.random.RandomState(0)
    for shape in ((32, 2), (21, 3)):
        bm = rng.rand(*shape) < 0.5
        np.testing.assert_array_equal(convert_blockmask(bm), jconvert(bm))
    with pytest.raises(ValueError):
        convert_blockmask(bm, causal=True)


@pytest.mark.parametrize("uniform", [True, False])
def test_func_matches_jax(uniform):
    # uniform: the kernel route; otherwise the exact 16 x 256 path.
    rng = np.random.RandomState(1)
    qkv, cu = _packed(1, 2, 512)
    bm = _layout(rng, 512, uniform=uniform)
    got = flash_blocksparse_attn_func(t(qkv), cu, bm, max_s=512)
    _close(got, jfunc(jnp.asarray(qkv), cu, bm, max_s=512))
    fine = convert_blockmask(bm)
    got = flash_blocksparse_attn_func(t(qkv), cu, fine, max_s=512, convert_mask=False)
    _close(got, jfunc(jnp.asarray(qkv), cu, fine, max_s=512, convert_mask=False))


def test_causal_ragged_and_probs_match_jax():
    rng = np.random.RandomState(2)
    lens = [300, 173, 256]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    qkv = rng.randn(cu[-1], 3, 2, 32).astype(np.float32)
    bm = _layout(rng, 512)
    for causal in (False, True):
        got = flash_blocksparse_attn_func(t(qkv), cu, bm, max_s=300, causal=causal)
        _close(got, jfunc(jnp.asarray(qkv), cu, bm, max_s=300, causal=causal))
    out, probs, lse = flash_blocksparse_attn_func(t(qkv), cu, bm, max_s=300,
                                                  return_attn_probs=True)
    jo, jp, jl = jfunc(jnp.asarray(qkv), cu, bm, max_s=300, return_attn_probs=True)
    _close(out, jo)
    _close(probs, jp)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), np.isfinite(np.asarray(jl)))
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(lse.numpy()[fin], np.asarray(jl)[fin], atol=1e-4, rtol=0)


def test_module_matches_jax():
    rng = np.random.RandomState(3)
    b, s, h, d = 2, 256, 2, 32
    qkv = rng.randn(b, s, 3, h, d).astype(np.float32)
    layout = _layout(rng, 512)[: 512 // 16, : 512 // 256]
    mod, jmod = FlashBlocksparseAttention(layout, max_seq_length=512), JModule(
        layout, max_seq_length=512)
    out, weights = mod(t(qkv))  # the kernel route
    assert weights is None
    _close(out, jmod(jnp.asarray(qkv))[0])
    valid = np.ones((b, s), bool)
    valid[0, 200:] = False  # trailing key padding: padded rows zeroed
    out, _ = mod(t(qkv), key_padding_mask=t(valid))
    _close(out, jmod(jnp.asarray(qkv), key_padding_mask=jnp.asarray(valid))[0])
    assert (out[0, 200:] == 0).all()
    with pytest.raises(ValueError):
        FlashBlocksparseAttention(layout, max_seq_length=4096)


def test_dropout_takes_a_generator():
    rng = np.random.RandomState(4)
    qkv, cu = _packed(4, 1, 256, h=2, d=32)
    bm = _layout(rng, 256)
    out = flash_blocksparse_attn_func(t(qkv), cu, bm, max_s=256)
    kw = dict(dropout_p=0.5, max_s=256)
    d1 = flash_blocksparse_attn_func(t(qkv), cu, bm, generator=torch.Generator().manual_seed(7), **kw)
    d2 = flash_blocksparse_attn_func(t(qkv), cu, bm, generator=torch.Generator().manual_seed(7), **kw)
    assert torch.equal(d1, d2) and not torch.allclose(d1, out)
    with pytest.raises(ValueError, match="Generator"):
        flash_blocksparse_attn_func(t(qkv), cu, bm, **kw)
    # The module draws its training dropout from the generator it is given.
    layout = _layout(rng, 256)
    mod = FlashBlocksparseAttention(layout, attention_dropout=0.5, max_seq_length=256)
    x = t(qkv.reshape(1, 256, 3, 2, 32))
    o1, _ = mod(x, training=True, generator=torch.Generator().manual_seed(1))
    o2, _ = mod(x)  # not training: no dropout
    assert not torch.allclose(o1, o2)


def test_trainable_path_has_finite_grads():
    qkv, cu = _packed(5, 1, 256, h=2, d=32)
    bm = np.zeros((16, 1), bool)
    bm[:8] = True  # q rows 128-255 fully masked
    x = t(qkv).requires_grad_()
    out = flash_blocksparse_attn_func(x, cu, bm, max_s=256, trainable=True)
    out.square().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert (out.reshape(256, 2, 32)[128:] == 0).all()
    _close(out.detach(), jfunc(jnp.asarray(qkv), cu, bm, max_s=256, trainable=True))


def test_cases_without_kernel_raise_only_on_the_card():
    # The exact path has no kernel: a CUDA tensor that needs it raises,
    # naming every case it took; a CPU tensor runs it (tests above).
    class CardTensor:
        is_cuda = True

    with pytest.raises(NotImplementedError, match="with causal, dropout has no CUDA kernel"):
        _no_kernel(CardTensor(), {"causal": True, "dropout": True, "trainable": False})
    _no_kernel(CardTensor(), {"causal": False, "dropout": False})  # the kernel route
    _no_kernel(torch.zeros(1), {"causal": True})
