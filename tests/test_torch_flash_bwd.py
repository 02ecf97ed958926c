"""Port parity: the flash backward (liteattention_torch.ops.flash_bwd: on
CPU the plain version of kernel B7's one pass, and B7a's / B7b's plain
versions that the card is held against) and autograd through the port's
flash_attention, against the JAX package (Pallas kernels in interpret mode).

fp32 inputs. Tolerances: dq, dk, dv within 1e-4 absolute of JAX, whose
largest entries here are O(1-10) (the two differ in summation order only:
tiled online sums against whole-row products); forward out / lse within
2e-5 as in test_torch_flash_fwd.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention as jflash  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    check_window,
    flash_attention_bwd,
    flash_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
    flash_bwd_plain,
)
from liteattention_torch.ops.flash_fwd import flash_attention  # noqa: E402

BS = JBS(128, 128)
GRAD_TOL = 1e-4

# (b, h, hk, sq, sk, d, causal): square, GQA, ragged, sq > sk (causal rows
# with no valid key), sq < sk, MQA, D 64, 80, 96, 128 and 256 (GPT-J).
CASES = [
    (1, 2, 2, 256, 256, 64, True),
    (1, 2, 2, 256, 256, 64, False),
    (1, 4, 2, 300, 200, 64, True),
    (1, 2, 1, 130, 300, 128, True),
    (2, 2, 2, 200, 333, 128, False),
    (1, 4, 2, 150, 150, 64, True),
    (1, 4, 2, 300, 200, 80, True),
    (2, 2, 2, 200, 333, 96, False),
    (1, 2, 2, 200, 200, 256, True),
    (1, 4, 2, 150, 130, 256, False),
]


def _inputs(b, h, hk, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("b,h,hk,sq,sk,d,causal", CASES)
def test_flash_bwd_matches_jax(b, h, hk, sq, sk, d, causal):
    q, k, v, do = _inputs(b, h, hk, sq, sk, d, seed=sq + sk + d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jo, jl = jflash(jq, jk, jv, causal=causal, block_sizes=BS, return_lse=True, interpret=True)
    scale = d**-0.5
    ref = jbwd(jq, jk, jv, jo, jl, jnp.asarray(do), scale, causal, block_sizes=BS, interpret=True)
    o, lse = t(jo), t(jl)
    if causal and sq > sk:
        assert not torch.isfinite(lse).all()  # rows with no valid key
    got = flash_attention_bwd(t(q), t(k), t(v), o, lse, t(do), scale, causal)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL, rtol=0, err_msg=name)
    assert flash_bwd.launches == 0  # CPU never launches


@pytest.mark.parametrize("b,h,hk,sq,sk,d,causal", CASES)
def test_one_pass_plain_matches_jax(b, h, hk, sq, sk, d, causal):
    # The one pass over 128-key tiles (dQ summed tile after tile), and
    # B7a's / B7b's plain versions, against JAX's backward.
    q, k, v, do = _inputs(b, h, hk, sq, sk, d, seed=3 * sq + sk + d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jo, jl = jflash(jq, jk, jv, causal=causal, block_sizes=BS, return_lse=True, interpret=True)
    scale = d**-0.5
    ref = jbwd(jq, jk, jv, jo, jl, jnp.asarray(do), scale, causal, block_sizes=BS, interpret=True)
    o, lse, tdo = t(jo), t(jl), t(do)
    got = flash_bwd_plain(t(q), t(k), t(v), o, lse, tdo, scale, causal)
    delta = (o * tdo).sum(-1)
    args = (t(q), t(k), t(v), tdo, lse, delta, scale, causal)
    two = (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))
    for g, g2, r, name in zip(got, two, ref, ("dq", "dk", "dv")):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(g2.numpy(), np.asarray(r), atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize(
    "b,h,hk,sq,sk,d,causal",
    [CASES[0], CASES[1], CASES[2], CASES[3]],
)
def test_autograd_matches_jax_vjp(b, h, hk, sq, sk, d, causal):
    q, k, v, do = _inputs(b, h, hk, sq, sk, d, seed=7 + sq)
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: jflash(q_, k_, v_, causal=causal, block_sizes=BS, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    out.backward(t(do))
    for g, r, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")


def test_causal_empty_rows_forward():
    # sq > sk, causal: the first sq - sk rows see no key -> out 0, lse -inf,
    # as the JAX kernel gives (its running max never leaves the sentinel).
    q, k, v, _ = _inputs(1, 2, 2, 300, 100, 64, seed=5)
    jo, jl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    block_sizes=BS, return_lse=True, interpret=True)
    po, pl = flash_attention(t(q), t(k), t(v), causal=True, return_lse=True)
    empty = ~torch.isfinite(pl)
    assert empty[..., :200].all() and not empty[..., 200:].any()
    np.testing.assert_array_equal(np.isfinite(np.asarray(jl)), ~empty.numpy())
    assert po.detach()[..., :200, :].abs().max().item() == 0.0
    fin = ~empty
    np.testing.assert_allclose(pl[fin].detach().numpy(), np.asarray(jl)[fin.numpy()], atol=2e-5, rtol=0)
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), atol=2e-5, rtol=0)


def test_unported_channels_raise():
    x = torch.zeros(1, 1, 128, 64)
    lse = torch.zeros(1, 1, 128)
    # The window is ported (tests/test_torch_window_softcap.py); on the card
    # it is not built at head dim 96 (ROADMAP B-iii 4).
    assert all(g.shape == x.shape for g in flash_attention_bwd(x, x, x, x, lse, x, 0.125, False,
                                                               window=(4, 4)))
    with pytest.raises(NotImplementedError, match="B-iii 4"):
        check_window(96, True, False, False, False, "flash_bwd")
    with pytest.raises(TypeError):
        flash_attention_bwd(x, x, x, x, lse, x, 0.125, False, not_a_channel=1)
