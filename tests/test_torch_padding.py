"""Port parity: liteattention_torch.utils.padding against the JAX package's
utils/padding.py on the same numpy batches (exact: gathers, scatters and
integer prefix sums), and the unpad -> flash_attn_varlen_func -> pad route
against B1's bound channel over the padded batch (fp32, 2e-5 absolute on
the valid rows, with the gradient).

One difference is stated, not asserted equal: JAX's
unpad_input_for_concatenated_sequences drops the samples past max_seqs
without a word (ROADMAP C); the port raises ValueError there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.utils import padding as jpad  # noqa: E402
from liteattention_torch import flash_attn_varlen_func  # noqa: E402
from liteattention_torch.ops.flash_fwd import flash_attention_masked  # noqa: E402
from liteattention_torch.utils import padding as ppad  # noqa: E402

TOL = 2e-5
LENGTHS = [37, 64, 1, 0, 50]
S = 64


def _batch(seed, feat=(3, 4)):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(LENGTHS), S, *feat).astype(np.float32)
    mask = (np.arange(S)[None] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    return x, mask


@pytest.mark.parametrize("max_tokens", [None, 160, sum(LENGTHS)])
def test_unpad_and_pad_match_jax(max_tokens):
    x, mask = _batch(max_tokens or 0)
    jp, ji, jc, jt = jpad.unpad_input(jnp.asarray(x), jnp.asarray(mask), max_tokens)
    pp, pi, pc, pt = ppad.unpad_input(t(x), t(mask), max_tokens)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert int(pt) == int(jt) == sum(LENGTHS)
    assert pc.dtype == pi.dtype == torch.int32
    back = ppad.pad_input(pp, pi, len(LENGTHS), S)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpad.pad_input(jp, ji, len(LENGTHS), S)))
    # The round trip keeps the valid rows and zeroes the padding.
    np.testing.assert_array_equal(back.numpy(), x * mask[..., None, None])
    np.testing.assert_array_equal(ppad.index_first_axis(t(x), pi[:5]).numpy(),
                                  np.asarray(jpad.index_first_axis(jnp.asarray(x), ji[:5])))


@pytest.mark.parametrize("max_seqs", [None, 7, 9])
def test_unpad_concatenated_sequences_matches_jax(max_seqs):
    # Rows of concatenated samples: lengths per row (0: none), 7 in all.
    rng = np.random.RandomState(3)
    x = rng.randn(3, 40, 8).astype(np.float32)
    lens = np.asarray([[10, 20, 0, 5], [40, 0, 0, 0], [1, 2, 3, 0]], np.int32)
    jl = np.zeros((3, 40), np.int32)
    jl[:, :4] = lens
    ref = jpad.unpad_input_for_concatenated_sequences(jnp.asarray(x), jnp.asarray(jl),
                                                      max_tokens=100, max_seqs=max_seqs)
    got = ppad.unpad_input_for_concatenated_sequences(t(x), t(jl), max_tokens=100,
                                                      max_seqs=max_seqs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2].tolist()[:8] == [0, 10, 30, 35, 75, 76, 78, 81]


def test_unpad_concatenated_sequences_raises_past_max_seqs():
    # JAX keeps the first max_seqs samples and drops the rest silently (its
    # cu_seqlens ends short of the valid tokens); the port raises.
    x = np.zeros((3, 40, 8), np.float32)
    jl = np.zeros((3, 40), np.int32)
    jl[:, :4] = [[10, 20, 0, 5], [40, 0, 0, 0], [1, 2, 3, 0]]
    _, _, jcu, _ = jpad.unpad_input_for_concatenated_sequences(jnp.asarray(x), jnp.asarray(jl),
                                                               max_seqs=5)
    assert int(np.asarray(jcu)[-1]) == 76 < 81
    with pytest.raises(ValueError, match="7 samples exceed max_seqs 5"):
        ppad.unpad_input_for_concatenated_sequences(t(x), t(jl), max_seqs=5)


def test_unpad_varlen_pad_equals_the_bound_channel():
    # BERT's two routes over one right-padded batch: unpad -> the varlen
    # function (segments) -> pad, and B1's bound channel over the padded
    # batch; the valid rows and the gradients agree. The rows past the total
    # (max_tokens None) form the phantom segment of zeros.
    rng = np.random.RandomState(8)
    b, h, d = len(LENGTHS), 2, 64
    q, k, v, do = (rng.randn(b, S, h, d).astype(np.float32) for _ in range(4))
    mask = (np.arange(S)[None] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    packed = [ppad.unpad_input(x, t(mask)) for x in (tq, tk, tv)]
    _, idx, cu, _ = packed[0]
    out = flash_attn_varlen_func(packed[0][0], packed[1][0], packed[2][0], cu, cu)
    out = ppad.pad_input(out, idx, b, S)
    (out * t(do * mask[..., None, None])).sum().backward()
    grads = [x.grad.clone() for x in (tq, tk, tv)]
    rq, rk, rv = (t(x).requires_grad_() for x in (q, k, v))
    ref = flash_attention_masked(rq.transpose(1, 2), rk.transpose(1, 2), rv.transpose(1, 2),
                                 kv_bound=t(mask.sum(-1))).transpose(1, 2)
    (ref * t(do * mask[..., None, None])).sum().backward()
    valid = mask.astype(bool)
    np.testing.assert_allclose(out.detach().numpy()[valid], ref.detach().numpy()[valid],
                               atol=TOL, rtol=0)
    for g, r, n in zip(grads, (rq.grad, rk.grad, rv.grad), "qkv"):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0, err_msg=f"d{n}")
