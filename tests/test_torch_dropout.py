"""Port parity: attention dropout and residual dropout against the JAX
package.

* ``dropout_keep_mask`` (``liteattention_torch.ops.dropout``, re-exported
  from ``ops/flash_fwd.py``) equals JAX's bit for bit over negative, zero
  and large int32 seeds, ``bh``, row and column offsets and p.
* ``flash_attention(dropout_p, dropout_seed)`` and
  ``flash_attention_masked`` with dropout (the plain versions of B1 and B7
  on the CPU) against JAX's kernels in interpret mode at the same int32
  seed: out and lse, autograd against ``jax.vjp``, and
  ``flash_attention_bwd`` against JAX's, with and without the key range,
  ALiBi and segments. fp32 at 2e-5 absolute, as the channel tests hold
  them (the two differ in summation order only).
* The keep mask's bits do not depend on the tile geometry, and the plain
  versions agree at two q-row chunk and key-tile sizes within 5e-6 (the
  products' summation order; a mask that moved would differ by ~0.1).
* ``dropout_add_{layer,rms}_norm``, ``MHA``, ``Block`` and a tiny GPT with
  dropout 0.1: with ``deterministic=True`` equal to JAX; with
  ``deterministic=False`` the port draws its seeds and masks from a
  ``torch.Generator``, the test records them and hands them to JAX by
  monkeypatching ``jax.random.randint`` and ``jax.random.bernoulli`` as
  the JAX modules call them, and then the outputs, the loss and the
  gradients equal JAX's (fp32: 1e-5 absolute for the norms' and modules'
  outputs and input gradients, 1e-5 rel-L2 for MHA's parameter gradients,
  sums over the batch; 1e-4 rel-L2 for the GPT's logits and gradients and
  the loss within 1e-5 relative, as tests/test_torch_gpt.py holds the
  dropout-free model).

CPU time: ~1 min in one process.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import liteattention_torch.modules.mha as mha_mod  # noqa: E402
import liteattention_torch.ops.flash_bwd as bwd_mod  # noqa: E402
import liteattention_torch.ops.flash_fwd as fwd_mod  # noqa: E402
from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.losses.cross_entropy import cross_entropy_loss as jce  # noqa: E402
from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.modules.block import Block as JBlock  # noqa: E402
from liteattention_tpu.modules.mha import MHA as JMHA  # noqa: E402
from liteattention_tpu.modules.mha import alibi_slopes as jalibi_slopes  # noqa: E402
from liteattention_tpu.modules.mlp import Mlp as JMlp  # noqa: E402
from liteattention_tpu.ops import norms as jnorms  # noqa: E402
from liteattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd  # noqa: E402
from liteattention_tpu.ops.flash_fwd import dropout_keep_mask as jkeep  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention as jflash  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_torch.losses.cross_entropy import cross_entropy_loss  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.modules import MHA, Block, Mlp  # noqa: E402
from liteattention_torch.ops import norms  # noqa: E402
from liteattention_torch.ops.flash_bwd import flash_attention_bwd  # noqa: E402
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    check_dropout,
    dropout_keep_mask,
    flash_attention,
    flash_attention_masked,
)

TOL = 2e-5

# ------------------------------------------------------------- the mask

SEEDS = [-(2**31), -7, 0, 1234567, 2**31 - 1]


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_matches_jax(seed, p):
    for bh, row0, col0, shape in ((0, 0, 0, (64, 128)), (77, 4096, 960, (40, 200)),
                                  (12345, 100_000, 3, (16, 257)), (2**20, 2**30, 2**30, (8, 8))):
        ref = np.asarray(jkeep(jnp.int32(seed), jnp.int32(bh), row0, col0, shape, p))
        got = dropout_keep_mask(seed, bh, row0, col0, shape, p)
        assert got.dtype == torch.bool and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), ref)
    # A tensor seed is read where it lies (the kernels read it on the card).
    got = dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), 3, 5, 7, (32, 32), p)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkeep(jnp.int32(seed), jnp.int32(3), 5, 7, (32, 32), p)))


def test_keep_share_and_threshold():
    keep = dropout_keep_mask(99, 0, 0, 0, (512, 512), 0.1)
    share = keep.float().mean().item()
    assert abs(share - 0.9) < 4 * (0.9 * 0.1 / keep.numel()) ** 0.5
    assert not (~dropout_keep_mask(99, 0, 0, 0, (64, 64), 0.0)).any()
    for bad in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="dropout_p"):
            dropout_keep_mask(0, 0, 0, 0, (4, 4), bad)


# ------------------------------------------------------- B1 and B7

P_DROP = 0.3
SEED = -123457

# (b, h, hk, sq, sk, d), causal
SHAPES = {
    "noncausal": ((2, 4, 4, 256, 256, 64), False),
    "causal_gqa": ((2, 4, 2, 200, 200, 64), True),
    "causal_sq_lt_sk_mqa": ((1, 4, 1, 130, 300, 128), True),
    "noncausal_sq_gt_sk_ragged": ((2, 2, 2, 257, 130, 64), False),
}


def _inputs(seed, b, h, hk, sq, sk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, do


def _close(got, ref, name=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(ref), atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", list(SHAPES))
def test_flash_attention_dropout_matches_jax(name):
    (b, h, hk, sq, sk, d), causal = SHAPES[name]
    q, k, v, do = _inputs(1, b, h, hk, sq, sk, d)
    jseed = jnp.int32(SEED)

    def jf(q_, k_, v_):
        return jflash(q_, k_, v_, causal=causal, dropout_p=P_DROP, dropout_seed=jseed,
                      return_lse=True, interpret=True)

    (jo, jl), vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp((jnp.asarray(do), jnp.zeros_like(jl)))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    po, pl = flash_attention(tq, tk, tv, causal=causal, dropout_p=P_DROP, dropout_seed=SEED,
                             return_lse=True)
    _close(po, jo, "out")
    _close(pl, jl, "lse")
    # lse is dropout-free.
    _, l0 = flash_attention(t(q), t(k), t(v), causal=causal, return_lse=True)
    np.testing.assert_allclose(pl.numpy(), l0.numpy(), atol=1e-6, rtol=0)
    po.backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        _close(g, r, f"d{n} (autograd)")
    # flash_attention_bwd on JAX's out and lse, against JAX's.
    scale = d**-0.5
    ref = jbwd(*(jnp.asarray(x) for x in (q, k, v)), jo, jl, jnp.asarray(do), scale, causal,
               dropout_p=P_DROP, dropout_seed=jseed, interpret=True)
    got = flash_attention_bwd(t(q), t(k), t(v), t(jo), t(jl), t(do), scale, causal,
                              dropout_p=P_DROP, dropout_seed=torch.tensor(SEED))
    for g, r, n in zip(got, ref, "qkv"):
        _close(g, r, f"d{n} (flash_attention_bwd)")
    # One pass and B7a / B7b's plain versions agree on JAX's inputs.
    delta = (t(jo) * t(do)).sum(-1)
    pargs = (t(q), t(k), t(v), t(do), t(jl), delta, scale, causal)
    ch = dict(dropout_p=P_DROP, dropout_seed=SEED)
    _close(bwd_mod.flash_bwd_dq_plain(*pargs, **ch), ref[0], "dq (B7a plain)")
    for g, r, n in zip(bwd_mod.flash_bwd_dkv_plain(*pargs, **ch), ref[1:], "kv"):
        _close(g, r, f"d{n} (B7b plain)")


# B1's channels with dropout: kv_bound, kv_low, bound_causal, ALiBi and
# segments; (b, h, hk, sq, sk, d), kwargs, causal.
CHANNEL_CASES = {
    "bound_low": ((3, 4, 2, 140, 300, 64), dict(kv_bound=[300, 131, 270], kv_low=[5, 0, 140]),
                  False),
    "bound_causal_cache": ((2, 4, 2, 100, 300, 64), dict(kv_bound=[260, 150], bound_causal=True),
                           False),
    "alibi_causal": ((2, 4, 2, 200, 200, 64), dict(alibi="h"), True),
    "segments_causal": ((1, 2, 1, 300, 300, 64), dict(segments=[0, 90, 210]), True),
}


def _channels(kw, b, h, sq, sk, numpy=False):
    arr = (lambda x, dt: np.asarray(x, dt)) if numpy else (lambda x, dt: torch.tensor(
        np.asarray(x, dt)))
    out = {}
    for name in ("kv_bound", "kv_low"):
        if name in kw:
            out[name] = arr(kw[name], np.int32)
    if kw.get("bound_causal"):
        out["bound_causal"] = True
    if kw.get("alibi"):
        out["alibi_slopes"] = arr(np.asarray(jalibi_slopes(h)), np.float32)
    if "segments" in kw:
        starts = kw["segments"]
        ids = np.zeros(sq, np.int32)
        for i, s0 in enumerate(starts):
            ids[s0:] = i
        out["q_segments"] = arr(ids[None], np.int32)
        out["kv_segments"] = arr(ids[None, :sk], np.int32)
    return out


@pytest.mark.parametrize("name", list(CHANNEL_CASES))
def test_channels_with_dropout_match_jax(name):
    (b, h, hk, sq, sk, d), kw, causal = CHANNEL_CASES[name]
    q, k, v, do = _inputs(2, b, h, hk, sq, sk, d)
    jch = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in _channels(kw, b, h, sq, sk, numpy=True).items()}
    jseed = jnp.int32(SEED)

    def jf(q_, k_, v_):
        return jmasked(q_, k_, v_, causal=causal, dropout_p=P_DROP, dropout_seed=jseed,
                       return_lse=True, interpret=True, **jch)

    (jo, jl), vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp((jnp.asarray(do), jnp.zeros_like(jl)))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    pch = _channels(kw, b, h, sq, sk)
    po, pl = flash_attention_masked(tq, tk, tv, causal=causal, dropout_p=P_DROP,
                                    dropout_seed=SEED, return_lse=True, **pch)
    _close(po, jo, "out")
    fin = np.isfinite(np.asarray(jl))
    np.testing.assert_array_equal(np.isfinite(pl.numpy()), fin)
    _close(pl.numpy()[fin], np.asarray(jl)[fin], "lse")
    po.backward(t(do))
    for g, r, n in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        _close(g, r, f"d{n}")
    # The card takes the key range with dropout, and raises with ALiBi or
    # segments (ROADMAP B-i 5).
    if "alibi" in kw or "segments" in kw:
        with pytest.raises(NotImplementedError, match="B-i 5"):
            check_dropout(d, "alibi" in kw, "segments" in kw, "flash_attention")
    else:
        check_dropout(d, False, False, "flash_attention")


def test_dropout_other_head_dims_raise_on_the_card_only():
    for d in (80, 96, 256):
        with pytest.raises(NotImplementedError, match=f"head dim {d}.*B-iii 4"):
            check_dropout(d, False, False, "flash_attention")
    # The plain versions take them: at head dim 80 against JAX.
    q, k, v, _ = _inputs(3, 1, 2, 2, 130, 130, 80)
    jo = jflash(*(jnp.asarray(x) for x in (q, k, v)), causal=True, dropout_p=P_DROP,
                dropout_seed=jnp.int32(5), interpret=True)
    _close(flash_attention(t(q), t(k), t(v), causal=True, dropout_p=P_DROP, dropout_seed=5), jo)


def test_keep_mask_is_tile_geometry_invariant():
    # JAX's property: a mask cut into tiles at any geometry is the whole
    # mask's bits (B1's 128-key tiles and B7's 64-row steps read the same).
    whole = dropout_keep_mask(SEED, 5, 0, 0, (384, 384), P_DROP)
    for bq, bk in ((64, 128), (128, 64), (96, 384), (384, 32)):
        tiles = torch.cat([torch.cat([
            dropout_keep_mask(SEED, 5, r0, c0, (bq, bk), P_DROP) for c0 in range(0, 384, bk)
        ], dim=1) for r0 in range(0, 384, bq)], dim=0)
        assert torch.equal(tiles, whole)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_same_bits_at_two_chunk_sizes(causal, monkeypatch):
    q, k, v, do = _inputs(4, 2, 2, 1, 300, 260, 64)
    kw = dict(causal=causal, dropout_p=0.5, dropout_seed=77)

    def run():
        tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
        out = flash_attention(tq, tk, tv, **kw)
        out.backward(t(do))
        delta = (out.detach() * t(do)).sum(-1)
        lse = flash_attention(t(q), t(k), t(v), return_lse=True, **kw)[1]
        dkv = bwd_mod.flash_bwd_dkv_plain(t(q), t(k), t(v), t(do), lse, delta, 0.125, causal,
                                          dropout_p=0.5, dropout_seed=77)
        return [out.detach(), tq.grad, tk.grad, tv.grad, *dkv]

    ref = run()
    monkeypatch.setattr(fwd_mod, "PLAIN_Q_CHUNK", 64)
    monkeypatch.setattr(bwd_mod, "PLAIN_Q_CHUNK", 96)
    monkeypatch.setattr(bwd_mod, "TILE_K", 64)
    # The same mask at every chunk: the products' summation order moves
    # the last bits of fp32 (a mask that moved would change them by ~0.1).
    for got, r in zip(run(), ref):
        np.testing.assert_allclose(got.numpy(), r.numpy(), atol=5e-6, rtol=0)


def test_seed_and_rate_arguments():
    q, k, v, _ = (t(x) for x in _inputs(5, 1, 2, 2, 64, 64, 64))
    base = flash_attention(q, k, v)
    # A seed without dropout_p does nothing, as in JAX.
    np.testing.assert_array_equal(flash_attention_masked(q, k, v, dropout_seed=3).numpy(),
                                  base.numpy())
    # No seed: 0, as in JAX.
    np.testing.assert_array_equal(flash_attention(q, k, v, dropout_p=0.2).numpy(),
                                  flash_attention(q, k, v, dropout_p=0.2, dropout_seed=0).numpy())
    assert not torch.equal(flash_attention(q, k, v, dropout_p=0.2, dropout_seed=1), base)
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention(q, k, v, dropout_p=1.0)
    with pytest.raises(ValueError, match="one integer"):
        flash_attention(q, k, v, dropout_p=0.2, dropout_seed=torch.tensor([1, 2]))


# ------------------------------------------------------- the modules


class Draws:
    """Records the seeds and masks the port draws, and hands them to JAX
    in the same order through ``jax.random.randint`` /
    ``jax.random.bernoulli`` (as the JAX modules call them)."""

    def __init__(self, monkeypatch):
        self.seeds, self.masks = [], []
        draw_seed, draw_mask = mha_mod.draw_dropout_seed, norms.dropout_mask

        def seed(generator, device):
            s = draw_seed(generator, device)
            self.seeds.append(int(s))
            return s

        def mask(x, p, generator):
            m = draw_mask(x, p, generator)
            self.masks.append(m.numpy())
            return m

        monkeypatch.setattr(mha_mod, "draw_dropout_seed", seed)
        monkeypatch.setattr(norms, "dropout_mask", mask)
        self.monkeypatch = monkeypatch

    def to_jax(self):
        seeds, masks, by_key = list(self.seeds), list(self.masks), {}

        def randint(key, shape, minval, maxval, dtype):
            assert shape == () and (minval, maxval) == (-(2**31), 2**31 - 1)
            return jnp.asarray(seeds.pop(0), dtype)

        def bernoulli(key, p, shape):
            # JAX's untied parallel block draws norm1's mask again from the
            # same key; the port reuses norm1's sum.
            k = np.asarray(key).tobytes()
            if k not in by_key:
                by_key[k] = masks.pop(0)
            assert tuple(shape) == by_key[k].shape
            return jnp.asarray(by_key[k])

        self.monkeypatch.setattr(jax.random, "randint", randint)
        self.monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        return lambda: (seeds, masks)


@pytest.mark.parametrize("rms,prenorm,fp32res", [
    (False, True, True), (True, True, False), (False, False, False),
])
def test_dropout_add_norms_match_jax(rms, prenorm, fp32res, monkeypatch):
    rng = np.random.RandomState(6)
    x, res = rng.randn(2, 50, 64).astype(np.float32), rng.randn(2, 50, 64).astype(np.float32)
    w, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    jfn = jnorms.dropout_add_rms_norm if rms else jnorms.dropout_add_layer_norm
    pfn = norms.dropout_add_rms_norm if rms else norms.dropout_add_layer_norm
    jargs = (jnp.asarray(x), jnp.asarray(res), jnp.asarray(w), None if rms else jnp.asarray(b))
    pargs = (t(x), t(res), t(w), None if rms else t(b))
    kw = dict(eps=1e-5, prenorm=prenorm, residual_in_fp32=fp32res)
    # deterministic (the default): no dropout, whatever dropout_p.
    j = jfn(*jargs, 0.25, None, **kw)
    p = pfn(*pargs, 0.25, **kw)
    for a, r in zip(*(((p,), (j,)) if not prenorm else (p, j))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    draws = Draws(monkeypatch)
    p = pfn(*pargs, 0.25, generator=torch.Generator().manual_seed(3), deterministic=False, **kw)
    left = draws.to_jax()
    j = jfn(*jargs, 0.25, jax.random.PRNGKey(0), deterministic=False, **kw)
    assert left() == ([], [])
    assert 0.6 < draws.masks[0].mean() < 0.9
    for a, r in zip(*(((p,), (j,)) if not prenorm else (p, j))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="Generator"):
        pfn(*pargs, 0.25, deterministic=False, **kw)


def _mha_pair(dropout, hk=2):
    jm = JMHA(64, 4, num_heads_kv=hk, causal=True, dropout=dropout, dtype=jnp.float32,
              name="mha")
    pm = MHA(64, 4, num_heads_kv=hk, causal=True, dropout=dropout, dtype=torch.float32,
             device="cpu")
    return jm, pm


def test_mha_dropout_matches_jax(monkeypatch):
    x = np.random.RandomState(7).randn(2, 96, 64).astype(np.float32)
    jm, pm = _mha_pair(0.3)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    pm.load_state_dict(gpt_state_dict_from_jax(params))
    det = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(pm(t(x)).numpy(), np.asarray(det), atol=1e-5, rtol=0)
    draws = Draws(monkeypatch)
    xt = t(x).requires_grad_()
    g = torch.Generator().manual_seed(11)
    out = pm(xt, deterministic=False, generator=g)
    dy = np.random.RandomState(8).randn(*out.shape).astype(np.float32)
    out.backward(t(dy))
    left = draws.to_jax()

    def f(p_, x_):
        return jm.apply(p_, x_, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})

    jo, vjp = jax.vjp(f, params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    assert left() == ([], []) and len(draws.seeds) == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(jo) - np.asarray(det)).max() > 1e-2
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    jgrads = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    for n, prm in pm.named_parameters():  # sums over the batch: relative
        assert rel_l2(prm.grad.numpy(), jgrads[n].numpy()) < 1e-5, n
    # The same generator state gives the same output; another, another.
    again = pm(t(x), deterministic=False, generator=torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(again.detach().numpy(), out.detach().numpy())
    with pytest.raises(ValueError, match="Generator"):
        pm(t(x), deterministic=False)


# Block variants: pre-norm chained twice (the second with a residual),
# post-norm, and the parallel block with separate norms.
BLOCKS = {
    "prenorm": dict(prenorm=True),
    "postnorm": dict(prenorm=False),
    "parallel_untied": dict(prenorm=True, parallel_block=True, parallel_block_tied_norm=False),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_dropout_matches_jax(name, monkeypatch):
    kw = BLOCKS[name]
    x = np.random.RandomState(9).randn(2, 70, 64).astype(np.float32)
    jblock = JBlock(64, mixer=lambda: _mha_pair(0.2)[0],
                    mlp=lambda: JMlp(256, dtype=jnp.float32, name="mlp"), residual_in_fp32=True,
                    resid_dropout1=0.1, resid_dropout2=0.15, eps=1e-5, dtype=jnp.float32, **kw)
    params = jax.tree_util.tree_map(np.asarray,
                                    jblock.init(jax.random.PRNGKey(6), jnp.asarray(x)))
    block = Block(64, _mha_pair(0.2)[1], Mlp(64, 256, dtype=torch.float32, device="cpu"),
                  resid_dropout1=0.1, resid_dropout2=0.15, residual_in_fp32=True, eps=1e-5,
                  dtype=torch.float32, device="cpu", **kw)
    block.load_state_dict(gpt_state_dict_from_jax(params))
    prenorm = kw["prenorm"]

    def jrun(p_, x_, rngs=None, **a):
        if not prenorm:
            return jblock.apply(p_, x_, rngs=rngs, **a)
        h, r = jblock.apply(p_, x_, None, rngs=rngs, **a)
        # The second call draws from another key, as the port's generator
        # draws on.
        rngs = rngs and {"dropout": jax.random.PRNGKey(1)}
        return jblock.apply(p_, h, r, rngs=rngs, **a)

    def prun(x_, **a):
        if not prenorm:
            return block(x_, **a)
        h, r = block(x_, **a)
        return block(h, r, **a)

    with torch.no_grad():
        for a, r in zip(jax.tree_util.tree_leaves(jrun(params, jnp.asarray(x))),
                        jax.tree_util.tree_leaves(prun(t(x)))):
            np.testing.assert_allclose(r.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    draws = Draws(monkeypatch)
    g = torch.Generator().manual_seed(12)
    out = prun(t(x), deterministic=False, generator=g)
    outs = out if prenorm else (out,)
    left = draws.to_jax()
    jout = jrun(params, jnp.asarray(x), deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(0)})
    jouts = jout if prenorm else (jout,)
    assert left() == ([], [])
    assert len(draws.seeds) == (2 if prenorm else 1)
    for a, r in zip(outs, jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-5, rtol=0)


B, S = 2, 100


def _gpt_pair(**kw):
    jcfg = dataclasses.replace(JGPTConfig.tiny(), dtype=jnp.float32, dropout=0.1, **kw)
    pcfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32, dropout=0.1, **kw)
    ids = np.random.RandomState(0).randint(0, 512, size=(B, S)).astype(np.int32)
    jmodel = JGPT(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids)))
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))
    return jmodel, params, pmodel, ids


@pytest.mark.parametrize("variant", ["gpt2", "parallel_untied"])
def test_gpt_dropout_loss_and_grads_match_jax(variant, monkeypatch):
    kw = {} if variant == "gpt2" else dict(parallel_block=True, parallel_block_tied_norm=False)
    jmodel, params, pmodel, ids = _gpt_pair(**kw)
    # deterministic=True (the default): equal to JAX's, and to a model
    # without dropout on the same weights.
    jlogits = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        logits = pmodel(t(ids))
        assert rel_l2(logits.numpy(), jlogits) < 1e-4
        plain = GPTLMHeadModel(dataclasses.replace(pmodel.cfg, dropout=0.0), device="cpu")
        plain.load_state_dict(pmodel.state_dict())
        np.testing.assert_array_equal(plain(t(ids)).numpy(), logits.numpy())
        np.testing.assert_array_equal(gpt_loss_fn(pmodel, t(ids), t(ids)).numpy(),
                                      gpt_loss_fn(plain, t(ids), t(ids)).numpy())
    draws = Draws(monkeypatch)
    g = torch.Generator().manual_seed(21)
    logits = pmodel(t(ids), deterministic=False, generator=g)
    loss = cross_entropy_loss(logits[:, :-1], t(ids)[:, 1:])
    loss.backward()
    left = draws.to_jax()

    def loss_fn(p_):
        lg = jmodel.apply(p_, jnp.asarray(ids), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return jce(lg[:, :-1], jnp.asarray(ids)[:, 1:]), lg

    (jloss, jlg), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert left() == ([], [])
    # One residual mask a layer in the parallel block (norm1's), two else.
    per_layer = 1 if variant == "parallel_untied" else 2
    assert len(draws.seeds) == pmodel.cfg.num_layers
    assert len(draws.masks) == per_layer * pmodel.cfg.num_layers
    assert rel_l2(logits.detach().numpy(), np.asarray(jlg)) < 1e-4
    assert rel_l2(np.asarray(jlg), jlogits) > 1e-3  # dropout did something
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    jgrads = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for n, prm in pmodel.named_parameters():
        assert rel_l2(prm.grad.numpy(), jgrads[n].numpy()) < 1e-4, n


def test_gpt_dropout_remat_replays_the_draws():
    # remat recomputes each block in the backward from the generator state
    # its forward began at: the same loss, gradients and generator state.
    _, _, pmodel, ids = _gpt_pair()
    remat = GPTLMHeadModel(dataclasses.replace(pmodel.cfg, remat=True), device="cpu")
    remat.load_state_dict(pmodel.state_dict())
    gens = []
    for m in (pmodel, remat):
        g = torch.Generator().manual_seed(5)
        loss = cross_entropy_loss(m(t(ids), deterministic=False, generator=g)[:, :-1],
                                  t(ids)[:, 1:])
        loss.backward()
        gens.append(g.get_state())
    assert torch.equal(gens[0], gens[1])
    for (n, a), (_, b) in zip(pmodel.named_parameters(), remat.named_parameters()):
        assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-6), n
    with pytest.raises(ValueError, match="Generator"):
        pmodel(t(ids), deterministic=False)
