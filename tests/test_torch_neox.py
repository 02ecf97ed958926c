"""Port parity: the GPT-NeoX family's head dims 80 (Pythia) and 96
(GPT-NeoX-20B) through the decode kernel's plain versions (B8, B9a, B9b),
``flash_attn_with_kvcache``, B1's key range, ALiBi and segments and B7's
gradients with them, a 2-layer GPT-NeoX served by ``greedy_decode``, and
``remap_state_dict_hf_gpt_neox`` at head dim 80, against the JAX package
(Pallas kernels in interpret mode) and a randomly initialised
``transformers.GPTNeoXForCausalLM`` (nothing is fetched).

JAX's own decode kernel and int8_mma assert ``d % 128 == 0``; at these head
dims JAX's MHA runs a single-token step on ``flash_attention_masked`` with
the GQA group packed as q rows and the cache's bound
(``liteattention_tpu/modules/mha.py``), and that route is the reference for
the decode plain version here.

fp32 numpy inputs from seeds. Tolerances: 2e-5 absolute on outputs, lse and
gradients (O(1) values; summation order only), 1e-4 where ALiBi's bias
over a cache enters JAX's scores (its rounding of slope x distance); int8
caches compare the same int8 values and scales, so 2e-5 holds there too;
greedy tokens equal and the logits each token was chosen from within 1e-4
rel-L2 of JAX's at the same step (tests/test_torch_generation.py's limit),
on the bf16 and the int8 cache; the remap key for key
bit for bit against JAX's and logits within 2e-3 absolute + 1e-3 relative
of transformers (tests/test_pretrained.py's limit for the same oracle).
JAX interpret runs stay at 512 keys or fewer.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import LastLogits, rel_l2, same_config, t  # noqa: E402
from liteattention_tpu.flash_attn_interface import flash_attn_with_kvcache as jkv  # noqa: E402
from liteattention_tpu.models import configs as jconfigs  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.modules.mha import alibi_slopes as jalibi_slopes  # noqa: E402
from liteattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd  # noqa: E402
from liteattention_tpu.ops.flash_fwd import flash_attention_masked as jmasked  # noqa: E402
from liteattention_tpu.ops.kv_quant import quantize_kv_cache as jquant  # noqa: E402
from liteattention_tpu.ops.paged_attention import paged_attention as jpaged  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_tpu.utils import generation as jgen  # noqa: E402
from liteattention_tpu.utils import pretrained as jpretrained  # noqa: E402
from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache  # noqa: E402
from liteattention_torch.models import configs  # noqa: E402
from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_state_dict_from_jax  # noqa: E402
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    ALIBI_HEAD_DIMS,
    flash_attention_bwd,
    flash_bwd,
)
from liteattention_torch.ops.flash_bwd import HEAD_DIMS as ATTN_HEAD_DIMS  # noqa: E402
from liteattention_torch.ops.flash_decode import HEAD_DIMS, INT8_MMA_HEAD_DIMS  # noqa: E402
from liteattention_torch.ops.flash_fwd import (  # noqa: E402
    flash_attention,
    flash_attention_decode,
    flash_attention_masked,
)
from liteattention_torch.ops.kv_quant import quantize_kv_cache  # noqa: E402
from liteattention_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_folded,
)
from liteattention_torch.utils import generation  # noqa: E402
from liteattention_torch.utils.pretrained import remap_state_dict_hf_gpt_neox  # noqa: E402

TOL = 2e-5
ALIBI_TOL = 1e-4
DECODE_BS = JBS(128, 2048)  # JAX's MHA decode block sizes
PROMPT, NEW, MAX_SEQLEN = 9, 5, 40
# 2-layer GPT-NeoX models at head dims 80 and 96 (rotary 20 and 24).
TINY = {80: dict(dim=160, num_layers=2, num_heads=2, vocab=256),
        96: dict(dim=192, num_layers=2, num_heads=2, vocab=256)}


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref)
    port = port.detach().numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin)
    np.testing.assert_allclose(port[fin], ref[fin], atol=tol, rtol=0)


# ------------------------------------------------------------------ configs

def test_gpt_neox_family_configs():
    # EleutherAI/pythia-2.8b config.json: hidden 2560, 32 layers, 32 heads
    # (head dim 80), rotary_pct 0.25 (20), vocab 50 304, parallel residual,
    # untied embed_out; EleutherAI/gpt-neox-20b: 6144, 44, 64 (96), 50 432.
    pythia = dict(dim=2560, num_layers=32, num_heads=32, vocab=50304)
    for kw, want in ((pythia, (2560, 32, 32, 50304, 80, 20)),
                     ({}, (6144, 44, 64, 50432, 96, 24))):
        cfg = configs.gpt_neox_config(**kw)
        same_config(cfg, jconfigs.gpt_neox_config(**kw))
        assert (cfg.dim, cfg.num_layers, cfg.num_heads, cfg.vocab_size,
                cfg.dim // cfg.num_heads, cfg.rotary_emb_dim) == want
        assert cfg.parallel_block and not cfg.parallel_block_tied_norm
        assert not cfg.tie_embeddings and cfg.mlp_gelu_exact
    # The kernels' head dims: the decode kernel at both, int8_mma at
    # neither (JAX's asserts d % 128 == 0), B1's and B7's channels at 96.
    for d in (80, 96):
        assert d in HEAD_DIMS and d not in INT8_MMA_HEAD_DIMS
        assert d in ALIBI_HEAD_DIMS and d in ATTN_HEAD_DIMS


# ------------------------------------------------------- decode (B8 / B9)

@pytest.mark.parametrize("d,group,int8", [(80, 1, False), (96, 4, False), (80, 2, True),
                                          (96, 1, True)])
def test_decode_matches_jax_packed_rows(d, group, int8):
    # JAX's single-token step at these head dims: the group packed as q
    # rows, flash_attention_masked with the cache's bound (int8: q times
    # k_scale before, out times v_scale after).
    rng = np.random.RandomState(d + group + int8)
    b, hk, s = 3, 2, 384
    h = hk * group
    q = _rand(rng, b, h, 1, d)
    kc, vc = _rand(rng, b, s, hk, d), _rand(rng, b, s, hk, d)  # [B, S, Hk, D]
    bound = np.array([384, 171, 5], np.int32)
    jk, jv, pk, pv, pkw = jnp.asarray(kc), jnp.asarray(vc), t(kc), t(vc), {}
    qj = q.reshape(b, hk, group, d)
    if int8:
        jc, pc = jquant(jk, jv), quantize_kv_cache(pk, pv)
        np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
        jk, jv, pk, pv = jc.k, jc.v, pc.k, pc.v
        qj = qj * np.asarray(jc.k_scale)[:, :, None, :]
        pkw = dict(k_scale=pc.k_scale, v_scale=pc.v_scale)
    # MHA's cache is [B, Hk, S, D].
    jo = jmasked(jnp.asarray(qj), jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3),
                 kv_bound=jnp.asarray(bound), bound_causal=False, block_sizes=DECODE_BS)
    jo = np.asarray(jo)
    if int8:
        jo = jo * np.asarray(jc.v_scale)[:, :, None, :]
    po, _ = flash_attention_decode(t(q), pk, pv, kv_bound=t(bound), **pkw)
    assert po.shape == (b, h, 1, d)
    _close(po.reshape(b, hk, group, d), jo)
    # The plain version of the kernel's split merge gives the same result.
    so, _ = flash_attention_decode(t(q), pk, pv, kv_bound=t(bound), num_splits=3, **pkw)
    _close(so.reshape(b, hk, group, d), jo)
    assert flash_attention_decode.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("d,psz,group,sq", [(80, 16, 1, 1), (96, 64, 4, 1), (96, 16, 2, 3)])
def test_paged_matches_jax(d, psz, group, sq):
    # B9a's plain version against JAX's _paged_kernel (head-major pools, d
    # padded to 128 lanes there), and B9b's on the same pages natively laid.
    rng = np.random.RandomState(d + psz + sq)
    b, hk, pps, n_pages = 3, 2, 4, 14
    kp, vp = _rand(rng, n_pages, psz, hk, d), _rand(rng, n_pages, psz, hk, d)
    table = rng.permutation(n_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    q = _rand(rng, b, sq, hk * group, d)
    lengths = np.array([pps * psz, psz + 3, sq], np.int32)
    kh, vh = (np.ascontiguousarray(x.transpose(2, 0, 1, 3)) for x in (kp, vp))
    jo, jl = jpaged(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(lengths),
                    jnp.asarray(table), return_lse=True, interpret=True)
    po, pl = paged_attention(t(q), t(kh), t(vh), t(lengths), t(table), return_lse=True)
    _close(po, jo)
    _close(pl, jl)
    fo, fl = paged_attention_folded(t(q), t(kp), t(vp), t(lengths), t(table), return_lse=True)
    _close(fo, jo)
    _close(fl, jl)
    assert paged_attention.launches == paged_attention_folded.launches == 0


# ------------------------------------------------------- the kvcache API

@pytest.mark.parametrize("route", ["contiguous", "batch_idx", "paged"])
def test_kvcache_matches_jax_at_d96(route):
    # GPT-NeoX-20B's attention width cut to 8 q heads on 8 KV heads of 96:
    # a single-token step appending its k / v, over a contiguous cache, a
    # slot picked by cache_batch_idx, or a native page pool.
    rng = np.random.RandomState({"contiguous": 1, "batch_idx": 2, "paged": 3}[route])
    b, h, hk, d, s_max = 2, 8, 8, 96, 192
    q, kn, vn = _rand(rng, b, 1, h, d), _rand(rng, b, 1, hk, d), _rand(rng, b, 1, hk, d)
    lens = np.array([100, 37], np.int32)
    kw = dict(cache_seqlens=lens, causal=True, return_softmax_lse=True)
    if route == "paged":
        psz, pps = 16, s_max // 16
        kc, vc = _rand(rng, b * pps + 2, psz, hk, d), _rand(rng, b * pps + 2, psz, hk, d)
        kw["page_table"] = rng.permutation(b * pps + 2)[: b * pps].reshape(b, pps).astype(
            np.int32)
    elif route == "batch_idx":
        kc, vc = _rand(rng, 4, s_max, hk, d), _rand(rng, 4, s_max, hk, d)
        kw["cache_batch_idx"] = np.array([3, 1], np.int32)
    else:
        kc, vc = _rand(rng, b, s_max, hk, d), _rand(rng, b, s_max, hk, d)
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    pkw = {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    jo, jl, (jk, jv) = jkv(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                           jnp.asarray(vn), **jkw)
    pk, pv = t(kc), t(vc)
    po, pl, _ = flash_attn_with_kvcache(t(q), pk, pv, t(kn), t(vn), **pkw)
    _close(po, jo)
    _close(pl, jl)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


# ------------------------------------------------- B1 / B7 channels at 96

def _doc_ids(lengths):
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)[None]


# (b, h, hk, sq, sk), causal, channels: GPT-NeoX-20B's prefill over its
# cache (bound_causal, with a left pad), ALiBi over the same, causal ALiBi
# [B, H], packed causal documents (one of 1 token) at batch 1.
CHANNEL_CASES = {
    "key_range": ((2, 4, 2, 130, 300), False, dict(kv_bound=[300, 160], kv_low=[0, 20],
                                                   bound_causal=True)),
    "alibi_cache": ((2, 4, 4, 40, 300), False, dict(kv_bound=[260, 150], bound_causal=True,
                                                    alibi_slopes="h")),
    "alibi_causal": ((2, 4, 2, 257, 257), True, dict(alibi_slopes="bh")),
    "segments": ((1, 4, 2, 300, 300), True, dict(q_segments=[130, 1, 100, 69],
                                                 kv_segments=[130, 1, 100, 69])),
}


def _channel_case(name):
    (b, h, hk, sq, sk), causal, spec = CHANNEL_CASES[name]
    rng = np.random.RandomState(len(name))
    q, k, v = _rand(rng, b, h, sq, 96), _rand(rng, b, hk, sk, 96), _rand(rng, b, hk, sk, 96)
    do = _rand(rng, b, h, sq, 96)
    kw = {}
    for n, x in spec.items():
        if n == "alibi_slopes":
            slopes = np.asarray(jalibi_slopes(h))
            kw[n] = slopes if x == "h" else (
                slopes[None] * (1.0 + 0.5 * np.arange(b))[:, None]).astype(np.float32)
        elif n.endswith("segments"):
            kw[n] = _doc_ids(x)
        elif isinstance(x, list):
            kw[n] = np.asarray(x, np.int32)
        else:
            kw[n] = x
    return q, k, v, do, causal, kw


@pytest.mark.parametrize("name", list(CHANNEL_CASES))
def test_channels_at_d96_match_jax(name):
    # B1's forward and B7's gradient (the port's flash_attention_bwd and
    # autograd through flash_attention_masked) against JAX's
    # flash_attention_masked, its flash_attention_bwd and jax.vjp.
    q, k, v, do, causal, kw = _channel_case(name)
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    pkw = {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    bs = JBS(128, 128)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jo, jl = jmasked(jq, jk, jv, causal=causal, return_lse=True, block_sizes=bs, **jkw)
    tol = ALIBI_TOL if "alibi_slopes" in kw and kw.get("bound_causal") else TOL
    po, pl = flash_attention_masked(t(q), t(k), t(v), causal=causal, return_lse=True, **pkw)
    _close(po, jo, tol)
    _close(pl, jl, tol)
    ref = jbwd(jq, jk, jv, jo, jl, jnp.asarray(do), 96**-0.5, causal, block_sizes=bs,
               interpret=True, **jkw)
    got = flash_attention_bwd(t(q), t(k), t(v), t(jo), t(jl), t(do), 96**-0.5, causal, **pkw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol, rtol=0)
    _, vjp = jax.vjp(lambda a, b_, c: jmasked(a, b_, c, causal=causal, block_sizes=bs, **jkw),
                     jq, jk, jv)
    want = vjp(jnp.asarray(do))
    xs = [t(x).requires_grad_() for x in (q, k, v)]
    flash_attention_masked(*xs, causal=causal, **pkw).backward(t(do))
    for x, r in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=tol, rtol=0)
    assert flash_attention.bound_launches == flash_bwd.bound_launches == 0


# ------------------------------------------------- a 2-layer GPT-NeoX

def _models(d, seed=0):
    jcfg = dataclasses.replace(jconfigs.gpt_neox_config(**TINY[d]), dtype=jnp.float32)
    pcfg = dataclasses.replace(configs.gpt_neox_config(**TINY[d]), dtype=torch.float32)
    assert pcfg.dim // pcfg.num_heads == d and pcfg.rotary_emb_dim == d // 4
    jmodel = JGPT(jcfg)
    ids = np.random.RandomState(seed).randint(0, TINY[d]["vocab"], (2, PROMPT)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel, ids


class _JaxLastLogits:
    """JAX's model as greedy_decode applies it, keeping each call's
    last-position logits."""

    def __init__(self, jmodel):
        self.jmodel, self.rows = jmodel, []

    def __call__(self, p, x, inf):
        out = self.jmodel.apply(p, x, inference_params=inf)
        self.rows.append(np.asarray(out[:, -1]))
        return out


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("quantize", [False, True])
def test_neox_greedy_decode_matches_jax(d, quantize):
    # Prefill through B1's key range, then single-token steps through the
    # decode kernel's plain version (bf16 or int8 cache), at rotary 20 / 24.
    jmodel, params, pmodel, ids = _models(d, seed=d + quantize)
    japply = _JaxLastLogits(jmodel)
    jtok = np.asarray(jgen.greedy_decode(japply, params, jnp.asarray(ids), NEW, MAX_SEQLEN,
                                         quantize_cache=quantize))
    rec = LastLogits(pmodel)
    ptok = generation.greedy_decode(rec, t(ids).long(), NEW, MAX_SEQLEN, quantize_cache=quantize)
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    plog = rec.logits()
    assert plog.shape == (2, NEW, TINY[d]["vocab"]) and torch.isfinite(plog).all()
    assert rel_l2(plog.numpy(), np.stack(japply.rows[:NEW], axis=1)) < 1e-4


def test_neox_remap_at_head_dim_80_matches_jax_and_hf():
    transformers = pytest.importorskip("transformers")
    kw = TINY[80]
    hf_cfg = transformers.GPTNeoXConfig(
        vocab_size=kw["vocab"], hidden_size=kw["dim"], num_hidden_layers=kw["num_layers"],
        num_attention_heads=kw["num_heads"], intermediate_size=4 * kw["dim"], rotary_pct=0.25,
        hidden_act="gelu", max_position_embeddings=64, use_parallel_residual=True,
        hidden_dropout=0.0, attention_dropout=0.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.GPTNeoXForCausalLM(hf_cfg).eval()
    sd = hf_model.state_dict()
    cfg = dataclasses.replace(configs.gpt_neox_config(**kw), eps=hf_cfg.layer_norm_eps,
                              dtype=torch.float32)
    assert cfg.rotary_emb_dim == 20
    got = remap_state_dict_hf_gpt_neox(sd, cfg)
    jcfg = dataclasses.replace(jconfigs.gpt_neox_config(**kw), eps=hf_cfg.layer_norm_eps,
                               dtype=jnp.float32)
    ref = gpt_state_dict_from_jax(jpretrained.remap_state_dict_hf_gpt_neox(sd, jcfg))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(got)  # strict
    ids = np.random.RandomState(4).randint(0, kw["vocab"], (2, 24))
    with torch.no_grad():
        hf_logits = hf_model(torch.tensor(ids)).logits.numpy()
        logits = model(t(ids).long()).numpy()
    np.testing.assert_allclose(logits, hf_logits, atol=2e-3, rtol=1e-3)
