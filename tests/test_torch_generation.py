"""Port parity: the serving path (MHA with a decoding cache, GPT decoding,
liteattention_torch.utils.generation) against the JAX package, with
JAX-initialised weights carried across by gpt_state_dict_from_jax.

Tiny configs, fp32: a LLaMA (rotary, RMSNorm, SwiGLU, GQA 4 -> 2 heads)
at head dims 64 and 128, and GPT-2 (learned positions, tied head).
Greedy tokens must be equal. Tolerances, fp32, summation order only:
MHA outputs within 2e-5 absolute; the logits each new token was chosen
from, against JAX's full forward (no cache) over the same tokens, within
1e-4 rel-L2 (the limit test_torch_gpt.py holds the training forward to).
The int8 cache quantizes to the same int8 values in both packages, so
its greedy tokens must be equal too.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.modules.mha import MHA as JMHA  # noqa: E402
from liteattention_tpu.modules.mha import InferenceParams as JInferenceParams  # noqa: E402
from liteattention_tpu.utils import generation as jgen  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_state_dict_from_jax,
)
from liteattention_torch.modules.mha import MHA, InferenceParams  # noqa: E402
from liteattention_torch.utils import generation  # noqa: E402

PROMPT, NEW, MAX_SEQLEN = 7, 5, 32
LLAMA = dict(max_position_embeddings=0, num_layers=2, gated_mlp=True, use_rms_norm=True,
             tie_embeddings=False, attn_bias=False, mlp_bias=False, vocab_size=256)
CONFIGS = {
    "llama_d64": dict(LLAMA, dim=256, num_heads=4, num_heads_kv=2, ffn_dim=512,
                      rotary_emb_dim=64),
    "llama_d128": dict(LLAMA, dim=512, num_heads=4, num_heads_kv=2, ffn_dim=512,
                       rotary_emb_dim=128, rotary_emb_base=500000.0),
    "gpt2": dict(vocab_size=512, max_position_embeddings=256, dim=128, num_layers=2,
                 num_heads=2),
}


def _models(name, seed=0):
    kw = CONFIGS[name]
    jmodel = JGPT(JGPTConfig(dtype=jnp.float32, **kw))
    ids = np.random.RandomState(seed).randint(0, kw["vocab_size"], (2, PROMPT)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    pmodel = GPTLMHeadModel(GPTConfig(dtype=torch.float32, **kw), device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel, ids


def _jax_apply(jmodel):
    return lambda p, ids, inf: jmodel.apply(p, ids, inference_params=inf)


class _LastLogits:
    """The model as greedy_decode calls it, keeping a copy of each call's
    last-position logits (those the next token is chosen from)."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def __call__(self, ids, inference_params):
        out = self.model(ids, inference_params)
        self.rows.append(out[:, -1].clone())
        return out

    def logits(self):
        return torch.stack(self.rows, dim=1)


@pytest.mark.parametrize("quantized", [False, True])
def test_mha_decode_steps_match_jax(quantized):
    # GQA 4 -> 2 with rotary: a 5-token prefill, two single-token steps
    # (the decode kernel's path) and, unquantized, a 3-token step (causal
    # B1 over the cache prefix).
    rng = np.random.RandomState(3)
    dim, steps = 256, [5, 1, 1] + ([] if quantized else [3])
    jmha = JMHA(dim, 4, num_heads_kv=2, causal=True, rotary_emb_dim=64, dtype=jnp.float32)
    xs = [rng.randn(2, s, dim).astype(np.float32) for s in steps]
    params = jax.tree_util.tree_map(np.asarray, jmha.init(jax.random.PRNGKey(4), jnp.asarray(xs[0])))
    mha = MHA(dim, 4, num_heads_kv=2, causal=True, rotary_emb_dim=64, layer_idx=0,
              dtype=torch.float32, device="cpu")
    mha.load_state_dict(gpt_state_dict_from_jax(params))
    jinf = JInferenceParams(max_seqlen=16, max_batch_size=2)
    pinf = InferenceParams(max_seqlen=16, max_batch_size=2)
    with torch.no_grad():
        for i, x in enumerate(xs):
            jo = jmha.apply(params, jnp.asarray(x), inference_params=jinf)
            po = mha(t(x), inference_params=pinf)
            np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
            jinf.seqlen_offset += x.shape[1]
            pinf.seqlen_offset += x.shape[1]
            if i == 0 and quantized:
                jgen.quantize_inference_cache(jinf)
                generation.quantize_inference_cache(pinf)
                for a, b in zip(pinf.key_value_memory_dict[0], jinf.key_value_memory_dict["root"]):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)
    kc = pinf.key_value_memory_dict[0][0]
    assert kc.shape == (2, 2, 16, 64) and kc.dtype == (torch.int8 if quantized else torch.float32)
    if quantized:  # a multi-token step on an int8 cache raises, as in JAX
        with pytest.raises(NotImplementedError, match="single-token"):
            mha(t(rng.randn(2, 2, dim).astype(np.float32)), inference_params=pinf)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_decode_matches_jax(name):
    jmodel, params, pmodel, ids = _models(name)
    jtok = np.asarray(jgen.greedy_decode(_jax_apply(jmodel), params, jnp.asarray(ids), NEW,
                                         MAX_SEQLEN))
    rec = _LastLogits(pmodel)
    ptok = generation.greedy_decode(rec, t(ids).long(), NEW, MAX_SEQLEN)
    plog = rec.logits()
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    # Each new token's logits (prefill, then the cached decode steps)
    # against JAX's full forward without a cache over the same tokens.
    jfull = np.asarray(jmodel.apply(params, jnp.asarray(jtok[:, :-1])))
    assert plog.shape == (2, NEW, CONFIGS[name]["vocab_size"])
    assert rel_l2(plog.numpy(), jfull[:, PROMPT - 1 :]) < 1e-4
    # generate() is greedy_decode up to max_length tokens.
    out = pmodel.generate(t(ids).long(), max_length=PROMPT + NEW)
    np.testing.assert_array_equal(out.numpy(), jtok)


@pytest.mark.parametrize("name", ["llama_d128", "gpt2"])
def test_greedy_decode_int8_cache_matches_jax(name):
    jmodel, params, pmodel, ids = _models(name, seed=1)
    jtok = jgen.greedy_decode(_jax_apply(jmodel), params, jnp.asarray(ids), NEW, MAX_SEQLEN,
                              quantize_cache=True)
    rec = _LastLogits(pmodel)
    ptok = generation.greedy_decode(rec, t(ids).long(), NEW, MAX_SEQLEN, quantize_cache=True)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    assert torch.isfinite(rec.logits()).all()


@pytest.mark.parametrize("lookahead", [1, 3])
def test_decode_speculative_equals_greedy(lookahead):
    # Greedy speculative decoding reproduces greedy decoding of the main
    # model token for token, whatever the draft: here one of other weights
    # and one layer, and the main model itself (every round accepted).
    _, _, main, ids = _models("llama_d64")
    draft = GPTLMHeadModel(dataclasses.replace(main.cfg, num_layers=1), device="cpu")
    draft.reset_parameters(torch.Generator().manual_seed(5))
    prompt = t(ids[:1]).long()
    ref = generation.greedy_decode(main, prompt, 9, MAX_SEQLEN)
    spec, stats = generation.decode_speculative(main, draft, prompt, 9, MAX_SEQLEN,
                                                speculative_lookahead=lookahead,
                                                return_stats=True)
    assert torch.equal(spec, ref)
    assert sum(stats["accepted_per_round"]) == 9 - 1
    spec, stats = generation.decode_speculative(main, main, prompt, 9, MAX_SEQLEN,
                                                speculative_lookahead=lookahead,
                                                return_stats=True)
    assert torch.equal(spec, ref)
    assert stats["accepted_per_round"][0] == lookahead + 1


def test_sampling_matches_jax():
    rng = np.random.RandomState(6)
    b, s, v = 2, 4, 16
    logits = rng.randn(b, s + 1, v).astype(np.float32)
    draft = np.argmax(logits, -1)[:, :s].astype(np.int32)
    draft[0, 2] = (draft[0, 2] + 1) % v  # rejected at position 2 in row 0
    ldraft = rng.randn(b, s, v).astype(np.float32)
    jt, jn = jgen.sample_speculative(jnp.asarray(logits), jnp.asarray(ldraft), jnp.asarray(draft))
    pt, pn = generation.sample_speculative(t(logits), t(ldraft), t(draft).long())
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert pn.tolist() == [3, s + 1]
    for top_k, top_p in ((0, 0.0), (5, 0.0), (0, 0.7), (4, 0.5)):
        np.testing.assert_array_equal(
            generation._filter_logits(t(logits), top_k, top_p).numpy(),
            np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p)),
        )
    # Sampled mode: within the filtered support, reproducible from a seed.
    lf = t(logits[:, 0])
    allowed = torch.isfinite(generation._filter_logits(lf / 0.7, 4, 0.9))
    draws = [generation.sample_token(lf, torch.Generator().manual_seed(i), 0.7, 4, 0.9)
             for i in range(32)]
    assert all(allowed.gather(1, d[:, None]).all() for d in draws)
    again = generation.sample_token(lf, torch.Generator().manual_seed(3), 0.7, 4, 0.9)
    assert torch.equal(again, draws[3])
    toks, n = generation.sample_speculative(
        t(logits), t(logits[:, :s]), t(draft).long(), torch.Generator().manual_seed(1), 0.8, 8
    )
    assert n.tolist() == [s + 1, s + 1]  # p == q: everything is accepted
