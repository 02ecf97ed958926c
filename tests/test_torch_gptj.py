"""Port parity: GPT-J (``gptj_config``, ``remap_state_dict_hf_gptj`` and the
model at GPT-J's head dim 256) against the JAX package, with JAX-initialised
weights carried across by gpt_state_dict_from_jax, and against a randomly
initialised ``transformers.GPTJForCausalLM`` (nothing is fetched).

A tiny fp32 GPT-J: dim 512, 2 layers, 2 heads of 256 (the published head
dim), interleaved rotary over 64 of them, vocab 512. Tolerances, fp32,
summation order only: greedy tokens equal and the logits each new token
was chosen from within 1e-4 rel-L2 of JAX's full forward without a cache
(tests/test_torch_generation.py's limit); on the int8 cache the tokens
equal (both packages quantize to the same int8 values); the remap key for
key within 1e-7 relative of JAX's; logits against transformers within
2e-3 absolute + 1e-3 relative (tests/test_pretrained.py's limit for the
same oracle). At head dim 256 B1's ALiBi and segment channels, and B7
with any channel, are not built: the wrappers' check raises naming ROADMAP
B-iii 4 (the card tests run the kernels).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import LastLogits, rel_l2, same_config, t  # noqa: E402
from liteattention_tpu.models import configs as jconfigs  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.utils import generation as jgen  # noqa: E402
from liteattention_tpu.utils import pretrained as jpretrained  # noqa: E402
from liteattention_torch.flash_attn_interface import flash_attn_varlen_func  # noqa: E402
from liteattention_torch.models import configs  # noqa: E402
from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_state_dict_from_jax  # noqa: E402
from liteattention_torch.ops.flash_bwd import (  # noqa: E402
    ALIBI_HEAD_DIMS,
    HEAD_DIMS,
    check_head_dim,
)
from liteattention_torch.utils import generation, remap_state_dict_hf_gptj  # noqa: E402

PROMPT, NEW, MAX_SEQLEN = 9, 5, 40
TINY = dict(dim=512, num_layers=2, num_heads=2, vocab=512, rotary_dim=64)


@pytest.mark.parametrize("kw", [{}, TINY])
def test_gptj_config_equals_jax(kw):
    same_config(configs.gptj_config(**kw), jconfigs.gptj_config(**kw))


def test_gptj_config_is_gpt_j_6b():
    # EleutherAI/gpt-j-6b config.json: n_embd 4096, n_layer 28, n_head 16,
    # rotary_dim 64 (interleaved), vocab_size 50400, n_inner null (4 x
    # n_embd), untied embeddings, a biased lm_head.
    cfg = configs.gptj_config()
    assert (cfg.dim, cfg.num_layers, cfg.num_heads, cfg.vocab_size) == (4096, 28, 16, 50400)
    assert cfg.dim // cfg.num_heads == 256 and cfg.ffn_dim is None
    assert cfg.rotary_emb_dim == 64 and cfg.rotary_emb_interleaved
    assert cfg.parallel_block and cfg.parallel_block_tied_norm and not cfg.tie_embeddings
    assert cfg.lm_head_bias and cfg.mlp_bias and not cfg.attn_bias and not cfg.mlp_gelu_exact


def _models(seed=0):
    jcfg = dataclasses.replace(jconfigs.gptj_config(**TINY), dtype=jnp.float32)
    pcfg = dataclasses.replace(configs.gptj_config(**TINY), dtype=torch.float32)
    jmodel = JGPT(jcfg)
    ids = np.random.RandomState(seed).randint(0, 512, (2, PROMPT)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel, ids


@pytest.mark.parametrize("quantize", [False, True])
def test_gptj_greedy_decode_matches_jax(quantize):
    # Prefill through B1 with the cache's bound, then single-token steps
    # through the decode kernel's plain version (bf16 or int8 cache).
    jmodel, params, pmodel, ids = _models(seed=int(quantize))
    apply = lambda p, x, inf: jmodel.apply(p, x, inference_params=inf)  # noqa: E731
    jtok = np.asarray(jgen.greedy_decode(apply, params, jnp.asarray(ids), NEW, MAX_SEQLEN,
                                         quantize_cache=quantize))
    rec = LastLogits(pmodel)
    ptok = generation.greedy_decode(rec, t(ids).long(), NEW, MAX_SEQLEN, quantize_cache=quantize)
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    plog = rec.logits()
    assert plog.shape == (2, NEW, 512) and torch.isfinite(plog).all()
    if not quantize:
        jfull = np.asarray(jmodel.apply(params, jnp.asarray(jtok[:, :-1])))
        assert rel_l2(plog.numpy(), jfull[:, PROMPT - 1 :]) < 1e-4


def test_gptj_remap_matches_jax_and_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPTJConfig(
        vocab_size=TINY["vocab"], n_positions=64, n_embd=TINY["dim"], n_layer=TINY["num_layers"],
        n_head=TINY["num_heads"], rotary_dim=TINY["rotary_dim"], activation_function="gelu_new",
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    hf_model = transformers.GPTJForCausalLM(hf_cfg).eval()
    sd = hf_model.state_dict()
    cfg = dataclasses.replace(configs.gptj_config(**TINY), eps=hf_cfg.layer_norm_epsilon,
                              dtype=torch.float32)
    got = remap_state_dict_hf_gptj(sd, cfg)
    jcfg = dataclasses.replace(jconfigs.gptj_config(**TINY), eps=hf_cfg.layer_norm_epsilon,
                               dtype=jnp.float32)
    ref = gpt_state_dict_from_jax(jpretrained.remap_state_dict_hf_gptj(sd, jcfg))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-7, atol=0)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(got)  # strict
    ids = np.random.RandomState(4).randint(0, TINY["vocab"], (2, 24))
    with torch.no_grad():
        hf_logits = hf_model(torch.tensor(ids)).logits.numpy()
        logits = model(t(ids).long()).numpy()
    np.testing.assert_allclose(logits, hf_logits, atol=2e-3, rtol=1e-3)


def test_head_dim_256_channels_raise():
    # Built at 256: B1 and B7 without channels, with the key range, segments
    # (the varlen functions), the window and the cap, forwards and
    # backwards. Not built: ALiBi (ROADMAP B-iii 4).
    assert 256 in HEAD_DIMS and 256 not in ALIBI_HEAD_DIMS
    check_head_dim(256, False, "flash_attention")
    for name in ("flash_attention", "flash_bwd"):
        with pytest.raises(ValueError, match="alibi_slopes at head dim 256.*ROADMAP B-iii 4"):
            check_head_dim(256, True, name)
    with pytest.raises(ValueError, match="head dim 112 not built.*ROADMAP B-iii 4"):
        check_head_dim(112, False, "flash_attention")
    cu = torch.tensor([0, 40, 64], dtype=torch.int32)
    x = torch.randn(64, 2, 256, generator=torch.Generator().manual_seed(0))
    out = flash_attn_varlen_func(x, x, x, cu, cu, 40, 40)
    assert out.shape == x.shape and torch.isfinite(out).all()
