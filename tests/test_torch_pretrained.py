"""Port parity: the six HF remaps of utils/pretrained.py (GPT-2, LLaMA,
GPT-NeoX, Falcon, OPT with both layouts, GPTBigCode) and
``state_dict_from_pretrained``, on randomly initialised ``transformers``
models built here (nothing is fetched).

Each remap gives the tensors of JAX's remap of the same state dict (carried
to the port's keys by ``gpt_state_dict_from_jax``), key for key, bit for bit;
the port's model on them gives the HF model's logits within 2e-3 absolute +
1e-3 relative (fp32; tests/test_pretrained.py's limit for the same oracle).
``state_dict_from_pretrained`` reads a model saved to a temporary directory
(``local_files_only``, and the hub is set offline).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
import torch  # noqa: E402

from liteattention_tpu.models import configs as jconfigs  # noqa: E402
from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from liteattention_tpu.utils import pretrained as jpretrained  # noqa: E402
from liteattention_torch.models import configs  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_state_dict_from_jax,
)
from liteattention_torch.utils import pretrained  # noqa: E402


def _gpt2():
    hf_cfg = transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=64, n_layer=2,
                                     n_head=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    kw = dict(vocab_size=128, max_position_embeddings=64, dim=64, num_layers=2, num_heads=2,
              eps=hf_cfg.layer_norm_epsilon)
    return (transformers.GPT2LMHeadModel(hf_cfg), GPTConfig(**kw), JGPTConfig(**kw),
            "gpt2", lambda m: m.transformer.state_dict())


def _llama():
    hf_cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=160,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=2, max_position_embeddings=64,
                                      rms_norm_eps=1e-6, tie_word_embeddings=False)
    kw = dict(dim=64, num_layers=2, num_heads=4, num_heads_kv=2, vocab=128, ffn_dim=160)
    return (transformers.LlamaForCausalLM(hf_cfg),
            dataclasses.replace(configs.llama_config(**kw), eps=1e-6),
            dataclasses.replace(jconfigs.llama_config(**kw), eps=1e-6), "llama", None)


def _neox():
    hf_cfg = transformers.GPTNeoXConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                        num_attention_heads=2, intermediate_size=256,
                                        rotary_pct=0.25, hidden_act="gelu",
                                        max_position_embeddings=64, use_parallel_residual=True,
                                        hidden_dropout=0.0, attention_dropout=0.0)
    kw = dict(dim=64, num_layers=2, num_heads=2, vocab=128)
    return (transformers.GPTNeoXForCausalLM(hf_cfg),
            dataclasses.replace(configs.gpt_neox_config(**kw), eps=hf_cfg.layer_norm_eps),
            dataclasses.replace(jconfigs.gpt_neox_config(**kw), eps=hf_cfg.layer_norm_eps),
            "gpt_neox", None)


def _falcon():
    hf_cfg = transformers.FalconConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                       num_attention_heads=4, num_kv_heads=1, multi_query=True,
                                       parallel_attn=True, new_decoder_architecture=False,
                                       bias=False, alibi=False, hidden_dropout=0.0,
                                       attention_dropout=0.0)
    kw = dict(dim=64, num_layers=2, num_heads=4, vocab=128)
    return (transformers.FalconForCausalLM(hf_cfg),
            dataclasses.replace(configs.falcon_config(**kw), eps=hf_cfg.layer_norm_epsilon),
            dataclasses.replace(jconfigs.falcon_config(**kw), eps=hf_cfg.layer_norm_epsilon),
            "falcon", None)


def _opt(proj=None):
    hf_cfg = transformers.OPTConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                    num_attention_heads=2, ffn_dim=256, max_position_embeddings=64,
                                    activation_function="relu",
                                    do_layer_norm_before=proj is None,
                                    word_embed_proj_dim=proj or 64, dropout=0.0,
                                    attention_dropout=0.0)
    kw = dict(dim=64, num_layers=2, num_heads=2, vocab=128, max_pos=64)
    if proj:
        kw.update(word_embed_proj_dim=proj, prenorm=False)
    return (transformers.OPTForCausalLM(hf_cfg),
            dataclasses.replace(configs.opt_config(**kw), ffn_dim=256),
            dataclasses.replace(jconfigs.opt_config(**kw), ffn_dim=256), "opt", None)


def _bigcode():
    hf_cfg = transformers.GPTBigCodeConfig(vocab_size=128, n_positions=64, n_embd=64, n_layer=2,
                                           n_head=4, multi_query=True,
                                           activation_function="gelu_pytorch_tanh",
                                           resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    kw = dict(dim=64, num_layers=2, num_heads=4, vocab=128, max_pos=64)
    return (transformers.GPTBigCodeForCausalLM(hf_cfg),
            dataclasses.replace(configs.bigcode_config(**kw), eps=hf_cfg.layer_norm_epsilon),
            dataclasses.replace(jconfigs.bigcode_config(**kw), eps=hf_cfg.layer_norm_epsilon),
            "bigcode", None)


FAMILIES = {"gpt2": _gpt2, "llama": _llama, "gpt_neox": _neox, "falcon": _falcon, "opt": _opt,
            "opt_350m_layout": lambda: _opt(proj=32), "bigcode": _bigcode}


def _build(name, seed=0):
    torch.manual_seed(seed)
    hf, pcfg, jcfg, family, take = FAMILIES[name]()
    hf = hf.eval()
    sd = (take or (lambda m: m.state_dict()))(hf)
    pcfg = dataclasses.replace(pcfg, dtype=torch.float32)
    import jax.numpy as jnp

    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    return hf, sd, pcfg, jcfg, family


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remap_equals_jax_remap(name):
    _, sd, pcfg, jcfg, family = _build(name)
    got = getattr(pretrained, f"remap_state_dict_hf_{family}")(sd, pcfg)
    want = gpt_state_dict_from_jax(getattr(jpretrained, f"remap_state_dict_hf_{family}")(sd, jcfg))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remapped_model_matches_hf_logits(name):
    hf, sd, pcfg, _, family = _build(name)
    model = GPTLMHeadModel(pcfg, device="cpu")
    model.load_state_dict(getattr(pretrained, f"remap_state_dict_hf_{family}")(sd, pcfg))
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 128, (2, 24)))
    with torch.no_grad():
        want = hf(ids).logits.numpy()
        got = model(ids).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_opt_remap_raises_on_a_config_that_does_not_fit():
    _, sd, pcfg, _, _ = _build("opt_350m_layout")
    with pytest.raises(ValueError, match="word_embed_proj_dim"):
        pretrained.remap_state_dict_hf_opt(sd, dataclasses.replace(pcfg, word_embed_proj_dim=None))
    sd = {k: v for k, v in sd.items() if "project" not in k}
    with pytest.raises(ValueError, match="prenorm"):
        pretrained.remap_state_dict_hf_opt(sd, dataclasses.replace(
            pcfg, word_embed_proj_dim=None, prenorm=True))


def test_state_dict_from_pretrained_reads_a_local_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    hf, _, pcfg, _, _ = _build("llama", seed=5)
    hf.save_pretrained(tmp_path)
    sd = pretrained.state_dict_from_pretrained(str(tmp_path))
    want = hf.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k]) and sd[k].device.type == "cpu" for k in want)
    model = GPTLMHeadModel(pcfg, device="cpu")
    model.load_state_dict(pretrained.remap_state_dict_hf_llama(sd, pcfg))
    ids = torch.arange(10)[None]
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(), hf(ids).logits.numpy(), atol=2e-3,
                                   rtol=1e-3)
