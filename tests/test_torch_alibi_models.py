"""Port parity: the ALiBi model path (MHA(use_alibi), GPT with ALiBi,
baichuan_config / btlm_config, the Baichuan and BTLM checkpoint remaps)
against the JAX package, with JAX-initialised weights carried across by
gpt_state_dict_from_jax, and against the numpy forwards of the HF
architectures in tests/_hf_minimal.py.

Tolerances, fp32: MHA outputs within 2e-5 absolute (summation order only,
as tests/test_torch_generation.py); model logits within 1e-4 rel-L2 (as
tests/test_torch_gpt.py); greedy tokens equal; logits against the HF numpy
forwards within 2e-3 absolute + 1e-3 relative (tests/test_pretrained.py's
limit for the same oracles). Training (B7's ALiBi channel): gradients
within 1e-4 rel-L2 of jax.grad per parameter; the Trainer's steps as
tests/test_torch_trainer.py holds them.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _hf_minimal import baichuan_forward, btlm_forward  # noqa: E402
from _torch_port import rel_l2, same_config, t  # noqa: E402
from liteattention_tpu.losses.cross_entropy import cross_entropy_loss as jce  # noqa: E402
from liteattention_tpu.models import configs as jconfigs  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.modules.mha import MHA as JMHA  # noqa: E402
from liteattention_tpu.modules.mha import InferenceParams as JInferenceParams  # noqa: E402
from liteattention_tpu.training import data as jdata  # noqa: E402
from liteattention_tpu.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from liteattention_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from liteattention_tpu.utils import generation as jgen  # noqa: E402
from liteattention_tpu.utils import pretrained as jpretrained  # noqa: E402
from liteattention_torch.models import configs  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTLMHeadModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.modules.mha import MHA, InferenceParams  # noqa: E402
from liteattention_torch.training import data as pdata  # noqa: E402
from liteattention_torch.training.trainer import TrainConfig, Trainer  # noqa: E402
from liteattention_torch.utils import generation, pretrained  # noqa: E402

PROMPT, NEW, MAX_SEQLEN = 9, 5, 40
GRAD_TOL = 1e-4  # rel-L2 of each parameter's fp32 gradient against jax.grad


def _mha_pair(use_alibi, seed=4, dim=256, heads=4, kv_heads=2, **kw):
    jmha = JMHA(dim, heads, num_heads_kv=kv_heads, causal=True, use_alibi=use_alibi,
                dtype=jnp.float32, **kw)
    x0 = np.random.RandomState(seed).randn(2, 5, dim).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jmha.init(jax.random.PRNGKey(seed), jnp.asarray(x0)))
    mha = MHA(dim, heads, num_heads_kv=kv_heads, causal=True, use_alibi=use_alibi, layer_idx=0,
              dtype=torch.float32, device="cpu", **kw)
    mha.load_state_dict(gpt_state_dict_from_jax(params))
    return jmha, params, mha


def test_mha_alibi_forward_matches_jax():
    jmha, params, mha = _mha_pair(True)
    x = np.random.RandomState(1).randn(2, 150, 256).astype(np.float32)
    jo = jmha.apply(params, jnp.asarray(x))
    with torch.no_grad():
        po = mha(t(x))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5, rtol=0)


@pytest.mark.parametrize("use_alibi", [True, False])
def test_mha_cached_steps_match_jax(use_alibi):
    # Prefill, single-token steps and a 3-token step over the cache: with
    # ALiBi every step runs B1 over the whole cache with kv_bound and
    # bound_causal; without it the multi-token steps do (the LLaMA-style
    # rotary path) and the single-token steps the decode kernel B8.
    jmha, params, mha = _mha_pair(use_alibi, rotary_emb_dim=0 if use_alibi else 64)
    rng = np.random.RandomState(3)
    xs = [rng.randn(2, s, 256).astype(np.float32) for s in (5, 1, 1, 3, 1)]
    jinf = JInferenceParams(max_seqlen=24, max_batch_size=2)
    pinf = InferenceParams(max_seqlen=24, max_batch_size=2)
    with torch.no_grad():
        for x in xs:
            jo = jmha.apply(params, jnp.asarray(x), inference_params=jinf)
            po = mha(t(x), inference_params=pinf)
            np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
            jinf.seqlen_offset += x.shape[1]
            pinf.seqlen_offset += x.shape[1]


@pytest.mark.parametrize("kw", [
    {}, dict(dim=5120, num_layers=40, num_heads=40), dict(dim=64, num_layers=2, num_heads=2,
                                                          vocab=128),
])
def test_baichuan_config_equals_jax(kw):
    same_config(configs.baichuan_config(**kw), jconfigs.baichuan_config(**kw))


@pytest.mark.parametrize("kw", [{}, dict(dim=64, num_layers=2, num_heads=2, vocab=128)])
def test_btlm_config_equals_jax(kw):
    same_config(configs.btlm_config(**kw), jconfigs.btlm_config(**kw))


def _tiny(family):
    """A tiny fp32 config of ``family`` in both packages (same fields)."""
    if family in ("btlm", "btlm_d80"):
        # btlm_d80: BTLM's head dim (2560 / 32 = 80) at two heads.
        kw = dict(dim=128 if family == "btlm" else 160, num_layers=2, num_heads=2, vocab=256)
        return (dataclasses.replace(configs.btlm_config(**kw), ffn_dim=192, dtype=torch.float32),
                dataclasses.replace(jconfigs.btlm_config(**kw), ffn_dim=192, dtype=jnp.float32))
    kw = dict(dim=128, num_layers=2, num_heads=2, vocab=256)
    # baichuan_config picks ALiBi by width (13B) and rotary below it (7B).
    rotary = family == "baichuan_rotary"
    extra = dict(rotary_emb_dim=64 if rotary else 0, use_alibi=not rotary)
    return (dataclasses.replace(configs.baichuan_config(**kw), dtype=torch.float32, **extra),
            dataclasses.replace(jconfigs.baichuan_config(**kw), dtype=jnp.float32, **extra))


@pytest.mark.parametrize("family", ["baichuan_alibi", "baichuan_rotary", "btlm", "btlm_d80"])
def test_tiny_models_logits_and_greedy_match_jax(family):
    pcfg, jcfg = _tiny(family)
    ids = np.random.RandomState(2).randint(0, 256, (2, PROMPT)).astype(np.int32)
    jmodel = JGPT(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(ids)))
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict
    long_ids = np.random.RandomState(5).randint(0, 256, (2, 140)).astype(np.int32)
    with torch.no_grad():
        logits = pmodel(t(long_ids).long())
    assert rel_l2(logits.numpy(), np.asarray(jmodel.apply(params, jnp.asarray(long_ids)))) < 1e-4
    jtok = np.asarray(jgen.greedy_decode(
        lambda p, x, inf: jmodel.apply(p, x, inference_params=inf), params, jnp.asarray(ids),
        NEW, MAX_SEQLEN))
    ptok = generation.greedy_decode(pmodel, t(ids).long(), NEW, MAX_SEQLEN)
    np.testing.assert_array_equal(ptok.numpy(), jtok)


def _baichuan_sd(dim, nl, vocab, ffn, seed=6):
    rs = np.random.RandomState(seed)
    sd = {"model.embed_tokens.weight": rs.randn(vocab, dim) * 0.02,
          "model.norm.weight": 1 + 0.1 * rs.randn(dim),
          "lm_head.weight": rs.randn(vocab, dim) * 0.02}
    for i in range(nl):
        pre = f"model.layers.{i}."
        sd[pre + "self_attn.W_pack.weight"] = rs.randn(3 * dim, dim) * 0.02
        sd[pre + "self_attn.o_proj.weight"] = rs.randn(dim, dim) * 0.02
        sd[pre + "mlp.gate_proj.weight"] = rs.randn(ffn, dim) * 0.02
        sd[pre + "mlp.up_proj.weight"] = rs.randn(ffn, dim) * 0.02
        sd[pre + "mlp.down_proj.weight"] = rs.randn(dim, ffn) * 0.02
        sd[pre + "input_layernorm.weight"] = 1 + 0.1 * rs.randn(dim)
        sd[pre + "post_attention_layernorm.weight"] = 1 + 0.1 * rs.randn(dim)
    return sd


def _btlm_sd(dim, nl, vocab, ffn, seed=8):
    rs = np.random.RandomState(seed)
    sd = {"transformer.wte.weight": rs.randn(vocab, dim) * 0.02,
          "transformer.ln_f.weight": 1 + 0.1 * rs.randn(dim),
          "transformer.ln_f.bias": 0.1 * rs.randn(dim)}
    shapes = {"attn.c_attn": (dim, 3 * dim), "attn.c_proj": (dim, dim), "mlp.c_fc": (dim, ffn),
              "mlp.c_fc2": (dim, ffn), "mlp.c_proj": (ffn, dim)}
    for i in range(nl):
        pre = f"transformer.h.{i}."
        for name, shape in shapes.items():
            sd[pre + name + ".weight"] = rs.randn(*shape) * 0.02
            sd[pre + name + ".bias"] = 0.1 * rs.randn(shape[1])
        for j in (1, 2):
            sd[pre + f"ln_{j}.weight"] = 1 + 0.1 * rs.randn(dim)
            sd[pre + f"ln_{j}.bias"] = 0.1 * rs.randn(dim)
    return sd


@pytest.mark.parametrize("use_rotary", [True, False])
def test_baichuan_remap_matches_jax_and_hf(use_rotary):
    dim, nl, vocab = 64, 2, 128
    cfg = dataclasses.replace(
        configs.baichuan_config(dim=dim, num_layers=nl, num_heads=2, vocab=vocab),
        dtype=torch.float32, rotary_emb_dim=dim // 2 if use_rotary else 0,
        use_alibi=not use_rotary)
    sd = _baichuan_sd(dim, nl, vocab, cfg.ffn_dim)
    got = pretrained.remap_state_dict_hf_baichuan(sd, cfg)
    ref = gpt_state_dict_from_jax(jpretrained.remap_state_dict_hf_baichuan(sd, cfg))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-7, atol=0)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(got)  # strict
    ids = np.random.RandomState(7).randint(0, vocab, (2, 24))
    with torch.no_grad():
        logits = model(t(ids).long()).numpy()
    hf = baichuan_forward(sd, ids, num_heads=2, num_layers=nl, use_rotary=use_rotary)
    np.testing.assert_allclose(logits, hf, atol=2e-3, rtol=1e-3)


def test_baichuan2_norm_head_remap():
    # A vocabulary above 70 000 is Baichuan2's normalised head: unit rows,
    # equal to JAX's remap.
    dim, vocab = 16, 70080
    cfg = configs.baichuan_config(dim=dim, num_layers=1, num_heads=2, vocab=vocab)
    sd = _baichuan_sd(dim, 1, vocab, cfg.ffn_dim)
    head = pretrained.remap_state_dict_hf_baichuan(sd, cfg)["lm_head.weight"]
    np.testing.assert_allclose(head.norm(dim=1).numpy(), np.ones(vocab), atol=1e-6)
    ref = jpretrained.remap_state_dict_hf_baichuan(sd, cfg)["params"]["lm_head"]["kernel"]
    np.testing.assert_allclose(head.numpy(), np.asarray(ref).T, rtol=1e-6, atol=1e-9)


def test_btlm_remap_matches_jax_and_hf():
    dim, nl, vocab, ffn = 64, 2, 128, 96
    cfg = dataclasses.replace(
        configs.btlm_config(dim=dim, num_layers=nl, num_heads=2, vocab=vocab),
        ffn_dim=ffn, dtype=torch.float32)
    sd = _btlm_sd(dim, nl, vocab, ffn)
    got = pretrained.remap_state_dict_hf_btlm(sd, cfg)
    ref = gpt_state_dict_from_jax(jpretrained.remap_state_dict_hf_btlm(sd, cfg))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-7, atol=0)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(got)  # strict
    ids = np.random.RandomState(9).randint(0, vocab, (2, 24))
    with torch.no_grad():
        logits = model(t(ids).long()).numpy()
    np.testing.assert_allclose(logits, btlm_forward(sd, ids, num_heads=2, num_layers=nl),
                               atol=2e-3, rtol=1e-3)


def _jax_init(jcfg, pcfg, ids):
    jmodel = JGPT(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(ids)))
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel


def _grads_match_jax(family):
    """The next-token loss's fp32 gradient of tiny ``family`` against
    jax.grad of the same loss: the loss within 1e-5 relative, each
    parameter within GRAD_TOL rel-L2."""
    pcfg, jcfg = _tiny(family)
    ids = np.random.RandomState(4).randint(0, 256, (2, 150)).astype(np.int32)
    jmodel, params, pmodel = _jax_init(jcfg, pcfg, ids)

    def jloss(p):
        return jce(jmodel.apply(p, jnp.asarray(ids))[:, :-1], jnp.asarray(ids)[:, 1:])

    jl, jgrads = jax.value_and_grad(jloss)(params)
    jgrads = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss = gpt_loss_fn(pmodel, t(ids).long(), t(ids).long())
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl)), family
    for name, p in pmodel.named_parameters():
        assert rel_l2(p.grad.numpy(), jgrads[name].numpy()) < GRAD_TOL, (family, name)


def test_alibi_model_training_raises():
    # Once pinned the raise of a gradient through B1's ALiBi channel; B7
    # now takes it, so tiny Baichuan (ALiBi) and BTLM (ALiBi, 1/d scale,
    # biases) take their gradients against jax.grad (_grads_match_jax).
    for family in ("baichuan_alibi", "btlm"):
        _grads_match_jax(family)


def test_btlm_head_dim_80_gradients_match_jax():
    # BTLM at its own head dim, 80: the gradient B7's D-80 instantiations
    # compute on the card, through their plain version here.
    _grads_match_jax("btlm_d80")


TRAIN_STEPS, TRAIN_B, TRAIN_S = 3, 2, 64
TRAIN = dict(learning_rate=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS, grad_clip=0.5)


def test_alibi_trainer_matches_jax():
    # 3 steps of the port's Trainer against JAX's on tiny Baichuan (ALiBi)
    # from the same init and synthetic_lm_batches: per-step loss within
    # 1e-5 relative, grad norm within 1e-4, as tests/test_torch_trainer.py;
    # final parameters within 1 % of one step's size (lr) absolute: AdamW
    # normalises each update, so an element whose gradient is near fp32
    # rounding (an embedding row seen once) moves by a share of lr that
    # the rounding decides (2.7e-5 at lr 3e-3 here). The model has no
    # biases, so no slice with a zero exact gradient is left out.
    pcfg, jcfg = _tiny("baichuan_alibi")
    jmodel, params, pmodel = _jax_init(jcfg, pcfg, np.zeros((TRAIN_B, TRAIN_S), np.int32))

    def jloss(p, batch):
        return jce(jmodel.apply(p, batch)[:, :-1], batch[:, 1:])

    jtrainer = JTrainer(jloss, JTrainConfig(**TRAIN))
    state = jtrainer.init_state(params)
    jrecs = []
    state = jtrainer.fit(state, jdata.synthetic_lm_batches(256, TRAIN_B, TRAIN_S, seed=3),
                         TRAIN_STEPS, log_every=1, log_fn=jrecs.append)
    jfinal = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state["params"]))
    trainer = Trainer(pmodel, lambda m, x: gpt_loss_fn(m, x, x), TrainConfig(**TRAIN),
                      device="cpu")
    recs = []
    trainer.fit(pdata.synthetic_lm_batches(256, TRAIN_B, TRAIN_S, seed=3), TRAIN_STEPS,
                log_every=1, log_fn=recs.append)
    assert len(recs) == len(jrecs) == TRAIN_STEPS
    for r, j in zip(recs, jrecs):
        assert abs(r["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
        assert abs(r["grad_norm"] - j["grad_norm"]) <= 1e-4 * j["grad_norm"]
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jfinal[name].numpy(),
                                   atol=1e-2 * TRAIN["learning_rate"], rtol=0, err_msg=name)
