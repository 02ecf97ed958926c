"""Port parity: the GPT training path (liteattention_torch.models.gpt and the
modules under it) against the JAX package, with JAX-initialised weights
carried across by gpt_state_dict_from_jax.

Tiny GPT-2-shaped config (dim 128, 2 layers, 2 heads of 64, vocab 512, 256
positions; the GPT-J variant dim 512, 2 heads of 256), batch 2 x 100 tokens
(a ragged q-tile), causal attention
through the port's plain flash forward/backward and the JAX kernels in
interpret mode. Tolerances, fp32: logits and each parameter's gradient
within 1e-4 rel-L2, the loss within 1e-5 relative (summation order only).
bf16: logits within 2e-2 rel-L2, loss within 1e-3 relative, gradients
within 5e-2 rel-L2 (the two frameworks round bf16 products and sums at
other places). Norms and cross-entropy: 1e-6 absolute in fp32; Block 1e-5.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.losses.cross_entropy import cross_entropy_loss as jce  # noqa: E402
from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.modules.block import Block as JBlock  # noqa: E402
from liteattention_tpu.modules.mha import MHA as JMHA  # noqa: E402
from liteattention_tpu.modules.mlp import Mlp as JMlp  # noqa: E402
from liteattention_tpu.ops import norms as jnorms  # noqa: E402
from liteattention_torch.losses.cross_entropy import cross_entropy_loss  # noqa: E402
from liteattention_torch.models.configs import gpt2_config, llama_config  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.modules import MHA, Block, Mlp  # noqa: E402
from liteattention_torch.ops import norms  # noqa: E402

B, S = 2, 100

# Variants of the tiny config (fields shared by both GPTConfigs): GPT-2;
# gated MLP + RMSNorm + GQA + untied head without biases; the NeoX-style
# parallel block with separate norms, exact GELU and a biased head; the
# OPT-350m layout (projected embeddings, post-norm, ReLU); GPT-J's layout
# at its head dim (2 heads of 256, interleaved rotary over 64 of them, the
# tied-norm parallel block, bias-free attention, biased MLP and head).
VARIANTS = {
    "gpt2": {},
    "gated_rms_gqa": dict(gated_mlp=True, use_rms_norm=True, num_heads_kv=1,
                          tie_embeddings=False, attn_bias=False, mlp_bias=False),
    "parallel": dict(parallel_block=True, parallel_block_tied_norm=False,
                     mlp_gelu_exact=True, tie_embeddings=False, lm_head_bias=True),
    "opt350m": dict(word_embed_proj_dim=64, prenorm=False, mlp_relu=True),
    "gptj": dict(dim=512, num_heads=2, max_position_embeddings=0, rotary_emb_dim=64,
                 rotary_emb_interleaved=True, parallel_block=True, parallel_block_tied_norm=True,
                 attn_bias=False, mlp_bias=True, lm_head_bias=True, tie_embeddings=False),
}


def _models(variant, dtype="float32", seed=0):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(JGPTConfig.tiny(), dtype=jnp.dtype(dtype), **kw)
    pcfg = dataclasses.replace(GPTConfig.tiny(), dtype=getattr(torch, dtype), **kw)
    ids = np.random.RandomState(seed).randint(0, 512, size=(B, S)).astype(np.int32)
    jmodel = JGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel, ids


def _jax_loss_and_grads(jmodel, params, ids):
    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(ids))
        return jce(logits[:, :-1], jnp.asarray(ids)[:, 1:]), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), np.asarray(logits), gpt_state_dict_from_jax(grads)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gpt_matches_jax_fp32(variant):
    jmodel, params, pmodel, ids = _models(variant)
    jloss, jlogits, jgrads = _jax_loss_and_grads(jmodel, params, ids)
    logits = pmodel(t(ids))
    assert logits.dtype == torch.float32 and logits.shape == (B, S, 512)
    assert rel_l2(logits.detach().numpy(), jlogits) < 1e-4
    loss = gpt_loss_fn(pmodel, t(ids), t(ids))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert rel_l2(g.numpy(), jgrads[name].numpy()) < 1e-4, name


def test_gpt_remat_same_grads():
    # remat recomputes each block in the backward: same loss and gradients.
    _, _, pmodel, ids = _models("gpt2")
    remat = GPTLMHeadModel(dataclasses.replace(pmodel.cfg, remat=True), device="cpu")
    remat.load_state_dict(pmodel.state_dict())
    for m in (pmodel, remat):
        gpt_loss_fn(m, t(ids), t(ids)).backward()
    for (n, a), (_, b) in zip(pmodel.named_parameters(), remat.named_parameters()):
        assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-6), n


def test_gpt_matches_jax_bf16():
    jmodel, params, pmodel, ids = _models("gpt2", dtype="bfloat16", seed=1)
    jloss, jlogits, jgrads = _jax_loss_and_grads(jmodel, params, ids)
    loss = gpt_loss_fn(pmodel, t(ids), t(ids))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-3 * abs(jloss)
    with torch.no_grad():
        assert rel_l2(pmodel(t(ids)).numpy(), jlogits) < 2e-2
    for name, p in pmodel.named_parameters():
        assert p.dtype == torch.float32  # fp32 master weights
        assert rel_l2(p.grad.numpy(), jgrads[name].numpy()) < 5e-2, name


def test_gpt_raises_on_unported_features():
    # Rotary (tests/test_torch_rotary.py), ALiBi (tests/
    # test_torch_alibi_models.py) and dropout (tests/test_torch_dropout.py)
    # are ported: LLaMA, an ALiBi GPT and a GPT with dropout build (its
    # dropout path needs a generator); MoE still raises.
    GPTLMHeadModel(llama_config(dim=128, num_layers=1, num_heads=2), device="cpu")
    GPTLMHeadModel(dataclasses.replace(GPTConfig.tiny(), use_alibi=True), device="cpu")
    with pytest.raises(NotImplementedError, match="moe_experts"):
        GPTLMHeadModel(dataclasses.replace(GPTConfig.tiny(), moe_experts=4), device="cpu")
    model = GPTLMHeadModel(dataclasses.replace(GPTConfig.tiny(), dropout=0.1), device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(1, 8, dtype=torch.long), deterministic=False)
    cfg = gpt2_config()
    assert (cfg.dim, cfg.num_layers, cfg.num_heads, cfg.vocab_size) == (768, 12, 12, 50257)


@pytest.mark.parametrize("rms,prenorm,fp32res,dtype", [
    (False, True, True, "bfloat16"),
    (True, True, False, "float32"),
    (False, False, False, "float32"),
])
def test_norms_match_jax(rms, prenorm, fp32res, dtype):
    rng = np.random.RandomState(3)
    x, res = rng.randn(2, 5, 64).astype(np.float32), rng.randn(2, 5, 64).astype(np.float32)
    w, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    bias = None if rms else b
    j = jnorms.dropout_add_norm(
        jnp.asarray(x, jd), jnp.asarray(res, jnp.float32 if fp32res else jd), jnp.asarray(w),
        None if rms else jnp.asarray(b), eps=1e-5, prenorm=prenorm,
        residual_in_fp32=fp32res, rms=rms,
    )
    p = norms.dropout_add_norm(
        t(x).to(td), t(res).to(torch.float32 if fp32res else td), t(w),
        None if bias is None else t(bias), eps=1e-5, prenorm=prenorm,
        residual_in_fp32=fp32res, rms=rms,
    )
    j, p = (j, p) if prenorm else ((j,), (p,))
    tol = 1e-6 if dtype == "float32" else 1e-2  # bf16 outputs: one rounding step
    for a, r in zip(p, j):
        assert a.dtype == getattr(torch, str(r.dtype))
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r, np.float32), atol=tol * 8, rtol=tol)
    np.testing.assert_allclose(
        norms.layer_norm(t(x), t(w), t(b), 1e-5).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)),
        atol=1e-5, rtol=0,
    )
    # Residual dropout is ported (tests/test_torch_dropout.py): by default
    # (deterministic) it does nothing, and its training form needs a
    # generator, as JAX's needs an rng key.
    np.testing.assert_array_equal(norms.dropout_add_norm(t(x), None, t(w), None, dropout_p=0.1),
                                  norms.dropout_add_norm(t(x), None, t(w), None))
    with pytest.raises(ValueError, match="Generator"):
        norms.dropout_add_norm(t(x), None, t(w), None, dropout_p=0.1, deterministic=False)


@pytest.mark.parametrize("kw", [
    {},
    dict(label_smoothing=0.1),
    dict(lse_square_scale=1e-4, logit_scale=0.5),
    dict(reduction="sum"),
    dict(reduction="none", label_smoothing=0.2),
])
def test_cross_entropy_matches_jax(kw):
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(3, 7, 50)).astype(np.float32)
    labels = rng.randint(0, 50, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -100  # ignored
    j = jce(jnp.asarray(logits), jnp.asarray(labels), **kw)
    p = cross_entropy_loss(t(logits), t(labels), **kw)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5, rtol=1e-6)


def test_block_matches_jax():
    # Pre-norm block with the fp32 residual stream, two blocks chained so
    # the second gets a residual; MHA causal with GQA.
    rng = np.random.RandomState(5)
    x = rng.randn(2, 70, 128).astype(np.float32)
    jblock = JBlock(
        128, mixer=lambda: JMHA(128, 2, num_heads_kv=1, causal=True, dtype=jnp.float32, name="mha"),
        mlp=lambda: JMlp(512, dtype=jnp.float32, name="mlp"), residual_in_fp32=True,
        eps=1e-5, dtype=jnp.float32,
    )
    params = jax.tree_util.tree_map(
        np.asarray, jblock.init(jax.random.PRNGKey(6), jnp.asarray(x))
    )
    f32 = torch.float32
    block = Block(128, MHA(128, 2, num_heads_kv=1, causal=True, dtype=f32, device="cpu"),
                  Mlp(128, 512, dtype=f32, device="cpu"), residual_in_fp32=True,
                  eps=1e-5, dtype=f32, device="cpu")
    block.load_state_dict(gpt_state_dict_from_jax(params))
    jh, jr = jblock.apply(params, jnp.asarray(x))
    jh, jr = jblock.apply(params, jh, jr)
    with torch.no_grad():
        h, r = block(t(x))
        h, r = block(h, r)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5, rtol=0)


def test_entry_points_default_to_the_card():
    # With no device the port's entry points take cuda: on a machine
    # without a GPU they fail loudly instead of running on the CPU.
    from liteattention_torch.layers.rotary import rotary_freqs
    from liteattention_torch.lite_attention import lite_attention_init
    from liteattention_torch.models.wan import WanConfig, WanModel, init_skip_states
    from liteattention_torch.modules import Block, Dense, GatedMlp, Mlp
    from liteattention_torch.ops.mask import init_mask, must_do_mask
    from liteattention_torch.training import TrainConfig, Trainer

    calls = [
        lambda: GPTLMHeadModel(GPTConfig.tiny()),
        lambda: MHA(64, 2),
        lambda: Block(64, MHA(64, 2), Mlp(64, 128)),
        lambda: Block(64),
        lambda: Mlp(64, 128),
        lambda: GatedMlp(64, 128),
        lambda: Dense(64, 32),
        lambda: rotary_freqs(16, 32),
        lambda: WanModel(WanConfig.tiny()),
        lambda: init_skip_states(WanConfig.tiny(), 1, (1, 4, 4)),
        lambda: lite_attention_init(1, 2, 256, 256, 64),
        lambda: init_mask(1, 2, 256, 256, 128, 128),
        lambda: must_do_mask([(0, 10)], 256, 128),
    ]
    if torch.cuda.is_available():
        for call in calls:
            out = call()
            tensors = list(out.parameters()) if isinstance(out, torch.nn.Module) else (
                [s.do_mask for s in out.values()] if isinstance(out, dict)
                else list(out) if isinstance(out, tuple)
                else [getattr(out, "do_mask", out)])
            assert all(x.device.type == "cuda" for x in tensors)
        model = GPTLMHeadModel(GPTConfig.tiny())
        assert Trainer(model, gpt_loss_fn, TrainConfig()).device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model, gpt_loss_fn, TrainConfig())
