"""Port parity: modules/moe.py (routing, the MoE FFN, MoEMlp), the MoE GPT
(``GPTConfig(moe_experts=)``, ``gpt_loss_fn``'s aux term), the config-tree
training run of ``configs/experiment/gpt2s-moe.yaml`` and the causality
monitor on an MoE block, against the JAX package on the same numpy inputs.

Tolerances (fp32 on both sides):
- ``_route``'s dispatch equals JAX's bit for bit (which tokens go to which
  expert slot, with drops and with planted ties). Its combine and aux
  agree within 2^-22 absolute, 4 fp32 ulps at 1 (gates lie in [0, 1], aux
  near 1): XLA's exp and torch's differ in the last bit, so the gates can
  too.
- ``moe_forward`` / ``MoEMlp`` outputs within 1e-5 relative (rel-L2) and
  gradients within 1e-4 rel-L2 of ``jax.grad``: the same sums in other
  orders. At top_k 1 the gate is p / p, whose exact gradient is 0: both
  sides' router gradients carry fp32 roundoff from it beside the aux
  loss's, held within 5e-3 rel-L2.
- the tiny MoE GPT's logits and loss within 1e-4 (rel-L2 / relative).
- the causality leak vectors within 1e-6 absolute.
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
from liteattention_tpu.models.gpt import gpt_loss_fn as jgpt_loss_fn  # noqa: E402
from liteattention_tpu.modules import moe as jmoe  # noqa: E402
from liteattention_tpu.training import diagnostics as jdiag  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.modules import moe  # noqa: E402
from liteattention_torch.modules.moe import MoEMlp  # noqa: E402
from liteattention_torch.training import diagnostics  # noqa: E402

ROUTE_ATOL = 2.0**-22
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _router_inputs(seed, t_, d, e, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(t_, d).astype(np.float32)
    router = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    if ties:
        # Experts 0-2 share one router column: every token ties among them
        # (exactly equal logits), and top-k must take the lower index.
        router[:, 1] = router[:, 0]
        router[:, 2] = router[:, 0]
    return x, router


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [6, 24, 96], ids=lambda c: f"cap{c}")
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_equals_jax(top_k, capacity, ties):
    x, router = _router_inputs(3 + capacity, 96, 32, 4, ties)
    jd, jc, ja = jmoe._route(jnp.asarray(x), jnp.asarray(router), top_k, capacity)
    pd, pc, pa = moe._route(t(x), t(router), top_k, capacity)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0, atol=ROUTE_ATOL)
    np.testing.assert_allclose(float(pa), float(ja), rtol=0, atol=ROUTE_ATOL)
    per_expert = pd.numpy().sum(axis=(0, 2))
    if ties:
        # Lower index first among the tied experts 0-2: expert 2 is never
        # picked, expert 1 only as a second choice.
        assert per_expert[2] == 0 and (top_k == 2 or per_expert[1] == 0)
    elif capacity * 4 < 96 * top_k:
        assert (per_expert == capacity).all()  # every slot full, the rest dropped


def test_route_ties_take_the_lower_index():
    x, router = _router_inputs(1, 40, 8, 4, ties=True)
    _, experts, _, _, _, _ = moe._route_indices(t(x), t(router), 2, 40)
    jtop = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router)), 2)[1])
    np.testing.assert_array_equal(experts.numpy(), jtop)
    tied = experts.numpy()[:, 0] != 3
    assert tied.any() and (experts.numpy()[tied] == [0, 1]).all()


def _moe_params(seed, d, f, e):
    params = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("capacity", [None, 8], ids=["factor", "drops"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_and_grads_match_jax(capacity, top_k):
    d, f, e, t_ = 16, 32, 4, 64
    params = _moe_params(0, d, f, e)
    x = np.random.RandomState(1).randn(t_, d).astype(np.float32)
    w = np.random.RandomState(2).randn(t_, d).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(p, xx, top_k=top_k, capacity=capacity)
        return jnp.sum(y * w) + 0.1 * aux

    jy, jaux = jmoe.moe_forward({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                                top_k=top_k, capacity=capacity)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()},
                                              jnp.asarray(x))
    pp = {k: t(v).requires_grad_() for k, v in params.items()}
    px = t(x).requires_grad_()
    stats = {}
    py, paux = moe.moe_forward(pp, px, top_k=top_k, capacity=capacity, stats=stats)
    (torch.sum(py * t(w)) + 0.1 * paux).backward()
    assert rel_l2(py.detach().numpy(), np.asarray(jy)) < FWD_TOL
    assert abs(paux.item() - float(jaux)) <= 1e-6 * abs(float(jaux))
    for k in params:
        tol = 5e-3 if (k, top_k) == ("router", 1) else GRAD_TOL
        assert rel_l2(pp[k].grad.numpy(), np.asarray(jg[k])) < tol, k
    assert rel_l2(px.grad.numpy(), np.asarray(jgx)) < GRAD_TOL
    dropped = float(stats["dropped"])
    assert (dropped > 0) == (capacity == 8)


def test_moemlp_matches_jax_module():
    jm = jmoe.MoEMlp(dim=16, hidden=32, num_experts=4, top_k=2)
    x = np.random.RandomState(6).randn(2, 10, 16).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(7), jnp.asarray(x))
    jy, state = jm.apply({"params": variables["params"]}, jnp.asarray(x), mutable=["losses"])
    pm = MoEMlp(16, 32, num_experts=4, top_k=2, device="cpu")
    pm.load_state_dict({f"moe.{k}": t(v) for k, v in variables["params"]["moe"].items()})
    py = pm(t(x))
    assert py.shape == (2, 10, 16)
    assert rel_l2(py.detach().numpy(), np.asarray(jy)) < FWD_TOL
    (jaux,) = state["losses"]["moe_aux"]
    assert abs(pm.aux_loss.item() - float(jaux)) <= 1e-6 * float(jaux)
    assert pm.capacity == int(1.25 * 2 * 20 / 4) and float(pm.dropped) >= 0.0


def test_init_moe_params_scales_and_dtypes():
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(g, 64, 256, 8, dtype=torch.bfloat16, device="cpu")
    assert p["router"].dtype == torch.float32 and p["wi"].dtype == torch.bfloat16
    assert p["router"].shape == (64, 8) and p["wi"].shape == (8, 64, 256)
    assert p["wo"].shape == (8, 256, 64)
    assert abs(p["wi"].float().std().item() - 1 / 8) < 0.01
    assert abs(p["wo"].float().std().item() - 1 / 16) < 0.005


def test_expert_parallel_functions_raise_naming_a15(tmp_path):
    # Expert parallelism is ported (held against JAX at 2 and 4 ranks in
    # tests/test_torch_parallel_training.py). On a one-rank group here:
    # moe_apply_sharded is moe_forward, and a router whose experts the
    # ranks do not hold raises.
    import torch.distributed as dist

    class OneDimMesh:
        def get_group(self, dim):
            return dist.group.WORLD

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        p = moe.init_moe_params(torch.Generator().manual_seed(1), 8, 16, 4, device="cpu")
        x = torch.randn(32, 8, generator=torch.Generator().manual_seed(2))
        y, aux = moe.moe_apply_sharded(p, x, OneDimMesh(), "ep")
        y1, aux1 = moe.moe_forward(p, x)
        assert torch.equal(y, y1) and torch.equal(aux, aux1)
        with pytest.raises(ValueError, match="the router has 4 experts, the ranks hold 3"):
            moe.moe_forward_expert_parallel(dict(p, wi=p["wi"][:3], wo=p["wo"][:3]), x,
                                            dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _tiny_moe_gpt(seed=0, **kw):
    base = dict(vocab_size=128, max_position_embeddings=64, dim=64, num_layers=2, num_heads=2,
                moe_experts=4, moe_top_k=2)
    base.update(kw)
    jcfg = JGPTConfig(**base, dtype=jnp.float32)
    pcfg = GPTConfig(**base, dtype=torch.float32)
    jmodel = JGPT(jcfg)
    ids = np.random.RandomState(seed).randint(0, 128, (2, 32)).astype(np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed + 1), jnp.asarray(ids))
    params = {"params": jax.tree_util.tree_map(np.asarray, variables["params"])}
    pmodel = GPTLMHeadModel(pcfg, device="cpu")
    pmodel.load_state_dict(gpt_state_dict_from_jax(params))  # strict: MoE keys carried
    return jmodel, params, pmodel, ids


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5], ids=["no_drops", "drops"])
def test_moe_gpt_logits_loss_and_grads_match_jax(capacity_factor):
    jmodel, params, pmodel, ids = _tiny_moe_gpt(moe_capacity_factor=capacity_factor)
    jlogits = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt_loss_fn(jmodel, p, jnp.asarray(ids), jnp.asarray(ids)))(params)
    logits = pmodel(t(ids).long())
    assert rel_l2(logits.detach().numpy(), jlogits) < 1e-4
    loss = gpt_loss_fn(pmodel, t(ids).long(), t(ids).long())
    assert abs(loss.item() - float(jloss)) < 1e-4 * float(jloss)
    loss.backward()
    jg = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in pmodel.named_parameters():
        assert rel_l2(p.grad.numpy(), jg[name].numpy()) < 1e-3, name
    router = pmodel.transformer.blocks[0].mlp.moe["router"].grad
    assert router.abs().max() > 0  # the aux loss and the gates train the router
    dropped = [float(b.mlp.dropped) for b in pmodel.transformer.blocks]
    assert (max(dropped) > 0) == (capacity_factor < 1)


def test_moe_gpt_weights_stored_as_jax_stores_them():
    cfg = GPTConfig(vocab_size=64, max_position_embeddings=32, dim=32, num_layers=1,
                    num_heads=2, moe_experts=4)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    m = model.transformer.blocks[0].mlp.moe
    assert m["router"].dtype == torch.float32
    assert m["wi"].dtype == m["wo"].dtype == torch.bfloat16  # cfg.dtype, as in JAX
    assert m["wi"].float().std() > 0 and m["wo"].float().std() > 0


def test_config_tree_moe_training_runs_on_cpu():
    from liteattention_torch import train as train_cli

    recs = []
    argv = ["--config", "configs/config.yaml", "experiment=gpt2s-moe", "model.dim=64",
            "model.num_layers=2", "model.num_heads=2", "model.vocab=256", "run.seqlen=64",
            "run.batch_size=2", "run.steps=8", "optimizer.warmup_steps=2", "--device", "cpu",
            "--log-every", "1", "--overfit-batch"]
    trainer = train_cli.run(argv, log_fn=recs.append)
    cfg = trainer.model.cfg
    assert cfg.moe_experts == 4 and cfg.moe_top_k == 2 and cfg.moe_capacity_factor == 1.25
    assert trainer.cfg.learning_rate == 6e-4 and trainer.cfg.warmup_steps == 2
    losses = [r["loss"] for r in recs]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def _moe_block(causal, capacity_factor):
    """One pre-norm block (causal MHA + MoE) in both packages, the port's
    weights the JAX block's; fn: [B, L, 16] -> [B, L, 16] (out + residual)."""
    from liteattention_tpu.modules.block import Block as JBlock
    from liteattention_tpu.modules.mha import MHA as JMHA
    from liteattention_torch.models.convert import state_dict_from_flax
    from liteattention_torch.modules.block import Block
    from liteattention_torch.modules.mha import MHA

    jb = JBlock(dim=16, mixer=lambda: JMHA(16, 2, causal=causal, dtype=jnp.float32, name="mha"),
                mlp=lambda: jmoe.MoEMlp(dim=16, hidden=32, num_experts=4,
                                        capacity_factor=capacity_factor, name="mlp"),
                residual_in_fp32=True, dtype=jnp.float32)
    variables = jb.init(jax.random.PRNGKey(3), jnp.zeros((2, 10, 16)))
    params = {"params": variables["params"]}
    pb = Block(16, MHA(16, 2, causal=causal, dtype=torch.float32, device="cpu"),
               MoEMlp(16, 32, num_experts=4, capacity_factor=capacity_factor, device="cpu"),
               residual_in_fp32=True, dtype=torch.float32, device="cpu")
    pb.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))

    def jfn(x):
        out, res = jb.apply(params, x, mutable=["losses"])[0]
        return out + res

    def pfn(x):
        out, res = pb(x)
        return out + res

    return jfn, pfn


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("capacity_factor", [4.0, 0.5], ids=["no_drops", "drops"])
def test_causality_leakage_matches_jax_on_an_moe_block(causal, capacity_factor):
    jfn, pfn = _moe_block(causal, capacity_factor)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 10, 16), jnp.float32))
    jleak = np.asarray(jdiag.causality_leakage(jfn, seq_len=10, input_dim=16))
    pleak = diagnostics.causality_leakage(pfn, x=t(x)).numpy()
    np.testing.assert_allclose(pleak, jleak, atol=1e-6, rtol=1e-4)
    # Routing is piecewise constant: a dropped slot passes no gradient, so
    # even a capacity that drops reads no leak through a causal model.
    assert diagnostics.check_causal(pfn, seq_len=10, input_dim=16) == causal
    assert jdiag.check_causal(jfn, seq_len=10, input_dim=16) == causal


def test_moe_gpt_config_from_dataclass_replace():
    cfg = dataclasses.replace(GPTConfig.tiny(), moe_experts=4)
    model = GPTLMHeadModel(cfg, device="cpu")
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(0))
    loss = gpt_loss_fn(model, ids, ids)
    assert torch.isfinite(loss)
    ce = gpt_loss_fn(model, ids, ids, moe_aux_weight=0.0)
    aux = sum(b.mlp.aux_loss for b in model.transformer.blocks)
    assert abs(loss.item() - (ce.item() + 0.01 * aux.item())) < 1e-5


def test_capacity_drops_let_a_later_token_change_an_earlier_output():
    # A fault of JAX's design that the port keeps (ROADMAP C): positions
    # are slot-major over the whole flattened batch, so a later token's
    # first choice can take the slot an earlier token's second choice would
    # have had. The earlier token's output then moves with a later token,
    # a causal model's forward reads the future, and no gradient shows it
    # (the routing is piecewise constant): causality_leakage reads 0. At 20
    # slots an expert the first choices (~16 each) leave room that the
    # second choices fill in token order.
    d, f, e, t_ = 16, 32, 4, 64
    params = _moe_params(0, d, f, e)
    x = np.random.RandomState(1).randn(t_, d).astype(np.float32)
    moved = 0
    for j in range(t_ // 2, t_):
        x2 = x.copy()
        x2[j] = np.random.RandomState(j).randn(d)
        outs = []
        for xx in (x, x2):
            jy, _ = jmoe.moe_forward({k: jnp.asarray(v) for k, v in params.items()},
                                     jnp.asarray(xx), capacity=20)
            py, _ = moe.moe_forward({k: t(v) for k, v in params.items()}, t(xx), capacity=20)
            assert rel_l2(py.numpy(), np.asarray(jy)) < FWD_TOL
            outs.append(py.numpy())
        moved += int(np.abs(outs[0][:j] - outs[1][:j]).max() > 1e-6)
    assert moved > 0
