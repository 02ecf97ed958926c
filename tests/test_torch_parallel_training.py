"""Port parity: the gradients of the tensor-parallel half of
``liteattention_torch/parallel`` and the new training pieces, on gloo
ranks, against the JAX package on the conftest's virtual CPU devices and
against the dense model.

* ``parallel_cross_entropy_loss``: the loss against JAX's (label
  smoothing, ``lse_square_scale``, ``ignore_index``, the three
  reductions), and its gradient against the dense ``cross_entropy_loss``'s.
  JAX's loss has no gradient: ``jax.grad`` through it raises
  (``Differentiation rule for 'pmax' not implemented``), which
  ``test_jax_parallel_cross_entropy_has_no_gradient`` states.
* The six tensor-parallel functions, each with the loss ``sum(out *
  cot)`` over the whole output: the outputs and every gradient against
  ``jax.grad`` of JAX's ``shard_map`` form and against the dense function.
* ``ParallelMHA`` and ``ParallelMLP`` (OPT's, with both biases) against
  the single-device modules' gradients.
* ``gpt_tp_apply`` with ``parallel_cross_entropy_loss``: each rank's
  parameter gradients against its shard of ``jax.grad`` of JAX's
  ``gpt_tp_apply`` (the dense loss over its gathered logits) and of the
  port's dense model.
* ``moe_apply_sharded``: outputs, aux loss and gradients against JAX's
  (``tests/test_moe.py``'s case, capacity from the local token count and
  capacity ``T``) and against ``moe_forward`` where no token overflows.
* The data-parallel routing: ``moe_forward`` on each rank's slice of the
  tokens with the group gives JAX's single-device ``moe_forward`` over all
  of them, with capacity drops (the capacity from the whole count).

The port's ranks run in one spawn of 4 ranks (``tests/_torch_dist_train.py``),
the 2-rank cases on ranks 0 and 1. Tolerances (fp32): the CE and the six
functions 1e-5; the modules and the GPT 2e-4 (JAX's bound for its TP GPT
against the dense model); the MoE 2e-4 (JAX's bound for its
expert-parallel gradients).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from _torch_dist_train import run_ranks  # noqa: E402
from liteattention_tpu.losses.cross_entropy import (  # noqa: E402
    cross_entropy_loss as jce,
    parallel_cross_entropy_loss as jpce,
)
from liteattention_tpu.models.gpt import (  # noqa: E402
    GPTConfig as JGPTConfig,
    GPTLMHeadModel as JGPT,
    gpt_tp_apply as jgpt_tp_apply,
)
from liteattention_tpu.modules.mha import MHA as JMHA  # noqa: E402
from liteattention_tpu.modules.moe import (  # noqa: E402
    init_moe_params as jinit_moe,
    moe_apply_sharded as jmoe_sharded,
)
from liteattention_tpu.modules.moe import moe_forward as jmoe_forward  # noqa: E402
from liteattention_tpu.parallel import tensor_parallel as jtp  # noqa: E402
from liteattention_torch.losses import cross_entropy_loss  # noqa: E402
from liteattention_torch.models.convert import state_dict_from_flax  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_state_dict_from_jax,
    gpt_tp_state_dict,
)
from liteattention_torch.modules import MHA, Mlp  # noqa: E402
from liteattention_torch.modules.mha import parallel_mha_state_dict  # noqa: E402
from liteattention_torch.modules.mlp import parallel_mlp_state_dict  # noqa: E402
from liteattention_torch.modules.moe import moe_forward  # noqa: E402

WORLDS = (2, 4)
TOL, MODULE_TOL = 1e-5, 2e-4
CE_OPTIONS = [{}, dict(label_smoothing=0.1), dict(lse_square_scale=1e-3),
              dict(label_smoothing=0.2, lse_square_scale=1e-4, reduction="sum"),
              dict(reduction="none")]
GPT = dict(vocab_size=128, max_position_embeddings=32, dim=64, num_layers=2, num_heads=4)
GPT_CE = dict(label_smoothing=0.1, lse_square_scale=1e-3)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


def _sm(fn, n, in_specs, out_specs):
    return jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def _slice(x, axis, r, n):
    size = x.shape[axis] // n
    return np.take(x, np.arange(r * size, (r + 1) * size), axis=axis)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


# ----------------------------------------------------------------- inputs


def _ce_inputs():
    rng = np.random.RandomState(70)
    labels = rng.randint(0, 64, size=(3, 8))
    labels[0, :2] = -100
    return dict(logits=rng.randn(3, 8, 64).astype(np.float32), labels=labels,
                options=CE_OPTIONS)


def _tp_inputs():
    rng = np.random.RandomState(71)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(2, 8, 16), w=f(16, 32), b=f(32), h=f(2, 8, 32), w2=f(32, 16), b2=f(16),
                emb=f(64, 16), pos=f(8, 16), ids=rng.randint(0, 64, size=(2, 8)),
                cot_out=f(2, 8, 32), cot_in=f(2, 8, 16), cot_vocab=f(2, 8, 64))


def _module_inputs():
    rng = np.random.RandomState(72)
    dim, heads, hidden = 64, 4, 128
    x = rng.randn(2, 16, dim).astype(np.float32)
    mha = JMHA(dim, heads, causal=True, dtype=jnp.float32)
    shapes = jax.eval_shape(mha.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    mha_one = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if len(s.shape) == 2 else (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)
    mlp_one = {"fc1.weight": rng.randn(hidden, dim) / 8, "fc1.bias": 0.1 * rng.randn(hidden),
               "fc2.weight": rng.randn(dim, hidden) / 11, "fc2.bias": 0.1 * rng.randn(dim)}
    return dict(x=x, dim=dim, heads=heads, hidden=hidden, mha_one=mha_one,
                mlp_one={k: v.astype(np.float32) for k, v in mlp_one.items()},
                cot=rng.randn(2, 16, dim).astype(np.float32))


def _gpt_inputs():
    cfg = JGPTConfig(**GPT, dtype=jnp.float32)
    rng = np.random.RandomState(73)
    ids = rng.randint(0, GPT["vocab_size"], size=(2, 16)).astype(np.int32)
    shapes = jax.eval_shape(JGPT(cfg).init, jax.random.PRNGKey(0), jnp.asarray(ids))

    def draw(path, s):
        x = rng.randn(*s.shape).astype(np.float32)
        if len(s.shape) == 2:
            return x / np.float32(np.sqrt(s.shape[0]))
        return (1.0 + 0.1 * x) if "scale" in jax.tree_util.keystr(path) else 0.1 * x

    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    labels[:, -1] = -100
    return dict(cfg=GPT, params=jax.tree_util.tree_map_with_path(draw, shapes), ids=ids,
                labels=labels, ce=GPT_CE)


# (ranks, capacity factor) of the data-parallel routing's cases: over the
# 64 tokens, 0.5 drops half the (token, slot) pairs, 1.0 about 5 %.
MOE_DP_RUNS = [(2, 0.5), (4, 0.5), (4, 1.0)]


def _moe_inputs(capacity):
    params = jax.tree_util.tree_map(np.asarray, jinit_moe(jax.random.PRNGKey(4), 8, 16, 4))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (64, 8)))
    return dict(params=params, x=x, capacity=capacity)


@pytest.fixture(scope="module")
def inputs():
    out = {n: {} for n in WORLDS}
    for n in WORLDS:
        out[n]["parallel_ce"] = _ce_inputs()
        out[n]["tp_grads"] = _tp_inputs()
        out[n]["parallel_modules_grads"] = _module_inputs()
        out[n]["gpt_tp_grads"] = _gpt_inputs()
    out[4]["moe_local_capacity"] = dict(_moe_inputs(None), fn="moe_sharded")
    out[4]["moe_no_drops"] = dict(_moe_inputs(64), fn="moe_sharded")
    out[2]["moe_local_capacity"] = dict(_moe_inputs(None), fn="moe_sharded")
    for n, factor in MOE_DP_RUNS:
        out[n][f"moe_dp_{factor}"] = dict(_moe_inputs(None), capacity_factor=factor,
                                          fn="moe_data_parallel")
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks({n: list(cases.items()) for n, cases in inputs.items()})


# --------------------------------------------------------- cross entropy


@pytest.mark.parametrize("n", WORLDS)
def test_parallel_cross_entropy_matches_jax_and_the_dense_gradient(inputs, ranks, n):
    p = inputs[n]["parallel_ce"]
    logits, labels = p["logits"], p["labels"]
    for i, kw in enumerate(CE_OPTIONS):
        jloss = jax.jit(_sm(lambda lg, lb: jpce(lg, lb, "tp", **kw), n,
                            (P(None, None, "tp"), P()), P()))(logits, labels)
        lg = torch.from_numpy(logits).requires_grad_()
        dense = cross_entropy_loss(lg, torch.from_numpy(labels), **kw)
        (dense.sum() if dense.dim() else dense).backward()
        _close(dense.detach(), jce(jnp.asarray(logits), jnp.asarray(labels), **kw), TOL)
        for r, res in enumerate(ranks[n]):
            loss, grad = res["parallel_ce"][i]
            _close(loss, jloss, TOL, f"{kw} rank {r} loss")
            _close(grad, _slice(lg.grad.numpy(), 2, r, n), TOL, f"{kw} rank {r} grad")


def test_jax_parallel_cross_entropy_has_no_gradient(inputs):
    """The reference's fault, which the port fixes: JAX's pmax has no
    differentiation rule, so its tensor-parallel CE cannot train."""
    p = inputs[4]["parallel_ce"]
    loss = _sm(lambda lg, lb: jpce(lg, lb, "tp"), 4, (P(None, None, "tp"), P()), P())
    with pytest.raises(NotImplementedError, match="pmax"):
        jax.grad(lambda lg: loss(lg, p["labels"]))(jnp.asarray(p["logits"]))


# ------------------------------------------------------- the six functions


def _jax_tp_grads(p, n):
    """name -> (whole output, gradients), each by jax.grad of sum(out * cot)
    over JAX's shard_map form."""
    x, w, b, h, w2, b2 = (jnp.asarray(p[k]) for k in ("x", "w", "b", "h", "w2", "b2"))
    emb, pos, ids = jnp.asarray(p["emb"]), jnp.asarray(p["pos"]), jnp.asarray(p["ids"])
    cot_out, cot_in, cot_vocab = (jnp.asarray(p[k]) for k in ("cot_out", "cot_in", "cot_vocab"))
    tp_out, seq = P(None, None, "tp"), P(None, "tp", None)
    forms = {
        "column": (lambda a, c, d: jtp.column_parallel_dense(a, c, d),
                   (P(), P(None, "tp"), P("tp")), tp_out, (x, w, b), cot_out),
        "column_gather": (lambda a, c: jtp.column_parallel_dense(a, c, gather_input_axis="tp"),
                          (seq, P(None, "tp")), tp_out, (x, w), cot_out),
        "row": (lambda a, c, d: jtp.row_parallel_dense(a, c, d, "tp"),
                (tp_out, P("tp", None), P()), P(), (h, w2, b2), cot_in),
        "row_scatter": (lambda a, c, d: jtp.row_parallel_dense(a, c, d, "tp", scatter_output=True),
                        (tp_out, P("tp", None), P()), seq, (h, w2, b2), cot_in),
        "vocab_embedding": (lambda e: jtp.vocab_parallel_embedding(ids, e, "tp"),
                            (P("tp", None),), P(), (emb,), cot_in),
        "column_embedding": (lambda e: jtp.column_parallel_embedding(ids, e),
                             (P(None, "tp"),), tp_out, (emb,), cot_in),
        "gpt2_embeddings": (lambda e, q: jtp.parallel_gpt2_embeddings(ids, e, q, axis_name="tp"),
                            (P("tp", None), P(None, "tp")), P(), (emb, pos), cot_in),
        "gpt2_embeddings_sp": (lambda e, q: jtp.parallel_gpt2_embeddings(
            ids, e, q, axis_name="tp", sequence_parallel=True),
            (P("tp", None), P(None, "tp")), seq, (emb, pos), cot_in),
        "vocab_logits": (lambda a, e: jtp.vocab_parallel_logits(a, e),
                         (P(), P("tp", None)), tp_out, (x, emb), cot_vocab),
    }
    out = {}
    for name, (fn, in_specs, out_specs, args, cot) in forms.items():
        f = _sm(fn, n, in_specs, out_specs)

        def loss(*a, f=f, cot=cot):
            y = f(*a)
            return jnp.sum(y * cot), y

        grads, y = jax.jit(jax.grad(loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
        out[name] = (np.asarray(y), [np.asarray(g) for g in grads])
    return out


def _dense_tp_grads(p):
    """name -> (whole output, gradients) of the dense functions (torch)."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    ids = t["ids"].long()
    pos_ids = torch.arange(ids.shape[1])
    forms = {
        "column": (lambda a, c, d: a @ c + d, ("x", "w", "b"), "cot_out"),
        "column_gather": (lambda a, c: a @ c, ("x", "w"), "cot_out"),
        "row": (lambda a, c, d: a @ c + d, ("h", "w2", "b2"), "cot_in"),
        "vocab_embedding": (lambda e: e[ids], ("emb",), "cot_in"),
        "gpt2_embeddings": (lambda e, q: e[ids] + q[pos_ids], ("emb", "pos"), "cot_in"),
        "vocab_logits": (lambda a, e: a @ e.T, ("x", "emb"), "cot_vocab"),
    }
    forms["row_scatter"] = forms["row"]
    forms["column_embedding"] = forms["vocab_embedding"]
    forms["gpt2_embeddings_sp"] = forms["gpt2_embeddings"]
    out = {}
    for name, (fn, args, cot) in forms.items():
        leaves = [t[a].clone().requires_grad_() for a in args]
        y = fn(*leaves)
        (y * t[cot]).sum().backward()
        out[name] = (y.detach().numpy(), [x.grad.numpy() for x in leaves])
    return out


# How a rank's result maps onto the whole: the output's split axis (None:
# whole) and, per gradient, (split axis, whether the port's tensor is the
# transpose of JAX's kernel layout).
LAYOUT = {
    "column": (2, [(None, False), (1, True), (0, False)]),
    "column_gather": (2, [(1, False), (1, True)]),
    "row": (None, [(2, False), (0, True), (None, False)]),
    "row_scatter": (1, [(2, False), (0, True), (None, False)]),
    "vocab_embedding": (None, [(0, False)]),
    "column_embedding": (2, [(1, False)]),
    "gpt2_embeddings": (None, [(0, False), (1, False)]),
    "gpt2_embeddings_sp": (1, [(0, False), (1, False)]),
    "vocab_logits": (2, [(None, False), (0, False)]),
}


@pytest.mark.parametrize("n", WORLDS)
def test_tensor_parallel_gradients_match_jax_and_dense(inputs, ranks, n):
    p = inputs[n]["tp_grads"]
    jax_out, dense = _jax_tp_grads(p, n), _dense_tp_grads(p)
    for name, (out_axis, grads) in LAYOUT.items():
        for ref_name, (y_ref, g_ref) in (("jax", jax_out[name]), ("dense", dense[name])):
            for r, res in enumerate(ranks[n]):
                got = res["tp_grads"][name]
                msg = f"{name} rank {r} against {ref_name}"
                want = y_ref if out_axis is None else _slice(y_ref, out_axis, r, n)
                _close(got[0], want, TOL, msg + " out")
                for i, ((axis, transposed), g) in enumerate(zip(grads, g_ref)):
                    want = g if axis is None else _slice(g, axis, r, n)
                    _close(got[1 + i], want.T if transposed else want, TOL, f"{msg} grad {i}")


# -------------------------------------------------- the modules, the GPT


@pytest.mark.parametrize("n", WORLDS)
def test_parallel_modules_gradients_match_dense(inputs, ranks, n):
    p = inputs[n]["parallel_modules_grads"]
    f32 = dict(dtype=torch.float32, device="cpu")
    mha = MHA(p["dim"], p["heads"], causal=True, **f32)
    mha.load_state_dict(state_dict_from_flax(p["mha_one"]))
    mlp = Mlp(p["dim"], p["hidden"], activation=torch.relu, **f32)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in p["mlp_one"].items()})
    for name, module in (("mha", mha), ("mlp", mlp)):
        x = torch.from_numpy(p["x"]).requires_grad_()
        (module(x) * torch.from_numpy(p["cot"])).sum().backward()
        grads = {k: v.grad for k, v in module.named_parameters()}
        for r, res in enumerate(ranks[n]):
            got = res["parallel_modules_grads"][name]
            want = (parallel_mha_state_dict(grads, p["heads"], r, n) if name == "mha"
                    else parallel_mlp_state_dict(grads, r, n))
            _close(got["x"], x.grad, MODULE_TOL, f"{name} rank {r} x")
            assert set(got) == set(want) | {"x"}
            for k, v in want.items():
                _close(got[k], v, MODULE_TOL, f"{name} rank {r} {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_gpt_tp_gradients_match_jax_and_dense(inputs, ranks, n):
    p = inputs[n]["gpt_tp_grads"]
    jcfg = JGPTConfig(**GPT, dtype=jnp.float32)
    ids, labels = jnp.asarray(p["ids"]), jnp.asarray(p["labels"])
    tp = _sm(lambda prm, i: jgpt_tp_apply(jcfg, prm, i, "tp"), n, (P(), P()),
             P(None, None, "tp"))

    def jloss(prm):
        return jce(tp(prm, ids), labels, **GPT_CE)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(p["params"])
    jgrads = {k: v.numpy() for k, v in gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    cfg = GPTConfig(**GPT, dtype=torch.float32)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(gpt_state_dict_from_jax(p["params"]))
    dl = cross_entropy_loss(model(torch.from_numpy(p["ids"]).long()),
                            torch.from_numpy(p["labels"]), **GPT_CE)
    dl.backward()
    _close(dl.detach(), jl, MODULE_TOL)
    dense = {k: v.grad for k, v in model.named_parameters()}
    for r, res in enumerate(ranks[n]):
        got = res["gpt_tp_grads"]
        _close(got["loss"], jl, MODULE_TOL, f"rank {r} loss")
        for ref_name, grads in (("jax", jgrads), ("dense", dense)):
            want = gpt_tp_state_dict(cfg, {k: torch.as_tensor(v) for k, v in grads.items()},
                                     r, n)
            assert set(got["grads"]) == set(want)
            for k, v in want.items():
                _close(got["grads"][k], v, MODULE_TOL, f"rank {r} {k} against {ref_name}")


# -------------------------------------------------------------------- MoE


@pytest.mark.parametrize("n,name", [(4, "moe_local_capacity"), (4, "moe_no_drops"),
                                    (2, "moe_local_capacity")])
def test_moe_apply_sharded_matches_jax(inputs, ranks, n, name):
    p = inputs[n][name]
    params = {k: jnp.asarray(v) for k, v in p["params"].items()}
    x = jnp.asarray(p["x"])

    def loss(prm, xx):
        y, aux = jmoe_sharded(prm, xx, _mesh(n), "tp", top_k=2, capacity=p["capacity"])
        return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

    (gp, gx), (jy, jaux) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(params, x)
    want = {"y": jy, "aux": jaux, "x": gx, **gp}
    for r, res in enumerate(ranks[n]):
        got = res[name]
        for k, v in want.items():
            _close(got[k], v, MODULE_TOL, f"rank {r} {k}")
    if p["capacity"] == p["x"].shape[0]:  # no token overflows: the one-device layer
        tp = {k: torch.tensor(v).requires_grad_() for k, v in p["params"].items()}
        y, aux = moe_forward(tp, torch.tensor(p["x"]), top_k=2, capacity=p["capacity"])
        ((y ** 2).sum() + 0.01 * aux).backward()
        _close(ranks[n][0][name]["y"], y.detach(), MODULE_TOL)
        for k, v in tp.items():
            _close(ranks[n][0][name][k], v.grad, MODULE_TOL, k)


@pytest.mark.parametrize("n,factor", MOE_DP_RUNS)
def test_moe_data_parallel_routing_matches_jax_on_the_whole_batch(inputs, ranks, n, factor):
    """Each rank's slice of the tokens, routed over the group, gives JAX's
    single-device moe_forward over all of them: the output, the aux loss
    (the ranks' parts averaged) and the gradients (summed)."""
    p = inputs[n][f"moe_dp_{factor}"]
    params = {k: jnp.asarray(v) for k, v in p["params"].items()}

    def loss(prm):
        y, aux = jmoe_forward(prm, jnp.asarray(p["x"]), top_k=2, capacity_factor=factor)
        return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

    gp, (jy, jaux) = jax.jit(jax.grad(loss, has_aux=True))(params)
    stats = {}  # the capacity drops pairs
    moe_forward({k: torch.tensor(v) for k, v in p["params"].items()}, torch.tensor(p["x"]),
                top_k=2, capacity_factor=factor, stats=stats)
    assert float(stats["dropped"]) > 0.01
    for r, res in enumerate(ranks[n]):
        got = res[f"moe_dp_{factor}"]
        for k, v in {"y": jy, "aux": jaux, **gp}.items():
            _close(got[k], v, MODULE_TOL, f"rank {r} {k}")
