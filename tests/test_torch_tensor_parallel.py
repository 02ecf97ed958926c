"""Port parity: the tensor-parallel half of ``liteattention_torch/parallel``
(``parallel/tensor_parallel.py``, ``ParallelMHA``, ``ParallelMLP``,
``gpt_tp_apply``) on gloo ranks, against the JAX package's ``shard_map``
on the conftest's virtual CPU devices.

The port's ranks run in spawned processes (``tests/_torch_dist.py``: one
spawn of 4 ranks, the 2-rank cases on ranks 0 and 1). Tolerances (fp32): the six functions 1e-5;
``ParallelMHA`` / ``ParallelMLP`` and ``gpt_tp_apply`` 2e-4 (JAX's bound
for its TP GPT against the dense model).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402
from _torch_port import rel_l2  # noqa: E402
from liteattention_tpu.models.gpt import (  # noqa: E402
    GPTConfig as JGPTConfig,
    GPTLMHeadModel as JGPT,
    gpt_tp_apply as jgpt_tp_apply,
)
from liteattention_tpu.modules.mha import MHA as JMHA, ParallelMHA as JParallelMHA  # noqa: E402
from liteattention_tpu.modules.mlp import (  # noqa: E402
    GatedMlp as JGatedMlp,
    ParallelMLP as JParallelMLP,
)
from liteattention_tpu.parallel import tensor_parallel as jtp  # noqa: E402

WORLDS = (2, 4)
GPT_BASE = dict(vocab_size=128, max_position_embeddings=32, dim=64, num_layers=2, num_heads=4)
# (name, GPTConfig fields): JAX's two TP cases; OPT's ReLU MLP (JAX's
# function applies tanh GELU whatever the config); GPT-2's odd vocab
# cut to 129 (JAX drops the last row at tp 2).
GPT_CASES = [("gpt_tied", dict(GPT_BASE, tie_embeddings=True)),
             ("gpt_untied", dict(GPT_BASE, tie_embeddings=False)),
             ("gpt_opt_relu", dict(GPT_BASE, mlp_relu=True)),
             ("gpt_odd_vocab", dict(GPT_BASE, vocab_size=129))]


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(module, seed, *args):
    """A Flax module's param tree drawn with numpy (its shapes by
    ``eval_shape``, so no forward runs): kernels and embeddings N(0,
    1/rows), norm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.randn(*leaf.shape).astype(np.float32)
        if len(leaf.shape) == 2:
            return x / np.sqrt(leaf.shape[0]).astype(np.float32)
        return (1.0 + 0.1 * x) if "scale" in name else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)

# ----------------------------------------------------------------- inputs


def _tp_inputs():
    rng = np.random.RandomState(30)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(2, 8, 16), w=f(16, 32), b=f(32), emb=f(64, 16), pos=f(24, 16),
                ids=rng.randint(0, 64, size=(2, 8)).astype(np.int64))

def _module_inputs(n):
    """Per-rank Flax trees of JAX's ParallelMHA / ParallelMLP (each rank's
    own local weights) and single-device trees of MHA / GatedMlp."""
    dim, heads, heads_kv, hidden = 64, 4, 4, 128
    x = np.random.RandomState(40).randn(2, 16, dim).astype(np.float32)
    xj = jnp.asarray(x)

    def init(module, seed):
        return _random_params(module, seed, xj)

    mha_local = JMHA(dim, heads // n, num_heads_kv=heads_kv // n, head_dim=dim // heads,
                     causal=True, out_proj_bias=False, dtype=jnp.float32)
    out_bias = np.random.RandomState(200).randn(dim).astype(np.float32)  # replicated
    mha_trees = [{"local_mha": init(mha_local, 100 + r), "out_bias": out_bias}
                 for r in range(n)]
    mlp_trees = [_mlp_tree(dim, hidden // n, False, 300 + r) for r in range(n)]
    gmlp_trees = [_mlp_tree(dim, hidden // n, True, 400 + r) for r in range(n)]
    mha_one = init(JMHA(dim, heads, num_heads_kv=heads_kv, causal=True, dtype=jnp.float32), 500)
    gmlp_one = init(JGatedMlp(hidden, dtype=jnp.float32), 600)
    return dict(x=x, dim=dim, heads=heads, heads_kv=heads_kv, hidden=hidden,
                mha_trees=mha_trees, mlp_trees=mlp_trees, gmlp_trees=gmlp_trees,
                mha_one=mha_one, gmlp_one=gmlp_one)


def _mlp_tree(dim, hidden_local, gated, seed):
    """A rank's ParallelMLP tree: fc1 / fc2 kernels, no bias."""
    rng = np.random.RandomState(seed)
    up = (2 if gated else 1) * hidden_local
    return {"fc1": {"kernel": (rng.randn(dim, up) / np.sqrt(dim)).astype(np.float32)},
            "fc2": {"kernel": (rng.randn(hidden_local, dim) / np.sqrt(hidden_local)).astype(
                np.float32)}}


@functools.lru_cache(maxsize=None)
def _gpt_params(items):
    fields = dict(items)
    cfg = JGPTConfig(**fields, dtype=jnp.float32)
    ids = np.random.RandomState(50).randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    return {"params": _random_params(JGPT(cfg), 0, jnp.asarray(ids))}, ids


def _gpt_inputs(fields):
    params, ids = _gpt_params(tuple(sorted(fields.items())))
    return dict(cfg=fields, params=params, ids=ids)

@pytest.fixture(scope="module")
def inputs():
    out = {n: {} for n in WORLDS}
    for n in WORLDS:
        out[n]["tp_functions"] = _tp_inputs()
        out[n]["parallel_modules"] = _module_inputs(n)
        out[n]["gpt_tied"] = dict(_gpt_inputs(GPT_CASES[0][1]), fn="gpt_tp")
    for name, fields in GPT_CASES[1:]:
        out[2][name] = dict(_gpt_inputs(fields), fn="gpt_tp")
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    """[n] -> [rank] -> {case: result}: one spawn of 4 ranks, the 2-rank
    cases on ranks 0 and 1."""
    return run_ranks({n: list(inputs[n].items()) for n in WORLDS})


# -------------------------------------------------------- tensor parallel


@functools.lru_cache(maxsize=None)
def _tp_reference(n):
    """JAX's six functions in shard_map over n devices, each output
    whole (gathered where it is split)."""
    mesh = _mesh(n)
    p = _tp_inputs()
    x, w, b, emb, pos = (jnp.asarray(p[k]) for k in ("x", "w", "b", "emb", "pos"))
    ids = jnp.asarray(p["ids"], jnp.int32)

    def sm(fn, in_specs, out_specs, *args):
        return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                                out_specs=out_specs, check_vma=False))(*args))

    feat = P(None, None, "sp")
    return {
        "column": sm(jtp.column_parallel_dense, (P(), P(None, "sp"), P("sp")), feat, x, w, b),
        "column_gather": sm(lambda x_, w_: jtp.column_parallel_dense(
            x_, w_, gather_input_axis="sp"), (P(None, "sp"), P(None, "sp")), feat, x, w),
        "row": sm(lambda x_, w_, b_: jtp.row_parallel_dense(x_, w_, b_, "sp"),
                  (feat, P("sp", None), P()), P(), x, w, b),
        "row_scatter": sm(lambda x_, w_, b_: jtp.row_parallel_dense(
            x_, w_, b_, "sp", scatter_output=True), (feat, P("sp", None), P()),
            P(None, "sp", None), x, w, b),
        "vocab_embedding": sm(lambda i, e: jtp.vocab_parallel_embedding(i, e, "sp"),
                              (P(), P("sp", None)), P(), ids, emb),
        "column_embedding": sm(jtp.column_parallel_embedding, (P(), P(None, "sp")), feat,
                               ids, emb),
        "gpt2_embeddings": sm(lambda i, e, q: jtp.parallel_gpt2_embeddings(i, e, q, axis_name="sp"),
                              (P(), P("sp", None), P(None, "sp")), P(), ids, emb, pos),
        "gpt2_embeddings_sp": sm(lambda i, e, q: jtp.parallel_gpt2_embeddings(
            i, e, q, axis_name="sp", sequence_parallel=True),
            (P(), P("sp", None), P(None, "sp")), P(None, "sp", None), ids, emb, pos),
        "vocab_logits": sm(jtp.vocab_parallel_logits, (P(), P("sp", None)), feat, x, emb),
    }


# How each port output lies over the ranks: whole on each, or split on a dim.
TP_LAYOUT = {"column": -1, "column_gather": -1, "row": None, "row_scatter": 1,
             "vocab_embedding": None, "column_embedding": -1, "gpt2_embeddings": None,
             "gpt2_embeddings_sp": 1, "vocab_logits": -1}


@pytest.mark.parametrize("fn", sorted(TP_LAYOUT))
@pytest.mark.parametrize("n", WORLDS)
def test_tensor_parallel_functions_match_jax(inputs, ranks, n, fn):
    ref = _tp_reference(n)[fn]
    got = [r["tp_functions"][fn] for r in ranks[n]]
    dim = TP_LAYOUT[fn]
    if dim is None:
        for g in got:
            np.testing.assert_allclose(g, ref, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(np.concatenate(got, axis=dim), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_parallel_mha_and_mlp_match_jax(inputs, ranks, n):
    """JAX's ParallelMHA / ParallelMLP with each rank's own Flax tree
    (stacked on a leading rank axis) against the port's with that tree
    converted; a single-device MHA / GatedMlp / OPT's biased ReLU Mlp
    sharded by the port's converters equals the module it came from."""
    p = inputs[n]["parallel_modules"]
    mesh = _mesh(n)
    x = jnp.asarray(p["x"])
    stack = lambda trees: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees)  # noqa: E731

    def run(module, trees):
        return np.asarray(jax.jit(jax.shard_map(
            lambda t, x_: module.apply({"params": jax.tree_util.tree_map(lambda a: a[0], t)}, x_),
            mesh=mesh, in_specs=(P("sp"), P()), out_specs=P(), check_vma=False,
        ))(stack(trees), x))

    refs = {
        "mha": run(JParallelMHA(p["dim"], p["heads"], "sp", num_heads_kv=p["heads_kv"],
                                causal=True, dtype=jnp.float32), p["mha_trees"]),
        "mlp": run(JParallelMLP(p["hidden"], "sp", dtype=jnp.float32), p["mlp_trees"]),
        "gated_mlp": run(JParallelMLP(p["hidden"], "sp", activation=jax.nn.silu, gated=True,
                                      dtype=jnp.float32), p["gmlp_trees"]),
    }
    for r in ranks[n]:
        got = r["parallel_modules"]
        for name, ref in refs.items():
            np.testing.assert_allclose(got[name], ref, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got["mha_sharded"], got["mha_one"], atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got["gated_mlp_sharded"], got["gated_mlp_one"], atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(got["biased_mlp_sharded"], got["biased_mlp_one"], atol=2e-4,
                                   rtol=2e-4)


def _jax_gpt(p, n):
    cfg = JGPTConfig(**p["cfg"], dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, p["params"])
    ids = jnp.asarray(p["ids"])
    dense = np.asarray(jax.jit(JGPT(cfg).apply)(params, ids))
    tp = np.asarray(jax.jit(jax.shard_map(
        lambda prm, i: jgpt_tp_apply(cfg, prm, i, "sp"), mesh=_mesh(n),
        in_specs=(P(), P()), out_specs=P(None, None, "sp"), check_vma=False,
    ))(params, ids))
    return dense, tp


@pytest.mark.parametrize("name,n", [("gpt_tied", 2), ("gpt_tied", 4), ("gpt_untied", 2)])
def test_gpt_tp_apply_matches_jax(inputs, ranks, name, n):
    dense, tp = _jax_gpt(inputs[n][name], n)
    np.testing.assert_allclose(tp, dense, atol=2e-4, rtol=2e-4)
    for r, got in enumerate(ranks[n]):
        res = got[name]
        v = dense.shape[-1] // n
        np.testing.assert_allclose(res["local"], tp[..., r * v:(r + 1) * v], atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(res["logits"], tp, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(res["dense"], dense, atol=2e-4, rtol=2e-4)


def test_gpt_tp_apply_follows_the_mlp_activation(inputs, ranks):
    """A fault of the reference: JAX's gpt_tp_apply applies tanh GELU
    whatever the config, so its OPT (ReLU) logits depart from its own
    dense model's; the port's follow the config and match it."""
    dense, jtp_logits = _jax_gpt(inputs[2]["gpt_opt_relu"], 2)
    assert rel_l2(jtp_logits, dense) > 1e-2  # JAX: the wrong activation
    for got in ranks[2]:
        np.testing.assert_allclose(got["gpt_opt_relu"]["logits"], dense, atol=2e-4, rtol=2e-4)


def test_gpt_tp_state_dict_refuses_an_uneven_vocab(inputs, ranks):
    """A fault of the reference: JAX slices vocab // tp rows a rank, so at
    tp 2 a vocab of 129 loses its last row and the TP logits are 128
    wide; the port raises."""
    dense, jtp_logits = _jax_gpt(inputs[2]["gpt_odd_vocab"], 2)
    assert dense.shape[-1] == 129 and jtp_logits.shape[-1] == 128
    for got in ranks[2]:
        assert "vocab_size 129 does not divide by tp=2" in got["gpt_odd_vocab"]["error"]
