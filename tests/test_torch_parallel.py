"""Port parity: the attention half of ``liteattention_torch/parallel``
(``combine_attention_psum``, sequence-parallel LiteAttention, ring and
Ulysses attention) and Wan's ``sp_axis``, on gloo ranks, against the JAX
package's ``shard_map`` on the conftest's virtual CPU devices (the
tensor-parallel half: ``tests/test_torch_tensor_parallel.py``).

The port's ranks run in spawned processes (``tests/_torch_dist.py``: one
spawn of 4 ranks, the 2-rank cases on ranks 0 and 1); JAX runs the same
numpy inputs over a mesh of as many devices. Tolerances (fp32 unless
said): the merges (``combine_attention_psum``) 1e-6, as the single-device
combine; sequence-parallel LiteAttention out and lse 1e-4, as the
single-device engine, each rank's mask shard bit-equal; ring and Ulysses
2e-5, their gradients 3e-4 (JAX's own bounds against the oracle); the
Wan model 1e-4 rel-L2 with its masks bit-equal in fp32, as the
single-device model, and in bf16 6e-2 absolute (JAX's own bound for its
sequence-parallel model).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402
from _torch_port import coherent_qkv, rel_l2  # noqa: E402
from liteattention_tpu.models.wan import (  # noqa: E402
    WanConfig as JWanConfig,
    WanModel as JWanModel,
    init_skip_states as jinit_states,
)
from liteattention_tpu.ops.attention_ref import attention_ref  # noqa: E402
from liteattention_tpu.ops.combine import combine_attention_psum as jcombine_psum  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_tpu.parallel import (  # noqa: E402
    make_seq_parallel_attention as jmake_sp,
    ring_self_attention as jring,
    ulysses_self_attention as julysses,
)

WORLDS = (2, 4)
SP_THRESHOLDS = [-10.0, 0.5, 1.0, 1.5]
# A log2 threshold at which this random-weight model skips a quarter of
# the tiles a shard of two or more tiles holds.
WAN_THRESHOLD = 2.0
# (name, grid, dtype, worlds): JAX's own case (its 256-token grid, one
# tile a shard, bf16), a count that is not a multiple of n x 128 (480 = 2
# x 240: each shard ends in a 112-key tile), and 1024 tokens for 4 ranks
# (JAX needs the whole mask's k-tiles to divide by n).
WAN_CASES = [("wan256_bf16", (8, 8, 16), "bfloat16", (2,)),
             ("wan480", (5, 16, 24), "float32", (2,)),
             ("wan1024", (8, 16, 32), "float32", (4,))]


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------------- inputs


def _combine_inputs(n):
    rng = np.random.RandomState(10 + n)
    q, k, v = (rng.randn(1, 2, 256, 64).astype(np.float32) for _ in range(3))
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * 256 // n, (r + 1) * 256 // n)
        o, l = attention_ref(jnp.asarray(q), jnp.asarray(k[:, :, sl]), jnp.asarray(v[:, :, sl]))
        outs.append(np.asarray(o))
        lses.append(np.asarray(l))
    outs, lses = np.stack(outs), np.stack(lses)
    lses[:, :, :, :8] = -np.inf  # rows no rank saw: out 0, lse -inf
    lses[0, :, 1, 8:16] = -np.inf  # rows one rank did not see
    return dict(outs=outs, lses=lses)


def _sp_inputs(n):
    q, k, v = coherent_qkv(np.random.RandomState(20 + n), 1, 2, 2 * 128 * n, 2 * 128 * n, 64)
    return dict(q=q, k=k, v=v, thresholds=SP_THRESHOLDS)


def _attn_inputs(n, seed, h=2, hk=None):
    rng = np.random.RandomState(seed)
    s = 128 * n
    q = rng.randn(1, h, s, 64).astype(np.float32)
    k, v = (rng.randn(1, hk or h, s, 64).astype(np.float32) for _ in range(2))
    return dict(q=q, k=k, v=v)


@functools.lru_cache(maxsize=None)
def _wan_params():
    """The tiny Wan's fp32 parameters (their shapes do not depend on the
    grid or the compute dtype)."""
    cfg = JWanConfig.tiny()
    grid = (1, 2, 2)
    return _np_tree(jax.jit(JWanModel(cfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, *grid, cfg.in_channels)), jnp.full((1,), 500.0),
        jnp.zeros((1, cfg.text_len, cfg.text_dim)), jinit_states(cfg, 1, grid)))


def _wan_inputs(grid, dtype):
    cfg = JWanConfig.tiny()
    rng = np.random.RandomState(60)
    lat = rng.randn(1, *grid, cfg.in_channels).astype(np.float32)
    text = rng.randn(1, cfg.text_len, cfg.text_dim).astype(np.float32)
    tt = np.full((1,), 500.0, np.float32)
    return dict(params=_wan_params(), latents=lat, text=text, t=tt, grid=grid,
                dtype=dtype, threshold=WAN_THRESHOLD)


@pytest.fixture(scope="module")
def inputs():
    out = {n: {} for n in WORLDS}
    for n in WORLDS:
        out[n]["combine"] = _combine_inputs(n)
        out[n]["seq_parallel"] = _sp_inputs(n)
        for causal in (False, True):
            out[n][f"ring_causal{int(causal)}"] = dict(
                _attn_inputs(n, 70 + causal), causal=causal, fn="ring", grad=True)
            out[n][f"ulysses_causal{int(causal)}"] = dict(
                _attn_inputs(n, 80 + causal, h=4), causal=causal, fn="ulysses", grad=True)
    out[2]["ring_gqa"] = dict(_attn_inputs(2, 90, h=4, hk=2), causal=True, fn="ring", grad=True)
    out[2]["ring_local_lse"] = dict(_attn_inputs(2, 71), causal=True)
    out[2]["seq_parallel_init_raises"] = dict(seqlen_k=384)
    out[2]["ulysses_uneven_heads"] = {}
    for name, grid, dtype, worlds in WAN_CASES:
        wan = _wan_inputs(grid, dtype)
        for n in worlds:
            out[n][name] = dict(wan, fn="wan_sp")
    den = dict(out[2]["wan480"], fn="wan_sp_denoise", thresholds=[WAN_THRESHOLD] * 2)
    den["null_text"] = np.zeros_like(den["text"])
    out[2]["wan_sp_denoise"] = den
    out[2]["wan_sp_raises"] = dict(grid=(1, 6, 10), fn="wan_sp_raises")  # 15 tokens
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    """[n] -> [rank] -> {case: result}: one spawn of 4 ranks, the 2-rank
    cases on ranks 0 and 1."""
    return run_ranks({n: list(inputs[n].items()) for n in WORLDS})


def _same_on_every_rank(ranks, name, key=None):
    got = [r[name] if key is None else r[name][key] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("n", WORLDS)
def test_combine_attention_psum_matches_jax(inputs, ranks, n):
    p = inputs[n]["combine"]
    jo, jl = jax.jit(jax.shard_map(
        lambda o, l: jcombine_psum(o[0], l[0], "sp"), mesh=_mesh(n),
        in_specs=(P("sp"), P("sp")), out_specs=(P(), P()), check_vma=False,
    ))(jnp.asarray(p["outs"]), jnp.asarray(p["lses"]))
    for r in range(n):
        po, pl = ranks[n][r]["combine"]
        np.testing.assert_allclose(po, np.asarray(jo), atol=1e-6, rtol=0)
        np.testing.assert_allclose(pl, np.asarray(jl), atol=1e-6, rtol=0)
        assert (po[:, :, :8] == 0).all() and np.isneginf(pl[:, :, :8]).all()


@pytest.mark.parametrize("n", WORLDS)
def test_seq_parallel_four_steps_match_jax(inputs, ranks, n):
    """out and lse of every step; each rank's mask shard bit-equal to its
    slice of JAX's sharded mask after every step."""
    p = inputs[n]["seq_parallel"]
    init_fn, step_fn = jmake_sp(_mesh(n), "sp", block_sizes=JBS(128, 128))
    q, k, v = (jnp.asarray(p[x]) for x in ("q", "k", "v"))
    st = init_fn(1, 2, q.shape[2], k.shape[2], 64, 4)
    skipped = 0
    for j, thr in enumerate(p["thresholds"]):
        jo, jl, st = step_fn(st, q, k, v, thr)
        jm = np.asarray(st.do_mask)
        kt = jm.shape[3] // n
        for r in range(n):
            po, pl, pm, pstep = ranks[n][r]["seq_parallel"][j]
            np.testing.assert_allclose(po, np.asarray(jo), atol=1e-4, rtol=0)
            np.testing.assert_allclose(pl, np.asarray(jl), atol=1e-4, rtol=0)
            np.testing.assert_array_equal(pm, jm[..., r * kt:(r + 1) * kt])
            assert pstep == j + 1
        skipped = 1.0 - jm.mean()
    assert skipped > 0.0  # the votes shrank the masks


def test_seq_parallel_init_needs_whole_tiles_per_shard(ranks):
    for r in ranks[2]:
        assert "must divide evenly" in r["seq_parallel_init_raises"]


def _ring_reference(p, n, causal):
    """JAX's ring output and the gradients of sum(o * (1 + 0.01 o))."""
    def f(q, k, v):
        o, vjp = jax.vjp(lambda *a: jring(*a, _mesh(n), "sp", causal=causal), q, k, v)
        return o, vjp(1.0 + 0.02 * o)

    return jax.jit(f)(*(jnp.asarray(p[x]) for x in ("q", "k", "v")))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", WORLDS)
def test_ring_forward_and_gradients_match_jax(inputs, ranks, n, causal):
    name = f"ring_causal{int(causal)}"
    jo, jg = _ring_reference(inputs[n][name], n, causal)
    for r in range(n):
        po, *pg = ranks[n][r][name]
        np.testing.assert_allclose(po, np.asarray(jo), atol=2e-5, rtol=2e-5)
        for a, b in zip(pg, jg):
            np.testing.assert_allclose(a, np.asarray(b), atol=3e-4, rtol=3e-4)


def test_ring_gqa_matches_jax(inputs, ranks):
    jo, jg = _ring_reference(inputs[2]["ring_gqa"], 2, True)
    for r in range(2):
        po, *pg = ranks[2][r]["ring_gqa"]
        np.testing.assert_allclose(po, np.asarray(jo), atol=2e-5, rtol=2e-5)
        for a, b in zip(pg, jg):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, np.asarray(b), atol=3e-4, rtol=3e-4)


def test_ring_local_lse_is_the_global_lse(inputs, ranks):
    """Each rank's (out, lse) of its q shard equals the dense oracle's rows."""
    p = inputs[2]["ring_local_lse"]
    ro, rl = attention_ref(*(jnp.asarray(p[x]) for x in ("q", "k", "v")), causal=True)
    for r in range(2):
        po, pl = ranks[2][r]["ring_local_lse"]
        rows = slice(r * 128, (r + 1) * 128)
        np.testing.assert_allclose(po, np.asarray(ro)[:, :, rows], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(pl, np.asarray(rl)[:, :, rows], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_matches_jax(inputs, ranks, n, causal):
    name = f"ulysses_causal{int(causal)}"
    p = inputs[n][name]
    q, k, v = (jnp.asarray(p[x]) for x in ("q", "k", "v"))
    def f(q_):
        o, vjp = jax.vjp(lambda a: julysses(a, k, v, _mesh(n), "sp", causal=causal), q_)
        return o, vjp(2.0 * o)[0]

    jo, jg = jax.jit(f)(q)
    for r in range(n):
        po, pg = ranks[n][r][name]
        np.testing.assert_allclose(po, np.asarray(jo), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(pg, np.asarray(jg), atol=3e-4, rtol=3e-4)


def test_ulysses_needs_divisible_heads(ranks):
    for r in ranks[2]:
        assert "not divisible" in r["ulysses_uneven_heads"]


# -------------------------------------------------------------------- wan


def _jax_wan_sp(p, n):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[p["dtype"]]
    cfg = dataclasses.replace(JWanConfig.tiny(), dtype=jdt, sp_axis="sp")
    mesh = _mesh(n)
    grid = tuple(p["grid"])
    st = jinit_states(cfg, 1, grid, mesh=mesh)
    model = JWanModel(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, p["params"])
    with jax.sharding.set_mesh(mesh):
        out, new = jax.jit(lambda prm, x, tt, c, s: model.apply(prm, x, tt, c, s, p["threshold"]))(
            params, jnp.asarray(p["latents"]), jnp.asarray(p["t"]), jnp.asarray(p["text"]), st)
    return np.asarray(out, np.float32), [np.asarray(new[i].do_mask) for i in sorted(new)]


@pytest.mark.parametrize("name,n", [(c[0], n) for c in WAN_CASES for n in c[3]])
def test_wan_sequence_parallel_matches_jax(inputs, ranks, name, n):
    p = inputs[n][name]
    jo, jm = _jax_wan_sp(p, n)
    for r, got in enumerate(ranks[n]):
        res = got[name]
        if p["dtype"] == "float32":
            assert rel_l2(res["out"], jo) < 1e-4
            for pm, m in zip(res["masks"], jm):
                kt = m.shape[3] // n
                np.testing.assert_array_equal(pm, m[..., r * kt:(r + 1) * kt])
        else:
            np.testing.assert_allclose(res["out"], jo, atol=6e-2)
            assert [m.shape[3] // n for m in jm] == [pm.shape[3] for pm in res["masks"]]
    if p["dtype"] == "float32" and jm[0].shape[3] > n:  # two or more tiles a shard
        assert 0.0 < 1.0 - float(np.mean([m.mean() for m in jm])) < 1.0


def test_wan_denoise_reports_the_global_sparsity(inputs, ranks):
    """denoise on the sequence-parallel model: the same latents and
    sparsity on every rank, the sparsity that of the whole masks (the
    ranks' shards side by side)."""
    x = _same_on_every_rank(ranks[2], "wan_sp_denoise", "x")
    sp = _same_on_every_rank(ranks[2], "wan_sp_denoise", "sparsity")
    assert np.isfinite(x).all() and sp.shape == (2,)
    shards = [r["wan_sp_denoise"]["masks"] for r in ranks[2]]
    whole = [np.concatenate(layer, axis=3) for layer in zip(*shards)]
    assert sp[-1] == pytest.approx(np.mean([1.0 - m.mean() for m in whole]), abs=1e-6)
    assert sp[-1] > 0.0


def test_wan_sequence_parallel_argument_errors(ranks):
    for r in ranks[2]:
        no_mesh, uneven = r["wan_sp_raises"]
        assert "needs the DeviceMesh" in no_mesh
        assert "15 tokens do not split evenly over the 2" in uneven
