"""Rank bodies of the port's multi-rank parity tests
(``tests/test_torch_parallel.py``).

A spawned rank re-imports the module that defined its target, so the
bodies live here, in a module that imports neither JAX nor the JAX
package (``tests/conftest.py`` would set up the JAX CPU client in every
rank). :func:`run_ranks` spawns CPU ranks on gloo once, joined through a
file in a fresh directory (no port to collide with another test
worker's), runs every case of each world size on a group of that many
ranks, in order, and returns each rank's results. Inputs arrive as numpy arrays; results go
back as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def run_ranks(cases_by_world, timeout: float = 300.0):
    """``cases_by_world``: ``{n: [(name, payload), ...]}``; returns ``{n:
    [rank] -> {name: result}}`` for ranks ``0 .. n - 1``. One spawn of the
    largest ``n`` ranks (each spawned rank pays for importing torch): a
    smaller world's cases run on the group of ranks ``0 .. n - 1``, the
    first row of a ``(world / n, n)`` mesh, while the other ranks go on. A
    rank's failure raises here; ranks still running after ``timeout``
    seconds are killed and a ``TimeoutError`` raised."""
    world = max(cases_by_world)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_worker, args=(world, tmp, cases_by_world), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
        out = {n: [] for n in cases_by_world}
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                for n, results in pickle.load(f).items():
                    out[n].append(results)
    return out


def _worker(rank, world, tmp, cases_by_world):
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                           world_size=world)
    results = {}
    for n, cases in sorted(cases_by_world.items(), reverse=True):
        if world % n:
            raise ValueError(f"a world of {n} ranks does not tile {world}")
        # Every rank builds the mesh (its groups are made collectively).
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(-1, n),
                          mesh_dim_names=("rows", "sp"))["sp"]
        if rank >= n:
            continue
        results[n] = {}
        for name, payload in cases:
            with torch.no_grad() if not payload.get("grad") else torch.enable_grad():
                results[n][name] = _numpy(CASES[payload.get("fn", name)](mesh, payload))
    dist.barrier()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    return x


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _rank(mesh):
    return mesh.get_local_rank("sp")


# ------------------------------------------------------------- attention


@case
def combine(mesh, p):
    from liteattention_torch.ops.combine import combine_attention_psum

    r = _rank(mesh)
    return combine_attention_psum(_t(p["outs"][r]), _t(p["lses"][r]), mesh.get_group("sp"))


@case
def seq_parallel(mesh, p):
    from liteattention_torch.ops.tile_sizes import BlockSizes
    from liteattention_torch.parallel import make_seq_parallel_attention

    q, k, v = (_t(p[n]) for n in ("q", "k", "v"))
    init_fn, step_fn = make_seq_parallel_attention(mesh, "sp", block_sizes=BlockSizes(128, 128))
    b, h, s, d = q.shape
    state = init_fn(b, h, s, k.shape[2], d, 4)
    steps = []
    for thr in p["thresholds"]:
        out, lse, state = step_fn(state, q, k, v, thr)
        steps.append((out, lse, state.do_mask, state.step))
    return steps


@case
def seq_parallel_init_raises(mesh, p):
    from liteattention_torch.ops.tile_sizes import BlockSizes
    from liteattention_torch.parallel import make_seq_parallel_attention

    init_fn, _ = make_seq_parallel_attention(mesh, "sp", block_sizes=BlockSizes(128, 128))
    try:
        init_fn(1, 2, 256, p["seqlen_k"], 64, 4)
    except ValueError as e:
        return str(e)
    return None


@case
def ring(mesh, p):
    from liteattention_torch.parallel import ring_self_attention

    q, k, v = (_t(p[n]).requires_grad_() for n in ("q", "k", "v"))
    o = ring_self_attention(q, k, v, mesh, "sp", causal=p["causal"])
    (o * (1.0 + 0.01 * o)).sum().backward()
    return o, q.grad, k.grad, v.grad


@case
def ring_local_lse(mesh, p):
    from liteattention_torch.parallel import ring_attention_local
    from liteattention_torch.parallel._collectives import shard_dim

    g = mesh.get_group("sp")
    q, k, v = (shard_dim(_t(p[n]), 2, g) for n in ("q", "k", "v"))
    return ring_attention_local(q, k, v, g, causal=p["causal"], return_lse=True)


@case
def ulysses(mesh, p):
    from liteattention_torch.parallel import ulysses_self_attention

    q = _t(p["q"]).requires_grad_()
    k, v = _t(p["k"]), _t(p["v"])
    o = ulysses_self_attention(q, k, v, mesh, "sp", causal=p["causal"])
    (o ** 2).sum().backward()
    return o, q.grad


@case
def ulysses_uneven_heads(mesh, p):
    """The message of the ValueError Ulysses raises on 3 heads (None if
    none)."""
    from liteattention_torch.parallel import ulysses_self_attention

    x = torch.zeros(1, 3, 256, 64)
    try:
        ulysses_self_attention(x, x, x, mesh, "sp")
    except ValueError as e:
        return str(e)
    return None


# -------------------------------------------------------- tensor parallel


@case
def tp_functions(mesh, p):
    from liteattention_torch.parallel import tensor_parallel as tpm

    g = mesh.get_group("sp")
    r, n = _rank(mesh), g.size()
    x, w, b = _t(p["x"]), _t(p["w"]), _t(p["b"])  # w [in, out] (JAX's kernel)
    emb, pos, ids = _t(p["emb"]), _t(p["pos"]), _t(p["ids"])
    wt = w.T  # [out, in]
    out = {}
    out["column"] = tpm.column_parallel_dense(x, tpm.shard_rows(wt, r, n),
                                              tpm.shard_rows(b, r, n))
    out["column_gather"] = tpm.column_parallel_dense(
        tpm.shard_rows(x.transpose(0, 1), r, n).transpose(0, 1), tpm.shard_rows(wt, r, n),
        gather_input_group=g)
    x_loc = tpm.shard_rows(x.movedim(-1, 0), r, n).movedim(0, -1)
    out["row"] = tpm.row_parallel_dense(x_loc, tpm.shard_cols(wt, r, n), b, group=g)
    out["row_scatter"] = tpm.row_parallel_dense(x_loc, tpm.shard_cols(wt, r, n), b, group=g,
                                                scatter_output=True)
    emb_loc = tpm.shard_rows(emb, r, n)
    out["vocab_embedding"] = tpm.vocab_parallel_embedding(ids, emb_loc, g)
    out["column_embedding"] = tpm.column_parallel_embedding(ids, tpm.shard_cols(emb, r, n))
    pos_loc = tpm.shard_cols(pos, r, n)
    out["gpt2_embeddings"] = tpm.parallel_gpt2_embeddings(ids, emb_loc, pos_loc, group=g)
    out["gpt2_embeddings_sp"] = tpm.parallel_gpt2_embeddings(ids, emb_loc, pos_loc, group=g,
                                                             sequence_parallel=True)
    out["vocab_logits"] = tpm.vocab_parallel_logits(x, emb_loc)
    return out


def _load(module, state_dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()})
    return module


@case
def parallel_modules(mesh, p):
    from liteattention_torch.models.convert import state_dict_from_flax
    from liteattention_torch.modules import MHA, GatedMlp, Mlp, ParallelMHA, ParallelMLP
    from liteattention_torch.modules.mha import parallel_mha_state_dict
    from liteattention_torch.modules.mlp import parallel_mlp_state_dict

    g = mesh.get_group("sp")
    r, n = _rank(mesh), g.size()
    x = _t(p["x"])
    f32 = dict(dtype=torch.float32, device="cpu")
    mha = ParallelMHA(p["dim"], p["heads"], g, num_heads_kv=p["heads_kv"], causal=True, **f32)
    _load(mha, state_dict_from_flax(p["mha_trees"][r]))
    mlp = ParallelMLP(p["dim"], p["hidden"], g, **f32)
    _load(mlp, state_dict_from_flax(p["mlp_trees"][r]))
    gmlp = ParallelMLP(p["dim"], p["hidden"], g, activation=torch.nn.functional.silu,
                       gated=True, **f32)
    _load(gmlp, state_dict_from_flax(p["gmlp_trees"][r]))
    # A single-device module's weights sharded for this rank.
    one = _load(MHA(p["dim"], p["heads"], num_heads_kv=p["heads_kv"], causal=True, **f32),
                state_dict_from_flax(p["mha_one"]))
    sharded = ParallelMHA(p["dim"], p["heads"], g, num_heads_kv=p["heads_kv"], causal=True,
                          **f32)
    sharded.load_state_dict(parallel_mha_state_dict(one.state_dict(), p["heads"], r, n,
                                                    p["heads_kv"]))
    gone = GatedMlp(p["dim"], p["hidden"], **f32)
    gone.load_state_dict(state_dict_from_flax(p["gmlp_one"]))
    gsharded = ParallelMLP(p["dim"], p["hidden"], g, activation=torch.nn.functional.silu,
                           gated=True, **f32)
    gsharded.load_state_dict(parallel_mlp_state_dict(gone.state_dict(), r, n, gated=True))
    # OPT's MLP: ReLU, both biases (fc2's added after the sum).
    bone = Mlp(p["dim"], p["hidden"], activation=torch.relu, **f32)
    gen = torch.Generator().manual_seed(7)
    for w in bone.parameters():
        w.copy_(torch.randn(w.shape, generator=gen) * 0.2)
    bsharded = ParallelMLP(p["dim"], p["hidden"], g, activation=torch.relu, bias1=True,
                           bias2=True, **f32)
    bsharded.load_state_dict(parallel_mlp_state_dict(bone.state_dict(), r, n))
    return {"mha": mha(x), "mlp": mlp(x), "gated_mlp": gmlp(x),
            "mha_sharded": sharded(x), "mha_one": one(x),
            "gated_mlp_sharded": gsharded(x), "gated_mlp_one": gone(x),
            "biased_mlp_sharded": bsharded(x), "biased_mlp_one": bone(x)}


def _gpt_config(fields):
    from liteattention_torch.models.gpt import GPTConfig

    return GPTConfig(**{**fields, "dtype": torch.float32})


@case
def gpt_tp(mesh, p):
    from liteattention_torch.models.gpt import (
        GPTLMHeadModel,
        gpt_state_dict_from_jax,
        gpt_tp_apply,
        gpt_tp_state_dict,
    )
    from liteattention_torch.parallel._collectives import all_gather_dim

    g = mesh.get_group("sp")
    cfg = _gpt_config(p["cfg"])
    sd = gpt_state_dict_from_jax(p["params"])
    ids = _t(p["ids"]).long()
    try:
        shard = gpt_tp_state_dict(cfg, sd, _rank(mesh), g.size())
    except ValueError as e:
        return {"error": str(e)}
    local = gpt_tp_apply(cfg, shard, ids, g)
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict(sd)
    return {"local": local, "logits": all_gather_dim(local, 2, g), "dense": model(ids)}


# -------------------------------------------------------------------- wan


@case
def wan_sp(mesh, p):
    from liteattention_torch.models import WanConfig, WanModel, init_skip_states
    from liteattention_torch.models.wan import wan_state_dict_from_jax

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[p["dtype"]]
    cfg = dataclasses.replace(WanConfig.tiny(), dtype=dtype, sp_axis="sp")
    model = WanModel(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(wan_state_dict_from_jax(p["params"]))
    grid = tuple(p["grid"])
    states = init_skip_states(cfg, 1, grid, device="cpu", mesh=mesh)
    out, new = model(_t(p["latents"]), _t(p["t"]), _t(p["text"]), states, p["threshold"])
    return {"out": out, "masks": [new[i].do_mask for i in sorted(new)]}


@case
def wan_sp_denoise(mesh, p):
    from liteattention_torch.models import WanConfig, WanModel, denoise
    from liteattention_torch.models.wan import wan_state_dict_from_jax

    cfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32, sp_axis="sp")
    model = WanModel(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(wan_state_dict_from_jax(p["params"]))
    x, tel = denoise(model, _t(p["latents"]), _t(p["text"]), _t(p["null_text"]),
                     num_steps=len(p["thresholds"]), thresholds=p["thresholds"])
    return {"x": x, "sparsity": tel["sparsity_per_step"],
            "masks": [tel["final_states"][i].do_mask for i in sorted(tel["final_states"])]}


@case
def wan_sp_raises(mesh, p):
    from liteattention_torch.models import WanConfig, WanModel, init_skip_states

    cfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32, sp_axis="sp")
    msgs = []
    try:
        WanModel(cfg, device="cpu")
    except ValueError as e:
        msgs.append(str(e))
    try:
        init_skip_states(cfg, 1, tuple(p["grid"]), device="cpu", mesh=mesh)
    except ValueError as e:
        msgs.append(str(e))
    return msgs
