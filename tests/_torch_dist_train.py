"""Rank bodies of the port's multi-rank parity tests of the training half
of ``parallel/`` (``tests/test_torch_pipeline.py``,
``tests/test_torch_data_parallel.py``,
``tests/test_torch_parallel_training.py``,
``tests/test_torch_train_data_parallel.py``).

The cases register with ``tests/_torch_dist.py``'s and run through its
``run_ranks`` (one spawn of gloo CPU ranks; every case of each world size
on the group of ranks ``0 .. n - 1``, the mesh dim ``sp``). Like that
module this one imports neither JAX nor the JAX package. Inputs arrive as
numpy arrays; results go back as numpy arrays.
"""

from __future__ import annotations

import torch

import _torch_dist
from _torch_dist import _t, case


def run_ranks(cases_by_world, timeout: float = 300.0):
    """``_torch_dist.run_ranks`` over this module's cases, with gradients
    on. Each payload carries a reference to this module's ``run_ranks``,
    so a spawned rank imports the module, and with it registers the cases,
    when it unpickles its arguments."""
    return _torch_dist.run_ranks(
        {n: [(name, dict(p, grad=True, cases_from=run_ranks)) for name, p in cases]
         for n, cases in cases_by_world.items()}, timeout)


def _rank(mesh):
    return mesh.get_local_rank("sp")


def _grads(*tensors):
    return [x.grad for x in tensors]


# -------------------------------------------------------------- pipeline


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


@case
def pipeline(mesh, p):
    """pipeline_apply of tanh(x @ w + b) stages, loss sum(y^2): y and the
    gradients of w, b and x (whole on every rank)."""
    from liteattention_torch.parallel import pipeline_apply

    w, b, x = (_t(p[k]).requires_grad_() for k in ("w", "b", "x"))
    y = pipeline_apply(_stage, (w, b), x, mesh, "sp", num_microbatches=p["m"])
    (y ** 2).sum().backward()
    with torch.no_grad():  # the schedule without a graph
        y_eval = pipeline_apply(_stage, (w, b), x, mesh, "sp", num_microbatches=p["m"])
    return [y, *_grads(w, b, x), y_eval]


class _TanhLinear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.lin = torch.nn.Linear(w.shape[0], w.shape[1])
        with torch.no_grad():
            self.lin.weight.copy_(w.T)
            self.lin.bias.copy_(b)

    def forward(self, x):
        return torch.tanh(self.lin(x))


@case
def pipeline_module(mesh, p):
    """pipeline_apply_local with this rank's stage an nn.Module: y, x's
    gradient (on rank 0 only) and the stage's weight and bias gradients."""
    from liteattention_torch.parallel import pipeline_apply_local

    r = _rank(mesh)
    stage = _TanhLinear(_t(p["w"][r]), _t(p["b"][r]))
    x = _t(p["x"]).requires_grad_()
    y = pipeline_apply_local(stage, None, x, mesh.get_group("sp"), p["m"])
    (y ** 2).sum().backward()
    return [y, x.grad, stage.lin.weight.grad.T, stage.lin.bias.grad]


@case
def pipeline_raises(mesh, p):
    """The messages of the ValueErrors (None where none was raised): more
    stages than ranks, a batch that does not split, a stage that changes
    its input's shape (raised on every rank, after the schedule)."""
    from liteattention_torch.parallel import pipeline_apply, pipeline_apply_local

    n = mesh.size()
    w, b, x = torch.zeros(n + 1, 4, 4), torch.zeros(n + 1, 4), torch.zeros(8, 4)
    calls = [
        lambda: pipeline_apply(_stage, (w, b), x, mesh, "sp"),
        lambda: pipeline_apply(_stage, (w[:n], b[:n]), x[:7], mesh, "sp", num_microbatches=2),
        lambda: pipeline_apply_local(lambda prm, h: torch.cat([h, h], -1), None,
                                     x.requires_grad_(), mesh.get_group("sp"), 2),
    ]
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


# --------------------------------------------------------- data parallel


def _tiny_gpt(p):
    from liteattention_torch.models.gpt import GPTConfig, GPTLMHeadModel

    cfg = GPTConfig(**{**p["cfg"], "dtype": torch.float32})
    model = GPTLMHeadModel(cfg, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in p["init"].items()})
    return model


def _gpt_loss(model, batch):
    from liteattention_torch.models.gpt import gpt_loss_fn

    return gpt_loss_fn(model, batch, batch)


def _trainer(mesh, p, **kw):
    from liteattention_torch.training.trainer import TrainConfig, Trainer

    model = _tiny_gpt(p)
    cfg = TrainConfig(**p["train"], **p.get("options", {}), **kw)
    return model, Trainer(model, _gpt_loss, cfg, device="cpu", mesh=mesh, dp_dim="sp")


@case
def trainer(mesh, p):
    """The Trainer over the group on the global batches: each step's loss,
    grad norm and per-module grad norms, the final parameters, and each
    AdamW state tensor's shape on this rank."""
    model, tr = _trainer(mesh, p, norm_monitor=True)
    recs = []
    tr.fit(iter(p["batches"]), len(p["batches"]), log_every=1, log_fn=recs.append)
    shapes = {n: tuple(tr.opt.state[tr._opt_params[n]]["exp_avg"].shape)
              for n in tr._params}
    return {"loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
            "grad_norms": [r["grad_norms"] for r in recs], "state_shapes": shapes,
            "params": {k: v.detach() for k, v in model.state_dict().items()}}


@case
def trainer_checkpoint(mesh, p):
    """ZeRO-2 with checkpoints: after the batches, rank 0 has written the
    whole state; a fresh trainer resumes it (its slices equal the first
    trainer's), and both take one more step on ``p["next"]``."""
    model, tr = _trainer(mesh, p, checkpoint_dir=p["dir"], checkpoint_every=len(p["batches"]))
    tr.fit(iter(p["batches"]), len(p["batches"]))
    model2, tr2 = _trainer(mesh, p, checkpoint_dir=p["dir"], checkpoint_every=100)
    step = tr2.restore_or_init()
    same = all(torch.equal(tr.opt.state[tr._opt_params[n]][k],
                           tr2.opt.state[tr2._opt_params[n]][k])
               for n in tr._params for k in ("exp_avg", "exp_avg_sq"))
    same = same and all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                          model2.parameters()))
    nxt = _t(p["next"])
    losses = [float(t.train_step(nxt)["loss"]) for t in (tr, tr2)]
    return {"step": step, "same_state": same, "losses": losses,
            "params": {k: v.detach() for k, v in model2.state_dict().items()}}


@case
def train_cli(mesh, p):
    """``liteattention_torch.train.run`` with ``run.data_parallel=true``
    under the group already set up: the metric records and the final
    parameters."""
    from liteattention_torch import train

    recs = []
    trainer_ = train.run(p["argv"], log_fn=recs.append)
    return {"recs": [{k: r[k] for k in ("step", "loss", "grad_norm")} for r in recs],
            "world": trainer_.world, "zero": bool(trainer_.shard_dims),
            "comm_dtype": str(trainer_.comm_dtype),
            "params": {k: v.detach() for k, v in trainer_.model.state_dict().items()}}


# ------------------------------------------------------ tensor parallel


def _backward(out, cot):
    (out * cot).sum().backward()


@case
def tp_grads(mesh, p):
    """The six tensor-parallel functions, each with the loss sum(out * cot)
    over the whole output: each rank's output and its gradients (of its
    shards, and of the tensors every rank holds alike)."""
    from liteattention_torch.parallel import tensor_parallel as tpm
    from liteattention_torch.parallel._collectives import copy_to_group, shard_dim

    g = mesh.get_group("sp")
    r, n = _rank(mesh), g.size()

    def leaf(x):
        return x.detach().clone().requires_grad_()

    x, w, b = _t(p["x"]), _t(p["w"]).T, _t(p["b"])  # w [out, in]
    emb, pos, ids = _t(p["emb"]), _t(p["pos"]), _t(p["ids"])
    cot_out, cot_in = _t(p["cot_out"]), _t(p["cot_in"])  # [B, S, out], [B, S, in]
    out = {}

    xr, wl, bl = leaf(x), leaf(tpm.shard_rows(w, r, n)), leaf(tpm.shard_rows(b, r, n))
    y = tpm.column_parallel_dense(copy_to_group(xr, g), wl, bl)
    _backward(y, shard_dim(cot_out, 2, g))
    out["column"] = [y, xr.grad, wl.grad, bl.grad]

    xs, wl = leaf(shard_dim(x, 1, g)), leaf(tpm.shard_rows(w, r, n))
    y = tpm.column_parallel_dense(xs, wl, gather_input_group=g)
    _backward(y, shard_dim(cot_out, 2, g))
    out["column_gather"] = [y, xs.grad, wl.grad]

    w2 = tpm.shard_cols(_t(p["w2"]).T, r, n)  # this rank's input columns of [out, in]
    for name, scatter in (("row", False), ("row_scatter", True)):
        xl, wl, bb = leaf(shard_dim(_t(p["h"]), 2, g)), leaf(w2), leaf(_t(p["b2"]))
        y = tpm.row_parallel_dense(xl, wl, bb, group=g, scatter_output=scatter)
        _backward(y, shard_dim(cot_in, 1, g) if scatter else cot_in)
        out[name] = [y, xl.grad, wl.grad, bb.grad]

    el = leaf(tpm.shard_rows(emb, r, n))
    y = tpm.vocab_parallel_embedding(ids, el, g)
    _backward(y, cot_in)
    out["vocab_embedding"] = [y, el.grad]

    el = leaf(tpm.shard_cols(emb, r, n))
    y = tpm.column_parallel_embedding(ids, el)
    _backward(y, shard_dim(cot_in, 2, g))
    out["column_embedding"] = [y, el.grad]

    for name, sp in (("gpt2_embeddings", False), ("gpt2_embeddings_sp", True)):
        el, pl = leaf(tpm.shard_rows(emb, r, n)), leaf(tpm.shard_cols(pos, r, n))
        y = tpm.parallel_gpt2_embeddings(ids, el, pl, group=g, sequence_parallel=sp)
        _backward(y, shard_dim(cot_in, 1, g) if sp else cot_in)
        out[name] = [y, el.grad, pl.grad]

    xr, el = leaf(x), leaf(tpm.shard_rows(emb, r, n))
    y = tpm.vocab_parallel_logits(copy_to_group(xr, g), el)
    _backward(y, shard_dim(_t(p["cot_vocab"]), 2, g))
    out["vocab_logits"] = [y, xr.grad, el.grad]
    return out


@case
def parallel_modules_grads(mesh, p):
    """ParallelMHA and ParallelMLP sharded from single-device modules, the
    loss sum(out * cot): x's gradient and every parameter's."""
    from liteattention_torch.models.convert import state_dict_from_flax
    from liteattention_torch.modules import MHA, Mlp, ParallelMHA, ParallelMLP
    from liteattention_torch.modules.mha import parallel_mha_state_dict
    from liteattention_torch.modules.mlp import parallel_mlp_state_dict

    g = mesh.get_group("sp")
    r, n = _rank(mesh), g.size()
    f32 = dict(dtype=torch.float32, device="cpu")
    cot = _t(p["cot"])
    one = MHA(p["dim"], p["heads"], causal=True, **f32)
    one.load_state_dict({k: _t(v) for k, v in state_dict_from_flax(p["mha_one"]).items()})
    mha = ParallelMHA(p["dim"], p["heads"], g, causal=True, **f32)
    mha.load_state_dict(parallel_mha_state_dict(one.state_dict(), p["heads"], r, n))
    mlp_one = Mlp(p["dim"], p["hidden"], activation=torch.relu, **f32)
    mlp_one.load_state_dict({k: _t(v) for k, v in p["mlp_one"].items()})
    mlp = ParallelMLP(p["dim"], p["hidden"], g, activation=torch.relu, bias1=True, bias2=True,
                      **f32)
    mlp.load_state_dict(parallel_mlp_state_dict(mlp_one.state_dict(), r, n))
    out = {}
    for name, module in (("mha", mha), ("mlp", mlp)):
        x = _t(p["x"]).requires_grad_()
        _backward(module(x), cot)
        out[name] = {"x": x.grad, **{k: v.grad for k, v in module.named_parameters()}}
    return out


@case
def gpt_tp_grads(mesh, p):
    """gpt_tp_apply with parallel_cross_entropy_loss (label smoothing, the
    z-loss and an ignored label): the loss and the gradient of each of
    this rank's parameters."""
    from liteattention_torch.losses import parallel_cross_entropy_loss
    from liteattention_torch.models.gpt import (
        GPTConfig,
        gpt_state_dict_from_jax,
        gpt_tp_apply,
        gpt_tp_state_dict,
    )

    g = mesh.get_group("sp")
    cfg = GPTConfig(**{**p["cfg"], "dtype": torch.float32})
    sd = {k: _t(v) for k, v in gpt_state_dict_from_jax(p["params"]).items()}
    shard = {k: v.clone().requires_grad_()
             for k, v in gpt_tp_state_dict(cfg, sd, _rank(mesh), g.size()).items()}
    ids, labels = _t(p["ids"]).long(), _t(p["labels"]).long()
    loss = parallel_cross_entropy_loss(gpt_tp_apply(cfg, shard, ids, g), labels, g, **p["ce"])
    loss.backward()
    return {"loss": loss, "grads": {k: v.grad for k, v in shard.items()}}


@case
def parallel_ce(mesh, p):
    """parallel_cross_entropy_loss on this rank's vocab slice of the logits,
    for each option set: the loss and this rank's logits gradient."""
    from liteattention_torch.losses import parallel_cross_entropy_loss
    from liteattention_torch.parallel._collectives import shard_dim

    g = mesh.get_group("sp")
    out = []
    for kw in p["options"]:
        lg = shard_dim(_t(p["logits"]), -1, g).clone().requires_grad_()
        loss = parallel_cross_entropy_loss(lg, _t(p["labels"]).long(), g, **kw)
        (loss.sum() if loss.dim() else loss).backward()
        out.append([loss, lg.grad])
    return out


@case
def moe_sharded(mesh, p):
    """moe_apply_sharded at the given capacity (None: from the local token
    count), the loss sum(y^2) + 0.01 aux: y, aux and the parameters' and
    x's gradients (whole on every rank)."""
    from liteattention_torch.modules.moe import moe_apply_sharded

    params = {k: _t(v).requires_grad_() for k, v in p["params"].items()}
    x = _t(p["x"]).requires_grad_()
    y, aux = moe_apply_sharded(params, x, mesh, "sp", top_k=2, capacity=p["capacity"])
    ((y ** 2).sum() + 0.01 * aux).backward()
    return {"y": y, "aux": aux, "x": x.grad, **{k: v.grad for k, v in params.items()}}


@case
def moe_data_parallel(mesh, p):
    """moe_forward on this rank's slice of the tokens, routed over the
    group as one device routes them all (the data-parallel routing), the
    loss sum(y^2) + 0.01 aux: y (gathered), the aux averaged over the
    ranks, and the parameters' gradients summed over them."""
    import torch.distributed as dist

    from liteattention_torch.modules.moe import moe_forward
    from liteattention_torch.parallel._collectives import gather_dim, shard_dim

    g, n = mesh.get_group("sp"), mesh.size()
    params = {k: _t(v).requires_grad_() for k, v in p["params"].items()}
    y, aux = moe_forward(params, shard_dim(_t(p["x"]), 0, g), top_k=2,
                         capacity_factor=p["capacity_factor"], group=g)
    ((y ** 2).sum() + 0.01 * aux / n).backward()
    grads = {k: v.grad for k, v in params.items()}
    for v in grads.values():
        dist.all_reduce(v, group=g)
    aux = aux.detach()
    dist.all_reduce(aux, group=g)
    return {"y": gather_dim(y.detach(), 0, g), "aux": aux / n, **grads}
