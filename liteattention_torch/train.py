"""Training entry point of the port (counterpart of the root ``train.py``).

A flat CLI, or the config tree: model config ->
:class:`~liteattention_torch.training.trainer.Trainer` -> synthetic or
memmap token batches -> JSON metric records. It runs on the card
(``cuda``) unless ``--device cpu`` is given.

  python -m liteattention_torch.train --model gpt2 --dim 768 --layers 12 \\
      --heads 12 --vocab 50257 --seqlen 1024 --batch-size 8 --steps 100
  python -m liteattention_torch.train --device cpu --dim 128 --layers 2 \\
      --heads 2 --vocab 512 --seqlen 128 --batch-size 2 --steps 4 --log-every 1

``--model llama`` trains the LLaMA geometry (rotary, RMSNorm, SwiGLU)
of ``models/configs.py:llama_config``.

``--config configs/config.yaml`` composes the YAML tree
(``training/config_tree.py``) and reads the positional arguments as its
overrides (``group=name``, ``key.path=value``, ``+key=value``, ``~key``),
as the root ``train.py`` does: ``model.*`` (family, dim, num_layers,
num_heads, vocab, moe_experts) and ``run.*`` (steps, batch_size, seqlen,
data, metrics_jsonl) take the place of the flags (a key the tree holds
wins over its flag, null included), and the optimizer and
trainer groups fill ``TrainConfig`` (``learning_rate`` is ``--lr``,
``checkpoint_dir`` ``--ckpt-dir``, ``warmup_steps`` defaults to a tenth of
the steps; ``shard_opt_state``, ``shard_grads`` and ``grad_comm_dtype``
among them).

  python -m liteattention_torch.train --config configs/config.yaml \\
      experiment=gpt2s-moe run.steps=20 --device cpu

``run.data_parallel=true`` (or ``--data-parallel``) trains data-parallel
over every rank of the default process group: the one already set up,
else one set up from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) over ``--dist-backend`` (``nccl``, the default, one card a
rank; ``gloo`` also takes two ranks on one card, which NCCL refuses). Each
rank builds the same model from the same seed and takes its slice of
each global batch (``training/trainer.py``); a world of one rank trains
as without the option, as in JAX.

  python -m torch.distributed.run --nproc_per_node 2 -m liteattention_torch.train \\
      --config configs/config.yaml experiment=gpt2s-moe run.data_parallel=true \\
      trainer.shard_grads=true --dist-backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json

import os

import numpy as np
import torch
import torch.distributed as dist

from liteattention_torch.models.configs import gpt2_config, llama_config
from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
from liteattention_torch.training.data import memmap_lm_batches, synthetic_lm_batches
from liteattention_torch.training.config_tree import load_config, to_flat_kwargs
from liteattention_torch.training.logging import JsonlLogger, TeeLogger
from liteattention_torch.training.trainer import TrainConfig, Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="YAML config tree root (configs/config.yaml); positional arguments "
                         "become its overrides")
    ap.add_argument("overrides", nargs="*",
                    help="with --config: group=name / key.path=value / +key=value / ~key")
    ap.add_argument("--model", choices=["gpt2", "llama"], default="gpt2")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-parallel", action="store_true",
                    help="data parallelism over the default process group's ranks")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default="nccl",
                    help="with --data-parallel, the backend of a process group set up from "
                         "torchrun's environment")
    ap.add_argument("--data", default=None,
                    help="token memmap file (uint16) to train on; default: synthetic batches")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append metric records to this JSONL file")
    ap.add_argument("--overfit-batch", action="store_true",
                    help="train on the first batch at every step (the loss must fall)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def apply_config_tree(args):
    """Compose ``args.config`` with ``args.overrides`` and set ``args``' model
    and run fields from the tree, as the root ``train.py`` does; returns the
    ``TrainConfig`` keyword arguments of the optimizer and trainer groups
    (less ``learning_rate`` and ``checkpoint_dir``, which go to ``args``) and
    the expert count. The composed tree is ``args.config_tree``."""
    tree = load_config(args.config, args.overrides)
    args.config_tree = tree
    m, r = tree.get("model") or {}, tree.get("run") or {}
    args.model = m.get("family", args.model)
    args.dim = m.get("dim", args.dim)
    args.layers = m.get("num_layers", args.layers)
    args.heads = m.get("num_heads", args.heads)
    args.vocab = m.get("vocab", args.vocab)
    args.steps = r.get("steps", args.steps)
    args.batch_size = r.get("batch_size", args.batch_size)
    args.seqlen = r.get("seqlen", args.seqlen)
    args.data = r.get("data", args.data)
    args.metrics_jsonl = r.get("metrics_jsonl", args.metrics_jsonl)
    args.data_parallel = r.get("data_parallel", args.data_parallel)
    if args.model not in ("gpt2", "llama"):
        raise ValueError(f"model.family {args.model!r}: gpt2 or llama")
    fields = [f.name for f in dataclasses.fields(TrainConfig)]
    kwargs = {**to_flat_kwargs(tree.get("optimizer"), fields),
              **to_flat_kwargs(tree.get("trainer"), fields)}
    args.lr = kwargs.pop("learning_rate", args.lr)
    args.ckpt_dir = kwargs.pop("checkpoint_dir", args.ckpt_dir)
    return kwargs, m.get("moe_experts", 0)


def data_parallel_mesh(device: torch.device, backend: str):
    """``(mesh, device)``: the ``("dp",)`` mesh over every rank of the
    default process group (set up from torchrun's environment over
    ``backend`` when none is), and this rank's device; no mesh for a world
    of one rank. A failed setup raises."""
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"data parallelism: no process group is set up and the "
                               f"torchrun environment lacks {missing}")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method="env://")
    world = dist.get_world_size()
    print(f"data parallel over {world} rank(s) ({dist.get_backend()})")
    if world == 1:
        return None, device
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device.type, list(range(world)), mesh_dim_names=("dp",)), device


def run(argv=None, log_fn=None) -> Trainer:
    """Train as the command line says and return the trainer. Metric
    records go to ``log_fn`` when given (else they are printed), and to
    ``--metrics-jsonl`` too."""
    args = parse_args(argv)
    tcfg_kwargs, moe_experts = {}, 0
    if args.config:
        tcfg_kwargs, moe_experts = apply_config_tree(args)
        print(f"config tree: {json.dumps(args.config_tree, sort_keys=True)}")
    elif args.overrides:
        raise SystemExit(f"overrides without --config: {args.overrides}")
    device = torch.device(args.device)
    mesh = None
    if args.data_parallel:
        mesh, device = data_parallel_mesh(device, args.dist_backend)
    if args.model == "gpt2":
        cfg = gpt2_config(dim=args.dim, num_layers=args.layers, num_heads=args.heads,
                          vocab=args.vocab, max_pos=max(args.seqlen, 1024))
    else:
        cfg = llama_config(dim=args.dim, num_layers=args.layers, num_heads=args.heads,
                           vocab=args.vocab)
    if moe_experts:
        cfg = dataclasses.replace(cfg, moe_experts=moe_experts)
    model = GPTLMHeadModel(cfg, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {args.model} {n_params / 1e6:.1f}M params on {device}")

    tcfg = TrainConfig(learning_rate=args.lr,
                       warmup_steps=tcfg_kwargs.pop("warmup_steps", max(args.steps // 10, 1)),
                       total_steps=args.steps, checkpoint_dir=args.ckpt_dir, **tcfg_kwargs)
    trainer = Trainer(model, lambda m, batch: gpt_loss_fn(m, batch, batch), tcfg,
                      device=device, mesh=mesh)
    start = trainer.restore_or_init()
    if start:
        print(f"resumed at step {start}")
    if args.data:
        tokens = np.memmap(args.data, dtype=np.uint16, mode="r")
        batches = memmap_lm_batches(tokens, args.batch_size, args.seqlen)
        print(f"data: {args.data} ({len(tokens) / 1e6:.1f}M tokens)")
    else:
        batches = synthetic_lm_batches(cfg.vocab_size, args.batch_size, args.seqlen)
    if args.overfit_batch:
        batches = itertools.repeat(next(batches))
    # Under data parallelism every rank logs the same records; rank 0 writes them.
    lead = trainer.rank == 0
    jsonl = JsonlLogger(args.metrics_jsonl) if args.metrics_jsonl and lead else None
    sinks = [s for s in (log_fn, jsonl) if s is not None]
    try:
        step = trainer.fit(batches, num_steps=args.steps, log_every=args.log_every,
                           tokens_per_batch=args.batch_size * args.seqlen,
                           log_fn=TeeLogger(*sinks, printer=log_fn is None and lead))
    finally:
        if jsonl is not None:
            jsonl.close()
    print(f"done at step {step}")
    return trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
