"""Training entry point of the port (counterpart of the root ``train.py``).

A flat CLI: model config -> :class:`~liteattention_torch.training.trainer.Trainer`
-> synthetic or memmap token batches -> JSON metric records. It runs on
the card (``cuda``) unless ``--device cpu`` is given.

  python -m liteattention_torch.train --model gpt2 --dim 768 --layers 12 \\
      --heads 12 --vocab 50257 --seqlen 1024 --batch-size 8 --steps 100
  python -m liteattention_torch.train --device cpu --dim 128 --layers 2 \\
      --heads 2 --vocab 512 --seqlen 128 --batch-size 2 --steps 4 --log-every 1

Not ported yet: ``--model llama`` (needs rotary positions,
``layers/rotary.py``) and ``--config`` (needs ``training/config_tree.py``).
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from liteattention_torch.models.configs import gpt2_config
from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
from liteattention_torch.training.data import memmap_lm_batches, synthetic_lm_batches
from liteattention_torch.training.logging import JsonlLogger, TeeLogger
from liteattention_torch.training.trainer import TrainConfig, Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="YAML config tree (not ported yet)")
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
    ap.add_argument("--data", default=None,
                    help="token memmap file (uint16) to train on; default: synthetic batches")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append metric records to this JSONL file")
    ap.add_argument("--overfit-batch", action="store_true",
                    help="train on the first batch at every step (the loss must fall)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None, log_fn=None) -> Trainer:
    """Train as the command line says and return the trainer. Metric
    records go to ``log_fn`` when given (else they are printed), and to
    ``--metrics-jsonl`` too."""
    args = parse_args(argv)
    if args.config:
        raise NotImplementedError("--config: training/config_tree.py is not ported yet")
    if args.model == "llama":
        raise NotImplementedError("--model llama: rotary positions (layers/rotary.py) are not ported yet")
    device = torch.device(args.device)
    cfg = gpt2_config(dim=args.dim, num_layers=args.layers, num_heads=args.heads,
                      vocab=args.vocab, max_pos=max(args.seqlen, 1024))
    model = GPTLMHeadModel(cfg, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {args.model} {n_params / 1e6:.1f}M params on {device}")

    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, checkpoint_dir=args.ckpt_dir)
    trainer = Trainer(model, lambda m, batch: gpt_loss_fn(m, batch, batch), tcfg,
                      device=device)
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
    jsonl = JsonlLogger(args.metrics_jsonl) if args.metrics_jsonl else None
    sinks = [s for s in (log_fn, jsonl) if s is not None]
    try:
        step = trainer.fit(batches, num_steps=args.steps, log_every=args.log_every,
                           tokens_per_batch=args.batch_size * args.seqlen,
                           log_fn=TeeLogger(*sinks, printer=log_fn is None))
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
