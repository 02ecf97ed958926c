#!/usr/bin/env python3
"""How far bf16 rounding alone moves OPT-1.3B's gradients at the shape of
``chip_smoke.py``'s phase 23 (b), on one NVIDIA GPU and its host.

    python3 tp_grad_witness.py

Builds the dense OPT-1.3B of phase 23 (b) (the same seeds: full width and
depth, 2 x 1024 tokens), takes its gradients in bf16 on the card (B1 and
B7) and in fp32 on the host (the plain versions) from the same weights,
and prints their rel-L2: over every parameter, and over rank 0's shards at
tp 2 taken together as (b) takes them (``chip_smoke.tp_grad_apart``). (b)
holds the tensor-parallel model's shards against the dense bf16 model's
within ``chip_smoke.SMALL_GRAD_TOL``; this reading says how much of that
gap one bf16 model already has against exact arithmetic. Writes the card
and the readings to ``chiprun_out/tp_grad_witness.json``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from liteattention_torch.losses import cross_entropy_loss
    from liteattention_torch.models import GPTLMHeadModel, opt_config
    from liteattention_torch.models.gpt import gpt_tp_state_dict
    from liteattention_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    _build.build_kernels()
    dev = torch.device("cuda", 0)
    cfg = opt_config(**cs.OPT_KW)
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(cs.TP_TRAIN_SEED))
    ids = torch.randint(0, cfg.vocab_size, (cs.TP_TRAIN_BATCH, cs.TP_TRAIN_SEQ), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(cs.TP_TRAIN_SEED + 1))
    loss = cross_entropy_loss(model(ids)[:, :-1], ids[:, 1:])
    loss.backward()
    bf16 = {k: p.grad.float().cpu() for k, p in model.named_parameters()}
    t0 = time.perf_counter()
    host = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    host.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    del model
    ids = ids.cpu()
    host_loss = cross_entropy_loss(host(ids)[:, :-1], ids[:, 1:])
    host_loss.backward()
    fp32 = {k: p.grad for k, p in host.named_parameters()}
    host_s = time.perf_counter() - t0
    every = cs.rel_l2(torch.cat([bf16[k].flatten() for k in fp32]),
                      torch.cat([v.flatten() for v in fp32.values()]))
    errs, shards = cs.tp_grad_apart(gpt_tp_state_dict(cfg, bf16, 0, 2),
                                    gpt_tp_state_dict(cfg, fp32, 0, 2))
    worst = max(errs.items(), key=lambda kv: kv[1])
    out = {"card": card, "loss_bf16": float(loss), "loss_fp32": float(host_loss),
           "grad_rel_l2_every_parameter": every, "grad_rel_l2_rank0_shards_at_tp2": shards,
           "worst_shard": list(worst), "host_fp32_s": host_s}
    print(f"OPT-1.3B, {cs.TP_TRAIN_BATCH} x {cs.TP_TRAIN_SEQ} tokens, dense bf16 on the card "
          f"against fp32 on the host ({host_s:.1f} s): loss {out['loss_bf16']:.5f} against "
          f"{out['loss_fp32']:.5f}; gradients rel-L2 {every:.3e} over every parameter, "
          f"{shards:.3e} over rank 0's shards at tp 2 (worst {worst[1]:.3e}, {worst[0]}) "
          f"[{card}]", flush=True)
    root = ROOT / "chiprun_out"
    root.mkdir(exist_ok=True)
    (root / "tp_grad_witness.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
