"""Sparsity / quality calibration of the PyTorch port on trained attention.

The port of ``examples/structured_calibration.py``. Random weights give
near-uniform attention, the easiest case for the skip criterion, and no
real Wan weights are in the repository; so this script trains a small
Wan-architecture DiT on synthetic video until its attention has
structure, then calibrates thresholds on it:

  1. Synthetic latent videos: bouncing anisotropic Gaussian blobs with
     per-sample velocities (spatial locality and temporal coherence, the
     structure the skip criterion exploits in real video models).
  2. Rectified-flow training of a small ``WanModel`` (fp32 parameters,
     bf16 products, AdamW with optax's warmup-cosine schedule), with
     optional entropy and tile regularisers read through the model's
     attention probe (``WanConfig.attn_probe_rows``).
  3. ``models.eval.threshold_sweep`` on the trained weights: constant
     thresholds -> (sparsity, rel-L2, flicker, subject consistency, PSNR).
  4. ``models.calibrate.calibrate_schedule``: the loosest schedule within
     the rel-L2 budget, and the sparsity it reaches.

Writes a JSON artifact (default under the git-ignored ``runs/``; the
repository's ``CALIBRATION*.json`` records of the JAX package are refused).

Usage: python examples/torch_structured_calibration.py [--train-steps 3000]
         [--frames 16] [--size 32] [--entropy-reg 0.05 --entropy-target 4.5
         --tile-reg 0.03] [--eval-schedule PATH] [--e2e] [--device cuda]
         [--out PATH]
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from liteattention_torch.device import resolve_device  # noqa: E402
from liteattention_torch.models.calibrate import calibrate_schedule  # noqa: E402
from liteattention_torch.models.eval import (  # noqa: E402
    evaluate_sparsity_quality,
    threshold_sweep,
)
from liteattention_torch.models.pipeline import denoise  # noqa: E402
from liteattention_torch.models.wan import WanConfig, WanModel  # noqa: E402

DEFAULT_OUT = os.path.join("runs", "torch_structured_calibration.json")
SWEEP_THRESHOLDS = [-10.0, -6.0, -4.0, -3.0, -2.0, -1.0, -0.5]


def make_videos(rng: np.random.RandomState, batch, frames, size, channels):
    """Bouncing-blob synthetic latent videos ``[B, F, S, S, C]``."""
    vids = np.zeros((batch, frames, size, size, channels), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(batch):
        for _ in range(rng.randint(2, 5)):
            pos = rng.rand(2) * size
            vel = (rng.rand(2) - 0.5) * size / frames * 2.0
            sig = 1.5 + 3.0 * rng.rand(2)
            amp = rng.randn(channels) * 1.5
            for f in range(frames):
                p = np.abs(np.mod(pos + vel * f, 2 * size) - size)  # reflect off walls
                g = np.exp(-(((yy - p[0]) / sig[0]) ** 2) - (((xx - p[1]) / sig[1]) ** 2))
                vids[i, f] += g[:, :, None] * amp[None, None]
    vids += 0.05 * rng.randn(*vids.shape)
    return vids


def small_config() -> WanConfig:
    """The JAX example's proxy geometry. Its (512, 512) tiles were the
    TPU's; the Hopper kernels take the default 128 x 128, the mask's own
    granularity on both."""
    return WanConfig(
        dim=256, ffn_dim=768, num_heads=4, head_dim=64, num_layers=4,
        in_channels=8, out_channels=8, text_dim=64, text_len=16, freq_dim=64,
        patch_size=(1, 2, 2), dtype=torch.bfloat16,
    )


def warmup_cosine_decay(step: int, peak: float, warmup_steps: int, decay_steps: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)``: linear from 0 to ``peak`` over the warmup, then a
    cosine to 0 over ``decay_steps - warmup_steps`` (decay_steps counts
    the warmup), flat at 0 after it. ``step`` counts updates from 0."""
    if step < warmup_steps:
        return peak * step / warmup_steps
    t = min(step - warmup_steps, decay_steps - warmup_steps)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))


def adamw(model, steps: int, peak_lr: float = 3e-4, warmup_steps: int = 100):
    """optax.adamw(warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    max(warmup_steps + 1, steps)), weight_decay=0.01) in torch: (AdamW,
    its LambdaLR)."""
    opt = torch.optim.AdamW(model.parameters(), lr=peak_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    decay = max(warmup_steps + 1, steps)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: warmup_cosine_decay(s, 1.0, warmup_steps, decay))
    return opt, sched


def flow_loss(model, x0, noise, sig, text, entropy_reg=0.0, entropy_target=5.55, tile_reg=0.0):
    """The rectified-flow objective of one batch: ``x_t = (1 - sig) x0 +
    sig noise`` (bf16), target velocity ``noise - x0``, timestep ``1000
    sig``; plus, through the model's probe, ``entropy_reg`` times the mean
    over layers of the row entropy above ``entropy_target`` and
    ``tile_reg`` times the mean tile excess. Returns (loss, the MSE term,
    the mean probed entropy or 0)."""
    x0f = x0.float()
    xt = ((1.0 - sig) * x0f + sig * noise).to(torch.bfloat16)
    v, _ = model(xt, sig[:, 0, 0, 0, 0] * 1000.0, text[: x0.shape[0]])
    main = ((v.float() - (noise - x0f)) ** 2).mean()
    loss, ent = main, torch.zeros((), device=main.device)
    inter = getattr(model, "intermediates", {}) if model.cfg.attn_probe_rows else {}
    ents = inter.get("attn_entropy", [])
    if ents:
        ent = torch.stack(ents).mean()
        if entropy_reg > 0:
            loss = loss + entropy_reg * torch.stack(
                [(e - entropy_target).clamp_min(0.0) for e in ents]).mean()
    tiles = inter.get("attn_tile_excess", [])
    if tiles and tile_reg > 0:
        loss = loss + tile_reg * torch.stack(tiles).mean()
    return loss, main, ent


def timed(fn, device):
    """(fn's result, seconds): CUDA events after a synchronize on the card
    (the work itself, not its enqueue), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def check_out_path(path):
    name = os.path.basename(path)
    if name == "CALIBRATION.json" or name.startswith("CALIBRATION_R5_"):
        raise SystemExit(f"refusing to overwrite {name}: it records the JAX package's runs")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--eval-steps", type=int, default=24)
    ap.add_argument("--rel-l2-budget", type=float, default=0.05)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # Attention-structure regularisation: under the task loss alone the
    # proxy's attention stays near-uniform, the worst case for skipping;
    # converged video models are strongly localised. Both terms act on
    # the training objective only; every quality number compares sparse
    # and dense runs of the same final weights.
    ap.add_argument("--entropy-reg", type=float, default=0.0)
    ap.add_argument("--entropy-target", type=float, default=5.55,
                    help="target row entropy in nats (~ln(support))")
    ap.add_argument("--tile-reg", type=float, default=0.0)
    ap.add_argument("--probe-rows", type=int, default=64)
    ap.add_argument("--eval-schedule", default=None,
                    help="an artifact whose calibrated schedule is re-evaluated on THIS "
                    "workload (the transfer check)")
    ap.add_argument("--e2e", action="store_true", help="time dense vs calibrated-lite denoising")
    ap.add_argument("--e2e-vote-stride", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None):
    """Run the script; returns the artifact it wrote."""
    args = parse_args(argv)
    check_out_path(args.out)
    dev = resolve_device(args.device)
    cfg = small_config()
    tokens = args.frames * (args.size // 2) ** 2
    print(f"device={dev} tokens={tokens} dim={cfg.dim} layers={cfg.num_layers}")
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    text = torch.zeros(args.batch, cfg.text_len, cfg.text_dim, dtype=torch.bfloat16, device=dev)

    use_probe = args.entropy_reg > 0 or args.tile_reg > 0
    train_cfg = dataclasses.replace(cfg, attn_probe_rows=args.probe_rows) if use_probe else cfg
    model = WanModel(train_cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(args.seed + 1))
    model.float()  # fp32 master weights; the linears compute in bf16
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    opt, sched = adamw(model, args.train_steps)

    t0 = time.time()
    loss0 = loss = ent = None
    for step in range(args.train_steps):
        if step % 50 == 0:
            x0 = torch.from_numpy(
                make_videos(rng, args.batch, args.frames, args.size, cfg.in_channels)
            ).to(dev, torch.bfloat16)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        sig = torch.rand((x0.shape[0], 1, 1, 1, 1), generator=gen, device=dev)
        total, main_loss, ent = flow_loss(model, x0, noise, sig, text, args.entropy_reg,
                                          args.entropy_target, args.tile_reg)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        sched.step()
        loss, ent = main_loss.detach(), ent.detach()
        if step % 100 == 0 or step == args.train_steps - 1:
            lv = float(loss)
            loss0 = lv if loss0 is None else loss0
            print(f"step {step} loss {lv:.4f} entropy {float(ent):.3f} ({time.time() - t0:.0f}s)")
    print(f"train done: loss {loss0:.3f} -> {float(loss):.3f}")

    # --- calibration on the trained (structured) attention ---
    eval_model = WanModel(cfg, device=dev)  # bf16-held copy of the trained weights
    eval_model.load_state_dict(model.state_dict())
    eval_model.requires_grad_(False)
    del model, opt
    eval_noise = torch.randn(
        (1, args.frames, args.size, args.size, cfg.in_channels),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 7), device=dev,
    ).to(torch.bfloat16)
    eval_text = text[:1]
    curve = threshold_sweep(eval_model, eval_noise, eval_text, thresholds_list=SWEEP_THRESHOLDS,
                            num_steps=args.eval_steps)
    for r in curve:
        print(f"thr {r['threshold']:6.1f}: sparsity {r['mean_sparsity']:.3f} "
              f"rel_l2 {r['relative_l2']:.4f} flicker {r['temporal_flicker']:.4f} "
              f"subject {r['subject_consistency_delta']:.5f} psnr {r['psnr_db']:.1f}")

    schedule, cal = calibrate_schedule(eval_model, eval_noise, eval_text,
                                       num_steps=args.eval_steps,
                                       target_rel_l2=args.rel_l2_budget)
    print(f"calibrated schedule (budget rel_l2<={args.rel_l2_budget}): "
          f"thr*={cal['threshold']:.2f} +delta={cal['loosen_delta']:.2f} "
          f"sparsity={cal['mean_sparsity']:.3f} final_sparsity={cal['final_sparsity']:.3f} "
          f"rel_l2={cal['relative_l2']:.4f}" + (f" WARNING: {cal['warning']}"
                                                if "warning" in cal else ""))

    transfer = None
    if args.eval_schedule:
        # Does another workload's calibrated schedule keep sparsity and
        # quality here? Resampled by step fraction if the counts differ.
        with open(args.eval_schedule) as f:
            src_art = json.load(f)
        src_sched = np.asarray(src_art["calibrated"]["schedule"], np.float32)
        if src_sched.shape[0] != args.eval_steps:
            xi = np.linspace(0.0, 1.0, args.eval_steps)
            xs = np.linspace(0.0, 1.0, src_sched.shape[0])
            src_sched = np.interp(xi, xs, src_sched).astype(np.float32)
        tr = evaluate_sparsity_quality(eval_model, eval_noise, eval_text,
                                       num_steps=args.eval_steps,
                                       thresholds=torch.from_numpy(src_sched))
        transfer = {
            "source": args.eval_schedule,
            "source_tokens": src_art["workload"]["tokens"],
            "mean_sparsity": float(tr["mean_sparsity"]),
            "final_sparsity": float(tr["final_sparsity"]),
            "relative_l2": float(tr["relative_l2"]),
            "psnr_db": float(tr["psnr_db"]),
        }
        print(f"transfer({transfer['source_tokens']} tok -> {tokens} tok): "
              f"sparsity={transfer['mean_sparsity']:.3f} rel_l2={transfer['relative_l2']:.4f}")

    e2e = None
    if args.e2e:
        attn_core = 4.0 * cfg.dim * tokens * tokens
        linear = 6.0 * tokens * cfg.dim * cfg.dim + 4.0 * tokens * cfg.dim * cfg.ffn_dim
        frac = attn_core / (attn_core + linear)
        runs = {
            "dense": lambda: denoise(eval_model, eval_noise, eval_text, num_steps=args.eval_steps,
                                     enable_skipping=False),
            "lite": lambda: denoise(eval_model, eval_noise, eval_text, num_steps=args.eval_steps,
                                    thresholds=schedule, enable_skipping=True,
                                    vote_stride=args.e2e_vote_stride),
        }
        per_step = {}
        for name, fn in runs.items():
            fn()  # warm-up: first launches, allocator
            per_step[name] = min(timed(fn, dev)[1] for _ in range(3)) / args.eval_steps
        _, tel = runs["lite"]()
        dense_s, lite_s = per_step["dense"], per_step["lite"]
        e2e = {
            "tokens": tokens,
            "attention_flop_fraction": frac,
            "dense_ms_per_step": dense_s * 1e3,
            "lite_ms_per_step": lite_s * 1e3,
            "e2e_speedup": dense_s / lite_s,
            "vote_stride": args.e2e_vote_stride,
            "final_sparsity": float(tel["final_sparsity"]),
        }
        print(f"organic E2E at {tokens} tok (attn {frac:.0%}): dense {dense_s * 1e3:.1f} -> "
              f"lite {lite_s * 1e3:.1f} ms/step = {dense_s / lite_s:.2f}x at "
              f"{e2e['final_sparsity']:.1%} final sparsity")

    artifact = {
        "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        "workload": {
            "tokens": tokens,
            "frames": args.frames,
            "train_steps": args.train_steps,
            "first_train_loss": loss0,
            "final_train_loss": float(loss),
            "entropy_reg": args.entropy_reg,
            "entropy_target": args.entropy_target,
            "tile_reg": args.tile_reg,
            "final_attn_entropy": float(ent),
            "model": dataclasses.asdict(dataclasses.replace(cfg, dtype=None, block_sizes=None)),
        },
        "curve": [
            {k: float(r[k]) for k in ("threshold", "mean_sparsity", "final_sparsity",
                                      "relative_l2", "temporal_flicker",
                                      "subject_consistency_delta", "psnr_db")}
            for r in curve
        ],
        "calibrated": {
            **{k: float(cal[k]) for k in ("threshold", "loosen_delta", "final_sparsity",
                                          "mean_sparsity", "relative_l2", "temporal_flicker",
                                          "psnr_db")},
            "schedule": [float(x) for x in schedule],
            **({"warning": cal["warning"]} if "warning" in cal else {}),
        },
        "budget_rel_l2": args.rel_l2_budget,
    }
    if transfer is not None:
        artifact["transfer"] = transfer
    if e2e is not None:
        artifact["e2e"] = e2e
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
