"""End-to-end Wan-geometry denoising on the card: lite against dense.

The port of ``examples/wan_e2e_speed.py``. Wan2.1-14B block geometry
(dim 5120, 40 heads x 128, ffn 13824, umT5 text) at the reference's
headline token count (73 728 = 18 frames x 64 x 64 latent patches),
depth cut to a few blocks and steps; random weights from ``--seed``.

Attention's share of the FLOPs at this geometry (per block, N tokens):
self-attention 4 * 5120 * N^2 against ~4.4e8 * N for the linears, 77 % at
N = 73 728; the script prints it for its geometry.

Random weights give near-uniform attention, so the organic threshold
sweep (``--modes thr``) jumps from 0 to high sparsity with scattered
masks. The forced-band ablation (``--modes band``) pins every layer's
mask to a diagonal band, the structure converged video attention takes,
at the reference ablation's five sparsity points, with a frozen
threshold: the sparsity -> ms/step curve at the real geometry. Each run
is timed by CUDA events after a synchronize, after one warm-up run.
Writes a JSON artifact (default under the git-ignored ``runs/``; the
repository's ``E2E_ABLATION.json`` of the JAX package is refused).

Usage: python examples/torch_wan_e2e_speed.py [--layers 2] [--steps 4]
         [--modes thr,band] [--device cuda] [--out PATH]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from liteattention_torch.device import resolve_device  # noqa: E402
from liteattention_torch.models.pipeline import denoise  # noqa: E402
from liteattention_torch.models.wan import WanConfig, WanModel, init_skip_states  # noqa: E402

DEFAULT_OUT = os.path.join("runs", "torch_wan_e2e_speed.json")
THRESHOLDS = [-10.0, -3.0, 0.1, 0.5, 1.0, 2.0]
BAND_SPARSITY = [0.0, 0.21, 0.42, 0.57, 0.77]


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


def banded_mask(b, h, qt, kt, sparsity, device):
    """A diagonal band of live tiles at about ``sparsity``, the first tile
    of each row live."""
    width = max(1, int(round((1.0 - sparsity) * kt)))
    center = (torch.arange(qt) * (kt - 1)) // max(qt - 1, 1)
    start = (center - width // 2).clamp(0, kt - width)
    kpos = torch.arange(kt)[None, :]
    keep = (kpos >= start[:, None]) & (kpos < start[:, None] + width)
    keep[:, 0] = True
    return keep.expand(b, h, qt, kt).contiguous().to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frames", type=int, default=18)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--vote-stride", type=int, default=4)
    ap.add_argument("--modes", default="thr,band",
                    help="comma list: thr (organic threshold sweep), band (forced banded masks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap.parse_args(argv)


def main(argv=None):
    """Run the script; returns the artifact it wrote."""
    args = parse_args(argv)
    if os.path.basename(args.out) == "E2E_ABLATION.json":
        raise SystemExit("refusing to overwrite E2E_ABLATION.json: it records the JAX package's run")
    modes = set(args.modes.split(","))
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(WanConfig(), num_layers=args.layers)
    model = WanModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(args.seed))
    model.requires_grad_(False)
    b, f, hh, ww = 1, args.frames, args.height, args.width
    pt, ph, pw = cfg.patch_size
    tokens = (f // pt) * (hh // ph) * (ww // pw)
    print(f"wan geometry: {args.layers} blocks, {tokens} tokens, device {dev}")
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    noise = torch.randn(b, f, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    text = torch.randn(b, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e9:.2f}B")

    def per_step(**kw):
        """A warm-up run, then a timed one: (telemetry, seconds per step,
        the warm-up's seconds)."""
        run = lambda: denoise(model, noise, text, num_steps=args.steps, **kw)  # noqa: E731
        _, first = timed(run, dev)
        (_, tel), s = timed(run, dev)
        return tel, s / args.steps, first

    _, dense_s, first = per_step(enable_skipping=False)
    print(f"dense first run: {first:.1f}s; dense: {dense_s * 1e3:.1f} ms/step")
    attn_core = 4.0 * cfg.dim * tokens * tokens
    linear = 6.0 * tokens * cfg.dim * cfg.dim + 4.0 * tokens * cfg.dim * cfg.ffn_dim
    frac = attn_core / (attn_core + linear)
    print(f"attention FLOP fraction at {tokens} tokens: {frac:.1%}")

    curve = []
    for thr in THRESHOLDS if "thr" in modes else []:
        tel, lite_s, _ = per_step(thresholds=[thr] * args.steps, enable_skipping=True,
                                  vote_stride=args.vote_stride)
        sp = float(tel["final_sparsity"])
        print(f"lite thr={thr}: {lite_s * 1e3:.1f} ms/step, sparsity={sp:.1%}, "
              f"e2e speedup={dense_s / lite_s:.2f}x")
        curve.append(dict(threshold=thr, final_sparsity=sp, ms_per_step=lite_s * 1e3,
                          e2e_speedup=dense_s / lite_s))

    # Forced banded masks at the reference ablation's sparsity points, a
    # frozen threshold (-10 skips nothing new), the votes still computed.
    states0 = init_skip_states(cfg, b, (f, hh, ww), device=dev)
    qt, kt = next(iter(states0.values())).do_mask.shape[-2:]
    banded_curve = []
    for s_target in BAND_SPARSITY if "band" in modes else []:
        m = banded_mask(b, cfg.num_heads, qt, kt, s_target, dev)
        st = {i: s0._replace(do_mask=m) for i, s0 in states0.items()}
        tel, band_s, _ = per_step(thresholds=[-10.0] * args.steps, enable_skipping=True,
                                  initial_states=st, vote_stride=args.vote_stride)
        sp = float(tel["final_sparsity"])
        print(f"banded s={sp:.1%}: {band_s * 1e3:.1f} ms/step, e2e speedup={dense_s / band_s:.2f}x")
        banded_curve.append(dict(sparsity=sp, ms_per_step=band_s * 1e3,
                                 e2e_speedup=dense_s / band_s))

    artifact = {
        "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        "tokens": tokens,
        "layers": args.layers,
        "steps": args.steps,
        "dense_ms_per_step": dense_s * 1e3,
        "vote_stride": args.vote_stride,
        "attention_flop_fraction": frac,
        "threshold_curve": curve,
        "banded_curve": banded_curve,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
