#!/usr/bin/env python3
"""Smoke run of the PyTorch port (liteattention_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: the card's name and power limit (nvidia-smi), then the build
   of every kernel from ``liteattention_torch/ops/csrc`` (one nvcc per
   source, in parallel).
2. Kernels against their plain PyTorch versions on the card, bf16: the
   dense forward (B1), the schedule packer (B2) and the sparse forward
   with votes (B3) at moderate shapes and at the Wan slice's shapes; the
   causal B1 and the backward kernels B7a (dQ) and B7b (dK/dV) at the
   GPT-2 small shape (8 x 12 x 1024 x 64) and at Sq 1000 / Sk 640, D 128,
   8 q-heads on 2 kv-heads (bottom-right offset, rows with no key, ragged
   tails, GQA); B7 is held by rel-L2 over each tensor and over every
   128-row block. Times of each kernel beside its plain version, its
   bound and SDPA's flash kernels where one call computes the same
   function (aten's flash backward for the B7 pair).
3. The denoising slice: the Wan2.1-14B DiT (full width, depth cut to 2
   blocks, random weights from a seed) denoising a 480p 81-frame latent
   (21 x 60 x 104 -> 32 760 tokens) with CFG, 4 steps, vote_stride 2,
   three ways: (a) dense, (b) lite from a full mask at threshold -inf,
   which must match (a), (c) lite from banded ~50% masks and a
   thresholded run. The launch counters of B1-B3 must move. A small model
   is also checked on the card against the plain versions on the CPU.
4. The training slice: a small GPT (head dims 64 and 128) whose loss
   and gradients on the card are held against the same step through the
   plain versions on the CPU; then the training entry point
   (``liteattention_torch.train``) trains GPT-2 small (124M, full width
   and depth, random weights from a seed) for 10 AdamW steps on one
   repeated synthetic batch of 8 x 1024 tokens. The counters must show
   12 launches per step of each of causal B1, B7a and B7b, and the loss
   must stay finite and fall. Then ms/step, tokens/s and the attention
   share (torch.profiler).
5. A JSON line of kernel results, the nvidia-smi line, and the result
   line ``{"ok": true, "device": {...}}``.

It needs nothing but the repository, PyTorch built for CUDA and nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Tolerances (bf16 kernels against fp32 plain versions on the same inputs).
# Max abs error of attention outputs (bf16 rounding of O and P); causal
# rows with few keys reach |out| ~ |v|, so there the error over max(1, |plain|).
OUT_TOL = 2e-2
LSE_TOL = 1e-3  # max abs error of lse (fp32, approximate exp2)
MARGIN = 1e-3  # votes may differ only where |headroom - thr| is below this
SLICE_AB_TOL = 1e-2  # rel-L2 of (b) lite-at-thr=-inf against (a) dense
SMALL_FWD_TOL = 2e-2  # rel-L2 of a small bf16 model forward on the card vs fp32 CPU
SMALL_DENOISE_TOL = 5e-2  # same for a 3-step CFG denoise (CFG amplifies error)
# B7: rel-L2 of each of dq, dk, dv over the whole tensor, and over every
# (b, h, 128-row block), so that one wrong tile cannot hide (bf16 grads,
# P and dS rounded to bf16 before their products).
BWD_TOL = 1e-2
BWD_BLOCK_TOL = 2e-2
SMALL_LOSS_TOL = 1e-2  # small GPT, bf16 card vs fp32 CPU: relative loss error
SMALL_GRAD_TOL = 5e-2  # ... and rel-L2 of each parameter's gradient
# The 480p Wan latent for 81 frames; depth of the 14B model cut for time.
SLICE_GRID = (21, 60, 104)
SLICE_LAYERS = 2
# GPT-2 small training: batch x sequence, steps of the counted run.
GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 10
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    """Least time (ms) for the work: the larger of flops at the bf16 peak
    and bytes at the HBM rate, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attn_pairs(sq, sk, causal):
    """(q row, key) pairs the attention must compute for one (b, h)."""
    if not causal:
        return sq * sk
    return sum(min(max(row + sk - sq + 1, 0), sk) for row in range(sq))


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def block_rel_l2(got, ref, rows=128):
    """rel-L2 of ``got`` against ``ref`` ([B, H, S, D]) over the whole
    tensor and the worst over (b, h, ``rows``-row block); a block whose
    reference is 0 must be 0 too."""
    import torch

    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % rows)
    g = torch.nn.functional.pad(got.double(), pad).reshape(b, h, -1, rows * d)
    r = torch.nn.functional.pad(ref.double(), pad).reshape(b, h, -1, rows * d)
    num, den = (g - r).norm(dim=-1), r.norm(dim=-1)
    blk = torch.where(den > 0, num / den.clamp_min(1e-300), num * math.inf).nan_to_num(0.0)
    return rel_l2(got, ref), blk.max().item()


def banded_mask(b, h, qt, kt, sparsity, device):
    """Diagonal band of live tiles at ~``sparsity`` (the shape evolved
    video masks converge to), first tile always live."""
    import torch

    width = max(1, int(round((1.0 - sparsity) * kt)))
    center = (torch.arange(qt) * (kt - 1)) // max(qt - 1, 1)
    start = (center - width // 2).clamp(0, kt - width)
    kpos = torch.arange(kt)[None, :]
    keep = (kpos >= start[:, None]) & (kpos < start[:, None] + width)
    keep[:, 0] = True
    return keep.expand(b, h, qt, kt).contiguous().to(device)


# ---------------------------------------------------------------- phase 2


def sdpa_ms(q, k, v, causal, dout=None):
    """SDPA's flash backend on the same inputs: the forward, or with
    ``dout`` forward + backward through autograd."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        if dout is None:
            return cuda_ms(lambda: sdpa(q, k, v, is_causal=causal))
        return fwd_bwd_ms(lambda a, b, c: sdpa(a, b, c, is_causal=causal), q, k, v, dout)


def fwd_bwd_ms(fn, q, k, v, dout):
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    return cuda_ms(lambda: fn(qg, kg, vg).backward(dout))


def check_flash(q, k, v, label, causal=False, time_it=False):
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain

    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ro, rl = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    diff = (out.float() - ro.float()).abs()
    err_o = diff.max().item()
    # Causal rows with few keys give |out| up to |v|: bf16 rounds it to
    # 2^-8 relative, so there the bound scales with the value.
    err_chk = (diff / ro.float().abs().clamp_min(1.0)).max().item() if causal else err_o
    fin = torch.isfinite(rl)
    check(torch.equal(fin, torch.isfinite(lse)), f"B1 {label}: lse -inf rows differ")
    err_l = (lse[fin] - rl[fin]).abs().max().item()
    msg = f"  B1 {label}: max|out| err {err_o:.3e}, max|lse| err {err_l:.3e}"
    if not fin.all():
        check(out[~fin].abs().max().item() == 0.0, f"B1 {label}: a row with no key is not 0")
        msg += f", {int((~fin).sum())} rows with no valid key (out 0, lse -inf)"
    log(msg)
    check(err_chk < OUT_TOL and err_l < LSE_TOL, f"B1 {label} disagrees")
    res = {"err": err_o}
    if time_it:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        res["ms"] = cuda_ms(lambda: flash_attention(q, k, v, causal=causal))
        res["plain_ms"] = cuda_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal), reps=1
        )
        res["bound_ms"], res["bound_by"] = bound(
            4 * d * attn_pairs(sq, sk, causal) * b * h, nbytes(q, k, v, out, lse)
        )
        # SDPA aligns causal masks top-left: comparable only when Sq == Sk.
        same = k.shape[1] == h and (sq == sk or not causal)
        res["library_ms"] = sdpa_ms(q, k, v, causal) if same else None
        lib = "n/a" if res["library_ms"] is None else f"{res['library_ms']:.3f} ms"
        log(f"  B1 {label}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.3f} ms ({res['bound_by']}), SDPA flash {lib}")
    return res


def sdpa_bwd(q, k, v, dout, causal):
    """aten's flash-attention backward on ``q, k, v, dout`` (from its own
    forward's out and lse): dq, dk, dv in one call."""
    import torch

    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, off, _ = aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False
    )
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        dout, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal, seed, off
    )


def check_bwd(q, k, v, dout, label, causal, time_it=False):
    """B7a/B7b against their plain versions on the forward kernel's
    out / lse (the inputs the training path gives them)."""
    import torch
    from liteattention_torch.ops.flash_bwd import (
        flash_bwd_dkv,
        flash_bwd_dkv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )
    from liteattention_torch.ops.flash_fwd import flash_attention

    b, h, sq, d = q.shape
    sk, scale = k.shape[2], d**-0.5
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (out.float() * dout.float()).sum(-1)
    args = (q, k, v, dout, lse, delta, scale, causal)
    dq = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    rq = flash_bwd_dq_plain(*args)
    rk, rv = flash_bwd_dkv_plain(*args)
    errs, rels = {}, {}
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[name] = (got.float() - ref.float()).abs().max().item()
        rels[name] = block_rel_l2(got, ref)
    check(torch.equal(dk, flash_bwd_dkv(*args)[0]), f"B7 {label}: dK not bit-stable")
    log(f"  B7 {label}: rel-L2 tensor / worst (b, h, 128-row block): "
        + ", ".join(f"{n} {t:.2e} / {w:.2e}" for n, (t, w) in rels.items())
        + "; max abs err " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + " (bit-stable over two runs)")
    for name, (tensor, block) in rels.items():
        check(tensor < BWD_TOL and block < BWD_BLOCK_TOL,
              f"B7 {label}: {name} rel-L2 {tensor:.3e} / block {block:.3e}")
    res = {
        "flash_bwd_dq": {"err": errs["dq"], "rel_l2": rels["dq"][0],
                         "worst_block_rel_l2": rels["dq"][1]},
        "flash_bwd_dkv": {"err": max(errs["dk"], errs["dv"]),
                          "rel_l2": max(rels["dk"][0], rels["dv"][0]),
                          "worst_block_rel_l2": max(rels["dk"][1], rels["dv"][1])},
    }
    if time_it:
        pairs = attn_pairs(sq, sk, causal) * b * h
        ins = nbytes(q, k, v, dout, lse, delta)
        rq_ = res["flash_bwd_dq"]
        rq_["ms"] = cuda_ms(lambda: flash_bwd_dq(*args), reps=20)
        rq_["plain_ms"] = cuda_ms(lambda: flash_bwd_dq_plain(*args), reps=1)
        rq_["bound_ms"], rq_["bound_by"] = bound(6 * d * pairs, ins + nbytes(dq))
        rk_ = res["flash_bwd_dkv"]
        rk_["ms"] = cuda_ms(lambda: flash_bwd_dkv(*args), reps=20)
        rk_["plain_ms"] = cuda_ms(lambda: flash_bwd_dkv_plain(*args), reps=1)
        rk_["bound_ms"], rk_["bound_by"] = bound(8 * d * pairs, ins + nbytes(dk, dv))

        def pair():  # the backward as the autograd Function runs it
            dl = (out.float() * dout.float()).sum(-1)
            flash_bwd_dq(q, k, v, dout, lse, dl, scale, causal)
            flash_bwd_dkv(q, k, v, dout, lse, dl, scale, causal)

        pair_ms = cuda_ms(pair, reps=20)
        # No PyTorch call computes dQ alone or dK/dV alone: aten's flash
        # backward computes the three together, and is the library time of
        # both, beside the port's delta + B7a + B7b.
        lib = lib_err = None
        if k.shape[1] == h and sq == sk:
            lib_fn = sdpa_bwd(q, k, v, dout, causal)
            lib = cuda_ms(lib_fn, reps=20)
            lib_err = max(rel_l2(x, r) for x, r in zip(lib_fn(), (rq, rk, rv)))
        for r in (rq_, rk_):
            r["library_ms"] = lib
            r["library_covers"] = "dq, dk and dv in one call (aten flash backward)"
            r["pair_ms"] = pair_ms
        ours = fwd_bwd_ms(
            lambda a, b_, c: flash_attention(a, b_, c, causal=causal), q, k, v, dout
        )
        sdpa_fb = sdpa_ms(q, k, v, causal, dout) if lib is not None else None
        res["fwd_bwd"] = {"ms": ours, "sdpa_ms": sdpa_fb}
        for name, r in (("B7a dQ", rq_), ("B7b dK/dV", rk_)):
            log(f"  {name} {label}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
        na = lambda x, f: "n/a" if x is None else f.format(x)  # noqa: E731
        log(f"  B7 pair {label}: delta + B7a + B7b {pair_ms:.3f} ms; aten flash backward "
            f"{na(lib, '{:.3f} ms')} (its grads vs plain rel-L2 {na(lib_err, '{:.2e}')})")
        log(f"  B1+B7 {label}: forward + backward through autograd {ours:.3f} ms; "
            f"SDPA flash {na(sdpa_fb, '{:.3f} ms')}")
    return res


def check_pack(m, label, time_it=False):
    import torch
    from liteattention_torch.ops.schedule_pack import pack_schedule, pack_schedule_plain

    fidx, count = pack_schedule(m)
    torch.cuda.synchronize()
    rf, rc = pack_schedule_plain(m)
    same = torch.equal(fidx, rf) and torch.equal(count, rc)
    log(f"  B2 {label} {tuple(m.shape)}: exact {same}")
    check(same, f"B2 {label} disagrees")
    res = {"err": 0.0}
    if time_it:
        res["ms"] = cuda_ms(lambda: pack_schedule(m), reps=20)
        res["plain_ms"] = cuda_ms(lambda: pack_schedule_plain(m), reps=5)
        res["bound_ms"], res["bound_by"] = bound(0, nbytes(m, fidx, count))
        res["library_ms"] = None
        log(f"  B2 {label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.5f} ms ({res['bound_by']})")
    return res


def check_lite(q, k, v, m, label, time_it=False):
    import torch
    from liteattention_torch.ops.lite_flash_fwd import (
        lite_flash_attention,
        lite_flash_attention_plain,
        vote_headroom,
    )
    from liteattention_torch.ops.schedule_pack import pack_schedule_plain

    fidx, count = pack_schedule_plain(m)
    kt = m.shape[-1]
    head = vote_headroom(q, k, fidx, count)
    valid = torch.arange(kt, device=m.device) < count[..., None]
    # A threshold at which about half of the visited tiles vote skip.
    thr = head[valid & torch.isfinite(head)].float().median().item()
    ro, rl, rv = lite_flash_attention_plain(q, k, v, fidx, count, thr, m)
    torch.cuda.synchronize()
    margin = torch.where(valid, (head - thr).abs(), torch.full_like(head, math.inf))
    fine_margin = torch.full(m.shape, math.inf, device=m.device)
    fine_margin.scatter_reduce_(-1, fidx.long(), margin, reduce="amin")
    near = int((fine_margin < MARGIN).sum())
    err = 0.0
    for emit in (True, False):
        out, lse, votes = lite_flash_attention(
            q, k, v, fidx, count, thr, m, emit_votes=emit
        )
        torch.cuda.synchronize()
        err_o = (out.float() - ro.float()).abs().max().item()
        fin = torch.isfinite(rl)
        check(torch.equal(fin, torch.isfinite(lse)), f"B3 {label}: lse -inf rows differ")
        err_l = (lse[fin] - rl[fin]).abs().max().item()
        err = max(err, err_o)
        msg = f"  B3 {label} emit_votes={emit}: max|out| err {err_o:.3e}, max|lse| err {err_l:.3e}"
        check(err_o < OUT_TOL and err_l < LSE_TOL, f"B3 {label} disagrees")
        if emit:
            diff = votes != rv
            bad = int((diff & (fine_margin >= MARGIN)).sum())
            msg += (
                f", votes differ at {int(diff.sum())} tiles ({near} tiles within "
                f"{MARGIN} of thr), {bad} outside the margin, skip share "
                f"{rv[m].float().mean().item():.3f}"
            )
            check(bad == 0, f"B3 {label}: votes disagree outside the margin")
        else:
            check(votes is None, "B3: emit_votes=False returned votes")
        log(msg)
    res = {"err": err}
    if time_it:
        res["ms"] = cuda_ms(lambda: lite_flash_attention(q, k, v, fidx, count, thr, m))
        res["ms_novote"] = cuda_ms(
            lambda: lite_flash_attention(q, k, v, fidx, count, thr, m, emit_votes=False)
        )
        res["plain_ms"] = cuda_ms(
            lambda: lite_flash_attention_plain(q, k, v, fidx, count, thr, m), reps=1
        )
        # Work of this mask: the live tiles' (row, key) pairs.
        b, h, sq, d = q.shape
        sk = k.shape[2]
        rows = (sq - torch.arange(m.shape[2], device=m.device) * 128).clamp(max=128)
        cols = (sk - torch.arange(m.shape[3], device=m.device) * 128).clamp(max=128)
        live = int((m.long() * rows[:, None] * cols[None, :]).sum())
        votes_bytes = 4 * m.numel()  # int32 fine votes
        res["bound_ms"], res["bound_by"] = bound(
            4 * d * live, nbytes(q, k, v, out, lse, fidx, count, m) + votes_bytes
        )
        res["library_ms"] = None
        log(
            f"  B3 {label}: kernel {res['ms']:.3f} ms (no votes "
            f"{res['ms_novote']:.3f} ms), plain {res['plain_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.3f} ms ({res['bound_by']}), "
            f"sparsity {1 - m.float().mean().item():.3f}"
        )
    return res


def kernel_phase(dev, cfg, n_tok):
    import torch

    g = torch.Generator(device=dev).manual_seed(1234)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    res = {}
    # Moderate shapes: B=1, H=4, Sq=Sk=3000 (ragged), D=128; cross Sk=512.
    q, k, v = rnd(1, 4, 3000, 128), rnd(1, 4, 3000, 128), rnd(1, 4, 3000, 128)
    check_flash(q, k, v, "self 1x4x3000x128")
    check_flash(q, rnd(1, 4, 512, 128), rnd(1, 4, 512, 128), "cross Sk=512")
    kt = math.ceil(3000 / 128)
    rand_m = torch.rand(1, 4, kt, kt, generator=g, device=dev) < 0.5
    rand_m[0, 2, 5] = False  # a row with no live tile
    check_pack(rand_m, "random")
    check_pack(banded_mask(1, 4, kt, kt, 0.5, dev), "banded")
    rand_m[..., 0] = True
    check_lite(q, k, v, rand_m, "random 1x4x3000x128")
    check_lite(q, k, v, banded_mask(1, 4, kt, kt, 0.5, dev), "banded 1x4x3000x128")
    del q, k, v

    # The slice's shapes: self-attention 1 x 40 x 32760 x 128, text
    # cross-attention against 512 tokens, masks [1, 40, 256, 256].
    h, d = cfg.num_heads, cfg.head_dim
    q, k, v = rnd(1, h, n_tok, d), rnd(1, h, n_tok, d), rnd(1, h, n_tok, d)
    res["flash_fwd"] = check_flash(q, k, v, f"self 1x{h}x{n_tok}x{d}", time_it=True)
    res["flash_fwd_cross"] = check_flash(
        q, rnd(1, h, cfg.text_len, d), rnd(1, h, cfg.text_len, d),
        f"cross 1x{h}x{n_tok}x{d} Sk={cfg.text_len}", time_it=True,
    )
    kt = math.ceil(n_tok / 128)
    band = banded_mask(1, h, kt, kt, 0.5, dev)
    res["schedule_pack"] = check_pack(band, "banded slice", time_it=True)
    res["lite_flash_fwd"] = check_lite(
        q, k, v, band, f"banded-50% 1x{h}x{n_tok}x{d}", time_it=True
    )
    return res


def gpt_kernel_phase(dev):
    """Causal B1 and B7 at the GPT-2 small shape (timed) and at a shape
    with a bottom-right offset, rows with no key, ragged tails and GQA."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4321)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    b, h, s, d = GPT_BATCH, 12, GPT_SEQ, 64
    q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
    label = f"causal {b}x{h}x{s}x{d}"
    res = {"flash_fwd_causal": check_flash(q, k, v, label, causal=True, time_it=True)}
    res.update(check_bwd(q, k, v, do, label, causal=True, time_it=True))
    q, do = rnd(1, 8, 1000, 128), rnd(1, 8, 1000, 128)
    k, v = rnd(1, 2, 640, 128), rnd(1, 2, 640, 128)
    for causal in (True, False):
        label = f"{'causal' if causal else 'dense'} Sq 1000 Sk 640 D 128, 8 on 2 heads"
        res["flash_fwd_causal"]["err"] = max(
            res["flash_fwd_causal"]["err"], check_flash(q, k, v, label, causal=causal)["err"]
        )
        for name, r in check_bwd(q, k, v, do, label, causal=causal).items():
            for key, val in r.items():
                res[name][key] = max(res[name][key], val)
    return res


# ---------------------------------------------------------------- phase 3


def small_model_check(dev):
    """A small bf16 model on the card against the same weights in fp32
    through the plain versions on the CPU."""
    import torch
    from liteattention_torch.models import WanConfig, WanModel, denoise
    from liteattention_torch.ops.mask import SkipMaskState

    cfg32 = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32)
    cpu = WanModel(cfg32, device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(5))
    gpu = WanModel(WanConfig.tiny(), device=dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    lat = torch.randn(1, 7, 20, 20, 16, generator=g)
    text = torch.randn(1, 16, 64, generator=g)
    null = torch.randn(1, 16, 64, generator=g)
    tt = torch.full((1,), 700.0)
    with torch.no_grad():
        ref, _ = cpu(lat, tt, text)
        out, _ = gpu(lat.to(dev), tt.to(dev), text.to(dev))
        e_dense = rel_l2(out.float().cpu(), ref)
        band = banded_mask(1, 2, 6, 6, 0.5, "cpu")
        st_c = {i: SkipMaskState(band, 0) for i in range(2)}
        st_g = {i: SkipMaskState(band.to(dev), 0) for i in range(2)}
        ref, _ = cpu(lat, tt, text, st_c, -math.inf)
        out, _ = gpu(lat.to(dev), tt.to(dev), text.to(dev), st_g, -math.inf)
        e_lite = rel_l2(out.float().cpu(), ref)
    thr = [-math.inf] * 3
    xr, _ = denoise(cpu, lat, text, null, num_steps=3, thresholds=thr, vote_stride=2,
                    initial_states=dict(st_c), initial_states_uncond=dict(st_c))
    xg, _ = denoise(gpu, lat.to(dev).bfloat16(), text.to(dev), null.to(dev),
                    num_steps=3, thresholds=thr, vote_stride=2,
                    initial_states=dict(st_g), initial_states_uncond=dict(st_g))
    e_den = rel_l2(xg.float().cpu(), xr)
    log(
        f"  small model (dim 128, 2x64 heads, 700 tokens), bf16 card vs fp32 CPU "
        f"rel-L2: dense fwd {e_dense:.3e}, lite fwd {e_lite:.3e}, "
        f"3-step CFG denoise {e_den:.3e}"
    )
    check(e_dense < SMALL_FWD_TOL and e_lite < SMALL_FWD_TOL, "small model forward disagrees")
    check(e_den < SMALL_DENOISE_TOL, "small model denoise disagrees")


def slice_phase(dev, card, full, grid):
    import torch
    from liteattention_torch.models import WanModel, denoise
    from liteattention_torch.ops.flash_fwd import flash_attention
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
    from liteattention_torch.ops.mask import SkipMaskState
    from liteattention_torch.ops.schedule_pack import pack_schedule

    small_model_check(dev)

    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS)
    log(f"  Wan2.1-14B width: dim {cfg.dim}, {cfg.num_heads} heads x {cfg.head_dim}, "
        f"ffn {cfg.ffn_dim}, text {cfg.text_len}x{cfg.text_dim}; depth cut "
        f"{full.num_layers} -> {cfg.num_layers} blocks (time)")
    model = WanModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(1)
    frames, hh, ww = grid
    noise = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev)
    noise = noise.to(torch.bfloat16)
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    n_tok = frames * (hh // 2) * (ww // 2)
    kt = math.ceil(n_tok / 128)
    log(f"  latent {frames}x{hh}x{ww} -> {n_tok} tokens, {n_tok / 128:.1f} fine tiles")
    steps = 4
    common = dict(num_steps=steps, guidance_scale=5.0, vote_stride=2)

    def run(label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, tel = denoise(model, noise, text, null, **common, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        sp = [round(float(s), 4) for s in tel["sparsity_per_step"]]
        finite = bool(torch.isfinite(x).all())
        log(f"  ({label}) {ms:.1f} ms/step, sparsity per step {sp}, finite {finite} "
            f"[{card}]")
        check(finite and x.shape == noise.shape, f"slice run ({label}) bad output")
        return x, sp, ms

    # Warm-up (cuBLAS handles, kernel library load) outside the counted run.
    denoise(model, noise, text, null, num_steps=1, enable_skipping=False)
    for fn in (flash_attention, pack_schedule, lite_flash_attention):
        fn.launches = 0
    xa, _, ms_a = run("a: dense", enable_skipping=False)
    xb, sp_b, ms_b = run("b: lite, full mask, thr -inf", thresholds=[-math.inf] * steps)
    e_ab = rel_l2(xb.float(), xa.float())
    log(f"  (b) vs (a) rel-L2 {e_ab:.3e} (tolerance {SLICE_AB_TOL})")
    check(e_ab < SLICE_AB_TOL and max(sp_b) == 0.0, "(b) does not match (a)")

    band = banded_mask(1, cfg.num_heads, kt, kt, 0.5, dev)
    band_sparsity = 1.0 - band.float().mean().item()
    states = {i: SkipMaskState(band, 0) for i in range(cfg.num_layers)}
    _, sp_c1, ms_c1 = run(
        f"c1: lite, banded masks at {band_sparsity:.3f}, thr -10",
        thresholds=[-10.0] * steps, initial_states=dict(states),
        initial_states_uncond=dict(states),
    )
    check(sp_c1[0] >= band_sparsity - 1e-6, "banded run lost its sparsity")
    _, sp_c2, ms_c2 = run("c2: lite, thresholds 0, 0, 1, 1", thresholds=[0.0, 0.0, 1.0, 1.0])
    check(all(a <= b for a, b in zip(sp_c2, sp_c2[1:])), "sparsity not monotone")
    launches = {
        "flash_fwd": flash_attention.launches,
        "schedule_pack": pack_schedule.launches,
        "lite_flash_fwd": lite_flash_attention.launches,
    }
    log(f"  launches during the slice: {launches}")
    check(all(n > 0 for n in launches.values()), "a kernel of the path never launched")
    log(f"  ms/step [{card}]: (a) {ms_a:.1f}, (b) {ms_b:.1f}, (c1) {ms_c1:.1f}, "
        f"(c2) {ms_c2:.1f}")
    return launches


# ---------------------------------------------------------------- phase 4


def small_gpt_check(dev):
    """One training step of a small GPT (head dims 64 and 128) on the card
    (bf16, the kernels) against the same step on the CPU (fp32, the plain
    versions), from the same weights."""
    import torch
    from liteattention_torch.models.gpt import GPTConfig, GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.ops.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from liteattention_torch.ops.flash_fwd import flash_attention

    counters = (flash_attention, flash_bwd_dq, flash_bwd_dkv)
    for heads in (4, 2):
        cfg = GPTConfig(vocab_size=512, max_position_embeddings=512, dim=256,
                        num_layers=2, num_heads=heads)
        cpu = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
        cpu.reset_parameters(torch.Generator().manual_seed(7))
        gpu = GPTLMHeadModel(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        ids = torch.randint(0, 512, (2, 300), generator=torch.Generator().manual_seed(8))
        n0 = [fn.launches for fn in counters]
        ref = gpt_loss_fn(cpu, ids, ids)
        ref.backward()
        ids = ids.to(dev)
        loss = gpt_loss_fn(gpu, ids, ids)
        loss.backward()
        torch.cuda.synchronize()
        check([fn.launches - n for fn, n in zip(counters, n0)] == [2, 2, 2],
              "small GPT: the kernels did not run")
        e_loss = abs(loss.item() - ref.item()) / abs(ref.item())
        grads = {n: p.grad for n, p in cpu.named_parameters()}
        e_grad = {n: rel_l2(p.grad.float().cpu(), grads[n]) for n, p in gpu.named_parameters()}
        worst = max(e_grad, key=e_grad.get)
        log(f"  small GPT (dim 256, 2 layers, {heads} heads of {256 // heads}, 2 x 300 "
            f"tokens), bf16 card vs fp32 CPU: loss {loss.item():.5f} vs {ref.item():.5f} "
            f"(rel {e_loss:.2e}), worst grad rel-L2 {e_grad[worst]:.2e} ({worst})")
        check(e_loss < SMALL_LOSS_TOL, "small GPT loss disagrees")
        check(e_grad[worst] < SMALL_GRAD_TOL, "small GPT gradients disagree")


def train_phase(dev, card):
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from liteattention_torch import train as train_cli
    from liteattention_torch.models.configs import gpt2_config
    from liteattention_torch.ops.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from liteattention_torch.ops.flash_fwd import flash_attention
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
    from liteattention_torch.ops.schedule_pack import pack_schedule
    from liteattention_torch.training import synthetic_lm_batches

    small_gpt_check(dev)

    cfg = gpt2_config()
    # The entry point a user calls, at GPT-2 small's full width and depth.
    argv = ["--model", "gpt2", "--dim", str(cfg.dim), "--layers", str(cfg.num_layers),
            "--heads", str(cfg.num_heads), "--vocab", str(cfg.vocab_size),
            "--seqlen", str(GPT_SEQ), "--batch-size", str(GPT_BATCH),
            "--steps", str(GPT_STEPS), "--lr", "6e-4", "--overfit-batch",
            "--log-every", "1", "--device", "cuda"]
    log(f"  python -m liteattention_torch.train {' '.join(argv)}")
    log(f"  GPT-2 small: dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} heads x "
        f"{cfg.dim // cfg.num_heads}, vocab {cfg.vocab_size} (fp32 master, bf16 compute); "
        f"batch {GPT_BATCH} x {GPT_SEQ}, one repeated synthetic batch, {GPT_STEPS} AdamW steps")
    tokens = GPT_BATCH * GPT_SEQ
    counters = {
        "flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
        "flash_bwd_dkv": flash_bwd_dkv, "schedule_pack": pack_schedule,
        "lite_flash_fwd": lite_flash_attention,
    }
    recs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    trainer = train_cli.run(argv, log_fn=recs.append)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches during the training run: {launches}")
    want = cfg.num_layers * GPT_STEPS
    check(all(launches[n] == want for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"training: expected {want} launches of each of B1, B7a, B7b")
    losses = [r["loss"] for r in recs]
    log(f"  loss per step: {[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses), "training loss is not finite")
    check(losses[-1] < losses[0], "training loss does not fall")
    step_ms = [1e3 / r["steps_per_s"] for r in recs]
    ms = statistics.median(step_ms[2:])  # steps 3.. (after allocator warm-up)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  ms/step {ms:.2f} (median of steps 3-{GPT_STEPS}; first two "
        f"{step_ms[0]:.1f}, {step_ms[1]:.1f}), {tokens / ms * 1e3:.0f} tokens/s, "
        f"peak memory {peak_gb:.2f} GB [{card}]")

    n_params = sum(p.numel() for p in trainer.model.parameters())
    # Where the device time goes: two more steps under torch.profiler.
    batch = next(synthetic_lm_batches(cfg.vocab_size, GPT_BATCH, GPT_SEQ))  # the CLI's batch
    x = torch.as_tensor(batch, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            trainer.train_step(x)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: CPU-op rows and annotated ranges (Optimizer.step)
    # carry the device time of the kernels inside them too.
    kern = {
        e.key: e.self_device_time_total / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    }
    busy = sum(kern.values())
    attn = sum(t for k, t in kern.items() if "attention_fwd_kernel" in k or "flash_bwd" in k)
    # Model FLOPs of a step: 6 N per token for the matmuls with the
    # parameters, 6 L S d per token for causal attention (half of 12 L S d).
    flops = 6 * n_params * tokens + 6 * cfg.num_layers * GPT_SEQ * cfg.dim * tokens
    stats = {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3, "peak_gb": peak_gb,
             "model_tflops": flops / ms / 1e9, "model_flops_share_of_peak": flops / ms * 1e3 / PEAK_BF16}
    log(f"  model FLOPs {flops / 1e12:.2f} TFLOP/step -> {stats['model_tflops']:.1f} TFLOP/s, "
        f"{stats['model_flops_share_of_peak']:.1%} of the 989 TFLOP/s bf16 peak")
    if busy > 0:
        stats["attention_share"] = attn / busy
        stats["busy_share"] = busy / 2 / ms  # against the unprofiled step time
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
        log(f"  profiler, 2 steps: wall {wall_ms:.1f} ms (profiler on), device busy "
            f"{busy:.1f} ms = {busy / 2 / ms:.1%} of the unprofiled {ms:.2f} ms/step; "
            f"attention kernels {attn:.1f} ms ({attn / busy:.1%} of busy)")
        for name, t in top:
            log(f"    {t:8.2f} ms  {name[:100]}")
    else:
        log("  profiler: no device time recorded; attention share not measured")

    return {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}, stats


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from liteattention_torch.models import WanConfig
        from liteattention_torch.ops import _build
    except ImportError as e:
        print(f"FAIL: the liteattention_torch package is missing: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = nvidia_smi_line()
        log(f"phase 1: device {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        build = _build.build_kernels()
        log(f"  kernels built in {build.seconds:.1f} s -> {build.path.relative_to(ROOT)}")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
        dev = torch.device("cuda", 0)
        cfg = WanConfig()
        frames, hh, ww = SLICE_GRID
        n_tok = frames * (hh // cfg.patch_size[1]) * (ww // cfg.patch_size[2])
        log("phase 2: kernels against their plain versions (bf16)")
        kres = kernel_phase(dev, cfg, n_tok)
        kres.update(gpt_kernel_phase(dev))
        log("phase 3: Wan2.1-14B-width denoising slice")
        wan_launches = slice_phase(dev, card, cfg, SLICE_GRID)
        log("phase 4: GPT-2 small training slice")
        gpt_launches, train_stats = train_phase(dev, card)
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # flash_fwd's own numbers are the Wan shape's; the causal ones (both
    # GPT shapes for the error) sit under causal_gpt2.
    causal = kres["flash_fwd_causal"]
    kres["flash_fwd"]["causal_gpt2"] = {
        "max_abs_err": causal["err"],
        **{k: causal[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    kres["flash_bwd_dq"]["fwd_bwd"] = kres["fwd_bwd"]
    launches = {
        "flash_fwd": wan_launches["flash_fwd"] + gpt_launches["flash_fwd"],
        "schedule_pack": wan_launches["schedule_pack"],
        "lite_flash_fwd": wan_launches["lite_flash_fwd"],
        "flash_bwd_dq": gpt_launches["flash_bwd_dq"],
        "flash_bwd_dkv": gpt_launches["flash_bwd_dkv"],
    }
    by_path = {
        name: {"wan_denoise": wan_launches.get(name, 0), "gpt2_train": gpt_launches.get(name, 0)}
        for name in launches
    }
    sources = {
        "flash_fwd": ("flash_fwd.cu", "liteattention_tpu/ops/flash_fwd.py:84"),
        "schedule_pack": ("schedule_pack.cu", "liteattention_tpu/ops/schedule_pack.py:52"),
        "lite_flash_fwd": ("lite_flash_fwd.cu", "liteattention_tpu/ops/lite_flash_fwd.py:376"),
        "flash_bwd_dq": ("flash_bwd.cu", "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_bwd_dkv": ("flash_bwd.cu", "liteattention_tpu/ops/flash_bwd.py:238"),
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (src, replaces) in sources.items():
        r = kres[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"liteattention_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["err"],
            **{k: r[k] for k in keys},
            "launches_by_path": by_path[name],
        }
        entry.update({k: v for k, v in r.items() if k not in keys and k != "err"})
        kernels.append(entry)
    log(f"training: {json.dumps(train_stats)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
