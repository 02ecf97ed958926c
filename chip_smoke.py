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
   causal B1 and the one-pass backward B7 (``flash_attention_bwd``: delta,
   one kernel for dQ, dK and dV, dQ to bf16; it serves B7a and B7b) at the
   GPT-2 small shape (8 x 12 x 1024 x 64), at Sq 1000 / Sk 640, D 128,
   8 q-heads on 2 kv-heads (bottom-right offset, rows with no key, ragged
   tails, GQA) and at the Wan2.1-14B attention width (1 x 40 x 8192 x 128,
   non-causal); B7 is held against B7a's and B7b's plain versions by
   rel-L2 over each tensor and over every 128-row block, dK and dV bit for
   bit over two runs. Times of each kernel beside its plain version, its
   bound and SDPA's flash kernels where one call computes the same
   function (aten's flash backward for B7).
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
   12 launches per step of each of causal B1 and B7, and the loss
   must stay finite and fall. Then ms/step, tokens/s and the attention
   share (torch.profiler).
5. The serving slice. First causal B1 at the serving path's prefill and
   verify shapes, and the decode kernel (B8 contiguous, B9a/B9b
   paged) against its plain versions at the kvcache API's shape (batch 8,
   32 q-heads on 8 KV heads, D 128, cache 4096, pages of 256, ragged
   lengths): contiguous bf16 and int8, paged bf16 and int8, head-major
   pools, D 64 / group 1, causal Sq 4 paged; timed beside its bound, its
   plain version and SDPA (``enable_gqa``, uniform full lengths). A small
   LLaMA's card decode is held against the CPU plain path, teacher-forced.
   Then a Llama-3-8B-width server (full width and depth, random weights
   from a seed) answers 8 requests of 1024-token prompts: greedy decoding
   of 64 tokens into a 2048-token cache, the same with the int8 cache,
   batch-1 speculative decoding with a 2-layer draft (lookahead 3, 32
   tokens), and the kvcache API in its four forms plus the head-major
   paged entry. The decode kernel must launch once per layer per decode
   step. Reported: prefill and decode ms, tokens/s, peak memory, the
   decode logits against a full recompute (and that two faults planted
   in the cache read above its limit), int8 against bf16 logits, the
   speculative acceptance, and where a decode step's time goes.
6. The rest of the LiteAttention engine at the Wan2.1-14B attention width
   (40 heads x 128, bf16): (a) ``LiteAttention`` over 1 x 32 768 tokens
   with the back half of the keys pre-skipped (union density 0.5, so the
   K/V compaction gate engages), 4 calls at thr -6 with ``kv_compact``
   True and False, which must agree bit for bit; (b) ``denoise(kv_compact=
   True)`` on the 2-block slice over the 480p 61-frame latent (16 x 60 x
   104 -> 24 960 tokens), CFG, 4 steps, ``vote_stride`` 2, banded initial
   masks, bit-identical to ``kv_compact=False``; (c) ``flash_attn_func``
   at 1 x 32 760 x 40 x 128 with a fine mask (B2 + B3), a coarse mask at
   ``BlockSizes(256, 256)`` (B4) and super-tile bits (B4), each against
   its plain version; (d) ``fold_h=8`` (B5) equal to unfolded B3; (e)
   ``FlashBlocksparseAttention``'s kernel route against the plain exact path and
   ``SeqParallelLiteAttention``'s two merged splits against one call. Then
   B4, B5 and B6 (beside ``index_select``) timed, and B2 / B3 with their
   new channels.
7. MLA at DeepSeek-V3's published widths (128 heads, kv_lora_rank 512 +
   rope 64 = 576 latent channels, v 128; random bf16 inputs from a seed):
   (a) ``flash_mla_with_kvcache`` (kernel B10) for 64 requests of one
   token with ragged cache lengths in 1024-8192 over one layer's pool of
   64-token pages (604 MB), in four cache forms -- contiguous, paged with
   an identity table, paged with a random permutation, and a 640-lane
   contiguous cache, which must equal the 576 one -- each against
   ``mla_decode_plain`` by rel-L2 over the outputs and over each request;
   a causal Sq 2 x Hq 32 step with a request of length 0 (out 0, lse
   -inf); (b) ``flash_attn_func`` at the prefill shape, 2 prompts x 4096
   tokens x 128 heads at (q/k 192, v 128), causal (B1's MLA
   instantiation), against its plain version over all heads, and the
   (576, 512) and (64, 512) + qv shapes at a small size; (c) the two
   kernels' times beside their bounds, plain versions and SDPA (the
   backend that ran is named).
8. A JSON line of kernel results (launches read on each path's counted
   run, every counter set to 0 just before it), the nvidia-smi line, and
   the result line ``{"ok": true, "device": {...}}``.

It needs nothing but the repository, PyTorch built for CUDA and nvcc.

    python3 chip_smoke.py --ab DIR [REPS]

times B1, B3, B8 and the backward B7 of the checkout at DIR instead (see
``ab_times``): to compare two checkouts on one card, run it for each in
turns in one job.
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
# B7 at the Wan2.1-14B attention width: batch, heads, tokens, head dim.
WAN_BWD_SHAPE = (1, 40, 8192, 128)
SMALL_LOSS_TOL = 1e-2  # small GPT, bf16 card vs fp32 CPU: relative loss error
SMALL_GRAD_TOL = 5e-2  # ... and rel-L2 of each parameter's gradient
# The 480p Wan latent for 81 frames; depth of the 14B model cut for time.
SLICE_GRID = (21, 60, 104)
SLICE_LAYERS = 2
# GPT-2 small training: batch x sequence, steps of the counted run.
GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 10
# Serving at Meta-Llama-3-8B's geometry: requests x prompt, new tokens,
# cache capacity, depth; the speculative run; the kvcache API's shape.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_CAPACITY = 8, 1024, 64, 2048
SERVE_LAYERS = 32
SPEC_NEW, SPEC_LOOKAHEAD, SPEC_DRAFT_LAYERS = 32, 3, 2
API_B, API_HQ, API_HK, API_D, API_CACHE, API_PAGE = 8, 32, 8, 128, 4096, 256
# Decode kernel against its plain version: max abs error and rel-L2 of the
# outputs (bf16 output, P rounded to bf16 before PV); lse as LSE_TOL.
DECODE_TOL = 2e-2
DECODE_REL_TOL = 1e-2
# rel-L2 of a small LLaMA's step logits, bf16 card vs fp32 CPU.
SMALL_DECODE_TOL = 3e-2
# rel-L2 of the 8B-width server's incremental-decode logits against a full
# recompute without a cache, both bf16 on the card: they differ only in
# rounding (decode kernel against B1 over the same keys), 1.1e-2 measured
# on an H100. Faults planted in the cache read 3.6e-2 (one K/V row zeroed)
# and 2.2e-1 (every step one position late); the run checks that both
# still read above the limit.
SERVE_RECOMPUTE_TOL = 2e-2
FAULT_STEPS = 8  # decode steps of each planted-fault run
DECODE_KERNELS = ("flash_decode_kernel", "decode_merge_kernel")
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


def device_ms(fn, reps=20, names=()):
    """Device time per call of ``fn`` (after one warm-up call): (every
    CUDA kernel the call launches, those whose name holds one of
    ``names``, the timer). For calls whose host side outlasts their device
    work, where CUDA events would time the host. The timer is
    ``"profiler"`` (torch.profiler). A profile that recorded no device
    time (seen on an H100 under torch 2.11, midway through a run; cause
    not found) is taken again, up to three times; then CUDA events behind
    a busy wait time the whole call (``queued_ms``), the named kernels'
    share is not measured (None) and the timer is ``"queued_events"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = picked = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False
            ):
                total += e.self_device_time_total / 1e3
                picked += e.self_device_time_total / 1e3 if any(n in e.key for n in names) else 0.0
        if total > 0:
            return total / reps, picked / reps, "profiler"
    log("  torch.profiler recorded no device time in 3 tries: CUDA events behind a busy wait")
    return queued_ms(fn, reps), None, "queued_events"


def fmt_ms(ms, digits=4):
    """A time for the log, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def queued_ms(fn, reps):
    """Device time per call of ``fn`` by CUDA events, with the device held
    in a busy wait (~50 ms) while the host enqueues every call, so that
    host time between calls does not count."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
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


def kernel_wrappers():
    """Every kernel entry of the port, by its name in the kernels line: the
    wrapper and the attribute that counts its launches (the lite wrapper
    counts B3, B5 and B4 apart, flash_attention B1 and its MLA
    instantiation); the decode wrappers also count the launches of their
    split-merge kernel."""
    from liteattention_torch.ops.flash_bwd import flash_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_decode
    from liteattention_torch.ops.kv_compact import compact_kv
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
    from liteattention_torch.ops.mla import mla_decode
    from liteattention_torch.ops.paged_attention import paged_attention, paged_attention_folded
    from liteattention_torch.ops.schedule_pack import pack_schedule

    return {"flash_fwd": (flash_attention, "launches"),
            "flash_fwd_mla": (flash_attention, "mla_launches"),
            "schedule_pack": (pack_schedule, "launches"),
            "lite_flash_fwd": (lite_flash_attention, "launches"),
            "lite_flash_fwd_coarse": (lite_flash_attention, "coarse_launches"),
            "lite_flash_fwd_hfold": (lite_flash_attention, "hfold_launches"),
            "kv_compact": (compact_kv, "launches"),
            "flash_bwd_dq": (flash_bwd, "launches"),
            "flash_bwd_dkv": (flash_bwd, "launches"),
            "flash_decode": (flash_attention_decode, "launches"),
            "paged_decode": (paged_attention, "launches"),
            "paged_decode_folded": (paged_attention_folded, "launches"),
            "mla_decode": (mla_decode, "launches")}


def reset_counts():
    """Set every wrapper's launch counts to 0 (just before a path's
    counted run)."""
    for fn, attr in kernel_wrappers().values():
        setattr(fn, attr, 0)
        if hasattr(fn, "merge_launches"):
            fn.merge_launches = 0


def read_counts():
    """Every wrapper's launch count, and the merge launches of those
    that merge (just after a path's counted run)."""
    wrappers = kernel_wrappers()
    return ({name: getattr(fn, attr) for name, (fn, attr) in wrappers.items()},
            {name: fn.merge_launches for name, (fn, _) in wrappers.items()
             if hasattr(fn, "merge_launches")})


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
    """The one-pass backward B7 (``flash_attention_bwd``: delta, the main
    kernel, dQ to bf16) on the forward kernel's out / lse (the inputs the
    training path gives it): dq against B7a's plain version, dk / dv
    against B7b's; dk / dv bit-stable over two runs, dq (summed across CTAs
    by atomics in no fixed order) held by the same rel-L2 again."""
    import torch
    from liteattention_torch.ops.flash_bwd import (
        flash_attention_bwd,
        flash_bwd_dkv_plain,
        flash_bwd_dq_plain,
        flash_bwd_plain,
    )
    from liteattention_torch.ops.flash_fwd import flash_attention

    b, h, sq, d = q.shape
    sk, scale = k.shape[2], d**-0.5
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    args = (q, k, v, out, lse, dout, scale, causal)
    dq, dk, dv = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    delta = (out.float() * dout.float()).sum(-1)
    plain_args = (q, k, v, dout, lse, delta, scale, causal)
    rq = flash_bwd_dq_plain(*plain_args)
    rk, rv = flash_bwd_dkv_plain(*plain_args)
    errs, rels = {}, {}
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[name] = (got.float() - ref.float()).abs().max().item()
        rels[name] = block_rel_l2(got, ref)
    dq2, dk2, dv2 = flash_attention_bwd(*args)
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"B7 {label}: dK/dV not bit-stable")
    rels["dq (2nd run)"] = block_rel_l2(dq2, rq)
    del dq2, dk2, dv2
    log(f"  B7 {label}: rel-L2 tensor / worst (b, h, 128-row block): "
        + ", ".join(f"{n} {t:.2e} / {w:.2e}" for n, (t, w) in rels.items())
        + "; max abs err " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + " (dK, dV bit-stable over two runs)")
    for name, (tensor, block) in rels.items():
        check(tensor < BWD_TOL and block < BWD_BLOCK_TOL,
              f"B7 {label}: {name} rel-L2 {tensor:.3e} / block {block:.3e}")
    res = {
        "flash_bwd_dq": {"err": errs["dq"], "rel_l2": max(rels["dq"][0], rels["dq (2nd run)"][0]),
                         "worst_block_rel_l2": max(rels["dq"][1], rels["dq (2nd run)"][1])},
        "flash_bwd_dkv": {"err": max(errs["dk"], errs["dv"]),
                          "rel_l2": max(rels["dk"][0], rels["dv"][0]),
                          "worst_block_rel_l2": max(rels["dk"][1], rels["dv"][1])},
    }
    if time_it:
        del rq, rk, rv
        # The whole backward (pre + main + post) as the autograd Function
        # runs it; its bound counts the work the inputs need: S, dP, dV, dK
        # and dQ (10 d FLOPs per pair), q, k, v, o, dO, lse read once and
        # dq, dk, dv written once.
        ms = cuda_ms(lambda: flash_attention_bwd(*args), reps=20)
        # Device time of the three launches, and the main kernel's share.
        dev_ms, main_ms, timer = device_ms(lambda: flash_attention_bwd(*args),
                                           names=("flash_bwd_kernel",))
        plain_ms = cuda_ms(lambda: flash_bwd_plain(*args), reps=1)
        bound_ms, bound_by = bound(10 * d * attn_pairs(sq, sk, causal) * b * h,
                                   nbytes(q, k, v, out, dout, lse, dq, dk, dv))
        # aten's flash backward computes dq, dk and dv in one call.
        lib = lib_err = None
        if k.shape[1] == h and sq == sk:
            lib_fn = sdpa_bwd(q, k, v, dout, causal)
            lib = cuda_ms(lib_fn, reps=20)
            lib_err = max(rel_l2(x, r) for x, r in zip(lib_fn(), (dq, dk, dv)))
        for r in res.values():
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib, device_ms=dev_ms, main_kernel_ms=main_ms,
                     timer={"ms": "events", "device_ms": timer, "main_kernel_ms": timer},
                     timed="the whole backward (pre + main + post), "
                     "one kernel for dq, dk and dv",
                     library_covers="dq, dk and dv in one call (aten flash backward)")
        ours = fwd_bwd_ms(
            lambda a, b_, c: flash_attention(a, b_, c, causal=causal), q, k, v, dout
        )
        sdpa_fb = sdpa_ms(q, k, v, causal, dout) if lib is not None else None
        res["fwd_bwd"] = {"ms": ours, "sdpa_ms": sdpa_fb}
        na = lambda x, f: "n/a" if x is None else f.format(x)  # noqa: E731
        log(f"  B7 {label}: backward {ms:.4f} ms (device {dev_ms:.4f} ms, of which the main "
            f"kernel {fmt_ms(main_ms)}, {timer}), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); aten flash backward {na(lib, '{:.4f} ms')} "
            f"(its grads vs ours rel-L2 {na(lib_err, '{:.2e}')})")
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
    """Causal B1 and B7 at the GPT-2 small shape (timed), at a shape with a
    bottom-right offset, rows with no key, ragged tails and GQA, and B7 at
    the Wan2.1-14B attention width (timed)."""
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
    # B7 at the Wan2.1-14B attention width (the gradient of A12's
    # calibration), non-causal: checked and timed.
    b, h, s, d = WAN_BWD_SHAPE
    q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
    wan = check_bwd(q, k, v, do, f"dense {b}x{h}x{s}x{d}", causal=False, time_it=True)
    wan.pop("fwd_bwd")
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
             "main_kernel_ms", "timer")
    for name, r in wan.items():
        res[name]["wan_width"] = {"shape": f"{b}x{h}x{s}x{d} non-causal",
                                  **{key: r[key] for key in timed}}
        for key in ("err", "rel_l2", "worst_block_rel_l2"):
            res[name][key] = max(res[name][key], r[key])
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
    from liteattention_torch.ops.mask import SkipMaskState

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
    reset_counts()
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
    counts = read_counts()
    log(f"  launches during the slice: {counts[0]}; merge launches {counts[1]}")
    check(all(counts[0][n] > 0 for n in ("flash_fwd", "schedule_pack", "lite_flash_fwd")),
          "a kernel of the path never launched")
    log(f"  ms/step [{card}]: (a) {ms_a:.1f}, (b) {ms_b:.1f}, (c1) {ms_c1:.1f}, "
        f"(c2) {ms_c2:.1f}")
    return counts


# ---------------------------------------------------------------- phase 4


def small_gpt_check(dev):
    """One training step of a small GPT (head dims 64 and 128) on the card
    (bf16, the kernels) against the same step on the CPU (fp32, the plain
    versions), from the same weights."""
    import torch
    from liteattention_torch.models.gpt import GPTConfig, GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.ops.flash_bwd import flash_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention

    counters = (flash_attention, flash_bwd)
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
        check([fn.launches - n for fn, n in zip(counters, n0)] == [2, 2],
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
    recs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer = train_cli.run(argv, log_fn=recs.append)
    counts = read_counts()
    launches = counts[0]
    log(f"  launches during the training run: {launches}; merge launches {counts[1]}")
    want = cfg.num_layers * GPT_STEPS
    # B7a and B7b are one kernel now: both names read its launches.
    check(all(launches[n] == want for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"training: expected {want} launches of each of B1 and B7")
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
    attn = sum(t for k, t in kern.items() if "attention_fwd_kernel" in k or "lite::bwd::" in k)
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

    return counts, stats


# ---------------------------------------------------------------- phase 5


def api_inputs(dev, seed=2468):
    """The kvcache API's shape: q, one new K/V row per batch, a contiguous
    [B, S, Hk, D] cache, native and head-major page pools with a shuffled
    page table, ragged lengths (the first full), bf16 and int8."""
    import torch
    from liteattention_torch.ops.kv_quant import quantize_kv_cache, quantize_kv_pages

    g = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hk, d, s, psz = API_B, API_HQ, API_HK, API_D, API_CACHE, API_PAGE

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    n_pages = b * s // psz
    x = {"q": rnd(b, 1, hq, d), "k": rnd(b, 1, hk, d), "v": rnd(b, 1, hk, d),
         "kc": rnd(b, s, hk, d), "vc": rnd(b, s, hk, d),
         "kp": rnd(n_pages, psz, hk, d), "vp": rnd(n_pages, psz, hk, d)}
    x["table"] = torch.randperm(n_pages, generator=g, device=dev).reshape(b, s // psz).int()
    lens = torch.randint(s // 4, s, (b,), generator=g, device=dev).int()
    lens[0] = s - 1  # with the appended row: the whole cache
    x["lens"] = lens
    x["kh"], x["vh"] = (p.permute(2, 0, 1, 3).contiguous() for p in (x["kp"], x["vp"]))
    c8, p8 = quantize_kv_cache(x["kc"], x["vc"]), quantize_kv_pages(x["kp"], x["vp"])
    x.update(kc8=c8.k, vc8=c8.v, ks=c8.k_scale, vs=c8.v_scale,
             kp8=p8.k, vp8=p8.v, kps=p8.k_scale, vps=p8.v_scale)
    return x


def run_api(x):
    """The kvcache API traffic: one decode step in each form, through the
    entry points a server calls (appends in place; int8 forms append with
    the kv_quant helpers first, as the API documents)."""
    from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache
    from liteattention_torch.ops.kv_quant import (
        QuantizedKVCache,
        QuantizedKVPages,
        quantize_kv_append,
        quantize_pages_append,
    )
    from liteattention_torch.ops.paged_attention import paged_attention

    lens = x["lens"]
    out = {"contiguous bf16": flash_attn_with_kvcache(
        x["q"], x["kc"], x["vc"], x["k"], x["v"], cache_seqlens=lens, causal=True)[0]}
    quantize_kv_append(QuantizedKVCache(x["kc8"], x["vc8"], x["ks"], x["vs"]),
                       x["k"], x["v"], lens)
    out["contiguous int8"] = flash_attn_with_kvcache(
        x["q"], x["kc8"], x["vc8"], cache_seqlens=lens + 1, causal=True,
        k_cache_scale=x["ks"], v_cache_scale=x["vs"])
    out["paged bf16"] = flash_attn_with_kvcache(
        x["q"], x["kp"], x["vp"], x["k"], x["v"], cache_seqlens=lens,
        page_table=x["table"], causal=True)[0]
    quantize_pages_append(QuantizedKVPages(x["kp8"], x["vp8"], x["kps"], x["vps"]),
                          x["k"], x["v"], x["table"], lens)
    out["paged int8"] = flash_attn_with_kvcache(
        x["q"], x["kp8"], x["vp8"], cache_seqlens=lens + 1, page_table=x["table"],
        causal=True, k_cache_scale=x["kps"], v_cache_scale=x["vps"])
    # B9a: head-major pools (the same pages as the native pool, before its
    # append), the JAX per-head entry point.
    out["paged head-major bf16"] = paged_attention(
        x["q"][:, 0], x["kh"], x["vh"], lens, x["table"])
    return out


def check_decode(label, fn, plain, args, kw, need, time_it=False, library=None):
    """A decode wrapper against its plain version on the same inputs
    (and, with ``time_it``, its time beside its bound and the plain
    version's). ``need`` = (bytes, flops) this input needs."""
    import torch

    out, lse = fn(*args, **kw)
    torch.cuda.synchronize()
    ro, rl = plain(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ro.float()).abs().max().item()
    rel = rel_l2(out.float(), ro.float())
    fin = torch.isfinite(rl)
    check(torch.equal(fin, torch.isfinite(lse)), f"decode {label}: lse -inf rows differ")
    err_l = (lse[fin] - rl[fin]).abs().max().item() if fin.any() else 0.0
    log(f"  decode {label}: max|out| err {err:.3e}, rel-L2 {rel:.2e}, max|lse| err {err_l:.3e}"
        + (f", {int((~fin).sum())} rows with no valid key" if not fin.all() else ""))
    check(err < DECODE_TOL and rel < DECODE_REL_TOL and err_l < LSE_TOL,
          f"decode {label} disagrees")
    res = {"err": err, "rel_l2": rel}
    if time_it:
        # Device time of a call (the wrapper's packing and int8 folds
        # included) and of the decode and merge kernels alone; the call's
        # CUDA-event time is host-bound at this size.
        # "timer" names how each time was taken (see device_ms).
        res["ms"], res["kernel_ms"], t_ms = device_ms(lambda: fn(*args, **kw),
                                                      names=DECODE_KERNELS)
        res["call_ms"] = cuda_ms(lambda: fn(*args, **kw), reps=20)
        res["plain_ms"], _, t_plain = device_ms(lambda: plain(*args, **kw), reps=3)
        res["bound_ms"], res["bound_by"] = bound(need[1], need[0])
        res["library_ms"], _, t_lib = (None, None, None) if library is None else device_ms(library)
        res["timer"] = {"ms": t_ms, "call_ms": "events", "plain_ms": t_plain, "library_ms": t_lib}
        lib = "none" if library is None else f"{res['library_ms']:.4f} ms"
        log(f"  decode {label}: device {res['ms']:.4f} ms per call (decode + merge kernels "
            f"{fmt_ms(res['kernel_ms'])}; events over back-to-back calls {res['call_ms']:.4f} ms), "
            f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}), library {lib}")
    return res


def serve_flash_check(dev):
    """Causal B1 at the serving path's shapes (Llama-3-8B heads, GQA): the
    prefill (every request's prompt) and a speculative verify step
    (lookahead + 1 rows against the prompt and the tokens so far,
    bottom-right causal). Returns the larger max abs error."""
    import torch

    cfg = llama3_8b_config(1)
    hq, hk, d = cfg.num_heads, cfg.num_heads_kv, cfg.dim // cfg.num_heads
    g = torch.Generator(device=dev).manual_seed(8642)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    sk = SERVE_PROMPT + SPEC_NEW + SPEC_LOOKAHEAD
    shapes = (("prefill", SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT),
              ("verify", 1, SPEC_LOOKAHEAD + 1, sk))
    err = 0.0
    for label, b, sq, sk in shapes:
        q, k, v = rnd(b, hq, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d)
        label = f"causal {label} {b}x{hq}/{hk}, Sq {sq} Sk {sk} D {d}"
        err = max(err, check_flash(q, k, v, label, causal=True)["err"])
    return err


def decode_kernel_phase(dev):
    """B8, B9a and B9b against their plain versions at the kvcache API's
    shape (ragged lengths), timed; plus D 64 / group 1 and causal Sq 4."""
    import torch
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
    )
    from liteattention_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_folded,
        paged_attention_folded_plain,
        paged_attention_plain,
    )

    x = api_inputs(dev)
    b, hq, hk, d, s = API_B, API_HQ, API_HK, API_D, API_CACHE
    group = hq // hk
    q4 = x["q"].transpose(1, 2)  # [B, H, 1, D]
    lens = x["lens"] + 1
    keys = int(lens.sum())

    def need(elsize, n_keys=keys, extra=0):
        """Bytes (K and V rows needed, q, out, lse) and FLOPs (QK and PV)."""
        kv = 2 * n_keys * hk * d * elsize
        return kv + 2 * nbytes(x["q"]) + 4 * b * hq + extra, 4 * group * d * hk * n_keys

    shape = f"{b}x{hq}/{hk}x{d}, cache {s}, lengths {lens.min().item()}-{lens.max().item()}"
    res = {}
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    kc_h, vc_h = x["kc"].transpose(1, 2), x["vc"].transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["flash_decode"] = check_decode(
        f"B8 contiguous bf16 {shape}", flash_attention_decode, flash_attention_decode_plain,
        (q4, x["kc"], x["vc"]), dict(kv_bound=lens), need(2), time_it=True,
    )
    # At uniform full lengths, beside SDPA (enable_gqa) on the same cache.
    r = res["flash_decode"]
    r["ms_full_lengths"], _, r["timer"]["ms_full_lengths"] = device_ms(
        lambda: flash_attention_decode(q4, x["kc"], x["vc"], kv_bound=full))
    r["bound_ms_full_lengths"] = bound(need(2, b * s)[1], need(2, b * s)[0])[0]
    r["library_ms"], _, r["timer"]["library_ms"] = device_ms(
        lambda: sdpa(q4, kc_h, vc_h, enable_gqa=True))
    r["library"] = "torch SDPA enable_gqa, uniform full lengths"
    log(f"  decode B8 full lengths: device {r['ms_full_lengths']:.4f} ms, bound "
        f"{r['bound_ms_full_lengths']:.4f} ms; SDPA (enable_gqa) {r['library_ms']:.4f} ms")
    r["int8"] = check_decode(
        f"B8 contiguous int8 {shape}", flash_attention_decode, flash_attention_decode_plain,
        (q4, x["kc8"], x["vc8"]),
        dict(kv_bound=lens, k_scale=x["ks"], v_scale=x["vs"]),
        need(1, extra=2 * nbytes(x["ks"])), time_it=True,
    )
    tbl_bytes = nbytes(x["table"])
    res["paged_decode_folded"] = check_decode(
        f"B9b paged bf16 {shape}, pages {API_PAGE}", paged_attention_folded,
        paged_attention_folded_plain, (x["q"], x["kp"], x["vp"], lens, x["table"]),
        dict(return_lse=True), need(2, extra=tbl_bytes), time_it=True,
    )
    res["paged_decode_folded"]["int8"] = check_decode(
        f"B9b paged int8 {shape}", paged_attention_folded, paged_attention_folded_plain,
        (x["q"], x["kp8"], x["vp8"], lens, x["table"]),
        dict(return_lse=True, k_scale=x["kps"], v_scale=x["vps"]),
        need(1, extra=tbl_bytes + 2 * nbytes(x["kps"])), time_it=True,
    )
    res["paged_decode"] = check_decode(
        f"B9a paged head-major bf16 {shape}", paged_attention, paged_attention_plain,
        (x["q"][:, 0], x["kh"], x["vh"], lens, x["table"]), dict(return_lse=True),
        need(2, extra=tbl_bytes), time_it=True,
    )
    for r in res.values():
        r.setdefault("library_ms", None)
    # D 64 with one q head per KV head (GPT-2-class MHA), and causal Sq 4
    # paged appends (the multi-token rows of a verify step).
    g = torch.Generator(device=dev).manual_seed(97)
    q64 = torch.randn(b, 8, 1, 64, generator=g, device=dev).bfloat16()
    k64 = torch.randn(b, s, 8, 64, generator=g, device=dev).bfloat16()
    v64 = torch.randn(b, s, 8, 64, generator=g, device=dev).bfloat16()
    e = check_decode("B8 D 64 group 1", flash_attention_decode, flash_attention_decode_plain,
                     (q64, k64, v64), dict(kv_bound=lens), None)
    res["flash_decode"]["err"] = max(res["flash_decode"]["err"], e["err"])
    q_sq4 = torch.randn(b, 4, hq, d, generator=g, device=dev).bfloat16()
    e = check_decode("B9b causal Sq 4 paged", paged_attention_folded,
                     paged_attention_folded_plain, (q_sq4, x["kp"], x["vp"], lens, x["table"]),
                     dict(return_lse=True, causal=True), None)
    res["paged_decode_folded"]["err"] = max(res["paged_decode_folded"]["err"], e["err"])
    return res


def teacher_forced_logits(model, tokens, prompt_len, capacity, quantize=False, fault=None):
    """Prefill ``tokens[:, :prompt_len]``, then feed the rest one token
    at a time through the cache; returns the fp32 logits that predict
    each token after the prompt, ``[B, n, V]``, and the cache.
    ``fault(inference_params)``, if given, plants a fault in the cache
    state after the prefill."""
    import torch
    from liteattention_torch.modules.mha import InferenceParams
    from liteattention_torch.utils.generation import quantize_inference_cache

    with torch.inference_mode():
        inf = InferenceParams(max_seqlen=capacity, max_batch_size=tokens.shape[0])
        # A copy: a view would keep the whole prefill's logits alive.
        out = [model(tokens[:, :prompt_len], inf)[:, -1].clone()]
        inf.seqlen_offset = prompt_len
        if quantize:
            quantize_inference_cache(inf)
        if fault is not None:
            fault(inf)
        for i in range(prompt_len, tokens.shape[1] - 1):
            out.append(model(tokens[:, i : i + 1], inf)[:, -1])
            inf.seqlen_offset += 1
        return torch.stack(out, dim=1).float(), inf


def small_llama_check(dev):
    """A small LLaMA (rotary, GQA, head dims 64 and 128) decoding on the
    card (bf16, the decode kernel) against greedy decoding on the CPU
    (fp32, the plain versions), teacher-forced on the CPU's tokens."""
    import torch
    from liteattention_torch.models.configs import llama_config
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.ops.flash_fwd import flash_attention_decode
    from liteattention_torch.utils.generation import greedy_decode

    prompt, new = 100, 12
    for heads in (8, 4):
        cfg = llama_config(dim=512, num_layers=2, num_heads=heads, num_heads_kv=2,
                           vocab=1000, ffn_dim=1024)
        cpu = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
        cpu.reset_parameters(torch.Generator().manual_seed(11))
        gpu = GPTLMHeadModel(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        ids = torch.randint(0, 1000, (2, prompt), generator=torch.Generator().manual_seed(12))
        rec = StepTimer(cpu)
        toks = greedy_decode(rec, ids, new, 128)
        ref = rec.logits()
        n0 = flash_attention_decode.launches
        got, _ = teacher_forced_logits(gpu, toks.to(dev), prompt, 128)
        torch.cuda.synchronize()
        n = flash_attention_decode.launches - n0
        check(n == cfg.num_layers * (new - 1), f"small LLaMA: {n} decode launches")
        err = rel_l2(got.float().cpu(), ref)
        same = (got.argmax(-1).cpu() == ref.argmax(-1)).float().mean().item()
        log(f"  small LLaMA (dim 512, 2 layers, {heads} heads of {512 // heads} on 2 KV heads), "
            f"{new} tokens teacher-forced, bf16 card vs fp32 CPU: logits rel-L2 {err:.2e}, "
            f"argmax agreement {same:.3f}, {n} decode launches")
        check(err < SMALL_DECODE_TOL, "small LLaMA decode disagrees")


class StepTimer:
    """The model as greedy decoding calls it, with each call's wall time
    (synchronized) recorded beside its token count, and an fp32 copy of
    its last-position logits (those the next token is chosen from)."""

    def __init__(self, model):
        self.model, self.calls, self.rows = model, [], []

    def __call__(self, ids, inference_params):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.model(ids, inference_params)
        torch.cuda.synchronize()
        self.calls.append((ids.shape[1], (time.perf_counter() - t0) * 1e3))
        self.rows.append(out[:, -1].to(torch.float32, copy=True))
        return out

    def logits(self):
        """``[B, calls, V]``: the logits each new token was chosen from."""
        import torch

        return torch.stack(self.rows, dim=1)


def llama3_8b_config(layers):
    """Meta-Llama-3-8B (config.json): hidden 4096, 32 heads on 8 KV heads
    of 128, intermediate 14336, vocab 128256, rope_theta 5e5, RMSNorm
    eps 1e-5, untied head."""
    from liteattention_torch.models.configs import llama_config

    cfg = llama_config(dim=4096, num_layers=layers, num_heads=32, num_heads_kv=8,
                       vocab=128256, ffn_dim=14336)
    return dataclasses.replace(cfg, rotary_emb_base=500000.0)


def profile_decode_steps(model, inf, steps, card):
    """Device time of ``steps`` decode steps by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tok = torch.zeros(inf.max_batch_size, 1, dtype=torch.long,
                      device=next(model.parameters()).device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model(tok, inf).argmax(-1)
            inf.seqlen_offset += 1
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = {
        e.key: e.self_device_time_total / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    }
    busy = sum(kern.values())
    if busy == 0:
        log("  profiler: no device time recorded; the decode breakdown is not measured")
        return None
    classes = {"attention (decode kernel)": ("flash_decode", "decode_merge"),
               "GEMM": ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk"),
               "casts and copies": ("copy",),
               "sampling (argmax)": ("argmax",)}
    split = dict.fromkeys([*classes, "other elementwise"], 0.0)
    for name, ms in kern.items():
        low = name.lower()
        cls = next((c for c, keys in classes.items() if any(k in low for k in keys)),
                   "other elementwise")
        split[cls] += ms
    log(f"  profiler, {steps} decode steps: wall {wall:.1f} ms (profiler on), device busy "
        f"{busy:.1f} ms ({busy / wall:.1%}); host gaps {wall - busy:.1f} ms [{card}]")
    for cls, ms in split.items():
        log(f"    {ms / steps:8.3f} ms/step  {ms / busy:6.1%}  {cls}")
    for name, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms / steps:8.3f} ms/step  {name[:100]}")
    return {"busy_ms_per_step": busy / steps, "wall_ms_per_step_profiled": wall / steps,
            **{f"{c}_ms_per_step": ms / steps for c, ms in split.items()}}


def recompute_fault_readings(model, toks, full, step_logits):
    """What the recompute comparison can see: the first FAULT_STEPS decode
    steps, teacher-forced, with one fault planted in the cache after the
    prefill, against the same full recompute, beside the sound run over
    the same steps. Faults: (late) every step one position late, so
    rotary is one position off and a zero row lies at the prompt's end;
    (row) the prompt's last K and V rows zeroed in every layer."""

    def late(inf):
        inf.seqlen_offset += 1

    def row(inf):
        for kc, vc, *_ in inf.key_value_memory_dict.values():
            kc[:, :, SERVE_PROMPT - 1] = 0
            vc[:, :, SERVE_PROMPT - 1] = 0

    n = FAULT_STEPS
    ref = full[:, 1:n]
    res = {"recompute_rel_l2_sound_first_steps": rel_l2(step_logits[:, 1:n], ref)}
    for name, fault in (("late", late), ("row", row)):
        got, _ = teacher_forced_logits(model, toks[:, : SERVE_PROMPT + n], SERVE_PROMPT,
                                       SERVE_CAPACITY, fault=fault)
        res[f"recompute_rel_l2_fault_{name}"] = rel_l2(got[:, 1:], ref)
        res[f"recompute_argmax_agreement_fault_{name}"] = (
            (got[:, 1:].argmax(-1) == ref.argmax(-1)).float().mean().item())
    log(f"  recompute comparison over decode steps 1-{n - 1}: sound rel-L2 "
        f"{res['recompute_rel_l2_sound_first_steps']:.3e}; planted faults: one position late "
        f"{res['recompute_rel_l2_fault_late']:.3e} (argmax agreement "
        f"{res['recompute_argmax_agreement_fault_late']:.3f}), prompt's last K/V row zeroed "
        f"{res['recompute_rel_l2_fault_row']:.3e} (argmax agreement "
        f"{res['recompute_argmax_agreement_fault_row']:.3f})")
    for name in ("late", "row"):
        check(res[f"recompute_rel_l2_fault_{name}"] > SERVE_RECOMPUTE_TOL,
              f"the recompute comparison no longer sees the planted fault '{name}'")
    return res


def serve_phase(dev, card):
    """The serving traffic at Llama-3-8B width (the counted main path),
    then its checks."""
    import statistics

    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import decode_speculative, greedy_decode

    small_llama_check(dev)
    cfg = llama3_8b_config(SERVE_LAYERS)
    log(f"  Llama-3-8B width: dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} q heads on "
        f"{cfg.num_heads_kv} KV heads x {cfg.dim // cfg.num_heads}, ffn {cfg.ffn_dim}, vocab "
        f"{cfg.vocab_size}, rope base {cfg.rotary_emb_base:g}; fp32 master weights, bf16 compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    draft = GPTLMHeadModel(dataclasses.replace(cfg, num_layers=SPEC_DRAFT_LAYERS), device=dev)
    # The draft: the main model's embedding, first blocks, final norm and head.
    draft.load_state_dict(model.state_dict(), strict=False)
    draft.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g, device=dev)
    api = api_inputs(dev, seed=1357)
    api_cpu = {k: v.cpu() for k, v in api.items()}
    log(f"  {n_params / 1e9:.2f} B parameters; {SERVE_BATCH} requests x {SERVE_PROMPT} prompt "
        f"tokens, {SERVE_NEW} new tokens each, cache capacity {SERVE_CAPACITY}")
    # Warm-up outside the counted run (cuBLAS handles, kernel library).
    greedy_decode(model, ids[:1, :16], 2, 32)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timer = StepTimer(model)
    toks = greedy_decode(timer, ids, SERVE_NEW, SERVE_CAPACITY)
    torch.cuda.synchronize()
    wall_bf16 = (time.perf_counter() - t0) * 1e3
    n_decode = len(timer.calls) - 1
    timer8 = StepTimer(model)
    toks8 = greedy_decode(timer8, ids, SERVE_NEW, SERVE_CAPACITY, quantize_cache=True)
    torch.cuda.synchronize()
    spec, stats = decode_speculative(model, draft, ids[:1], SPEC_NEW, SERVE_CAPACITY,
                                     speculative_lookahead=SPEC_LOOKAHEAD, return_stats=True)
    api_out = run_api(api)
    torch.cuda.synchronize()
    counts = read_counts()
    launches, merges = counts
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the serving run: {launches}; merge launches {merges}")
    want = 2 * cfg.num_layers * n_decode
    check(launches["flash_decode"] >= want,
          f"serving: expected at least {want} decode-kernel launches (one per layer per step)")
    check(all(launches[n] > 0 for n in ("flash_fwd", "flash_decode", "paged_decode",
                                        "paged_decode_folded")),
          "serving: a kernel of the path never launched")

    prefill_ms = timer.calls[0][1]
    step_ms = [ms for _, ms in timer.calls[1:]]
    step8_ms = [ms for _, ms in timer8.calls[1:]]
    dec_ms, dec8_ms = statistics.median(step_ms), statistics.median(step8_ms)
    stats_out = {
        "prefill_ms": prefill_ms, "decode_ms_per_step": dec_ms,
        "decode_ms_per_step_int8": dec8_ms, "prefill_ms_int8": timer8.calls[0][1],
        "decode_tokens_per_s": SERVE_BATCH * 1e3 / dec_ms,
        "decode_tokens_per_s_int8": SERVE_BATCH * 1e3 / dec8_ms,
        "end_to_end_tokens_per_s": SERVE_BATCH * SERVE_NEW * 1e3 / wall_bf16,
        "peak_gb": peak_gb, "decode_steps": n_decode,
    }
    log(f"  bf16 cache: prefill {prefill_ms:.1f} ms ({SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3:.0f} "
        f"prompt tokens/s), decode {dec_ms:.2f} ms/step (median of {n_decode}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) = {stats_out['decode_tokens_per_s']:.0f} "
        f"tokens/s; end to end {wall_bf16:.0f} ms = {stats_out['end_to_end_tokens_per_s']:.0f} "
        f"new tokens/s [{card}]")
    log(f"  int8 cache: prefill {timer8.calls[0][1]:.1f} ms, decode {dec8_ms:.2f} ms/step = "
        f"{stats_out['decode_tokens_per_s_int8']:.0f} tokens/s; peak memory {peak_gb:.2f} GB")
    acc = stats["accepted_per_round"]
    drafted = sum(min(SPEC_LOOKAHEAD, SPEC_NEW - 1 - sum(acc[:i])) for i in range(len(acc)))
    rate = (sum(acc) - len(acc)) / max(drafted, 1)
    n_cmp = SERVE_PROMPT + min(SPEC_NEW, SERVE_NEW)
    agree = (spec[0, SERVE_PROMPT:n_cmp] == toks[0, SERVE_PROMPT:n_cmp]).float()
    stats_out.update(spec_rounds=len(acc), spec_tokens_per_round=sum(acc) / len(acc),
                     spec_acceptance=rate, spec_agreement_with_greedy=agree.mean().item())
    log(f"  speculative (batch 1, {SPEC_DRAFT_LAYERS}-layer draft, lookahead {SPEC_LOOKAHEAD}, "
        f"{SPEC_NEW} tokens): {len(acc)} rounds, {sum(acc) / len(acc):.2f} tokens per round, "
        f"draft acceptance {rate:.3f}; tokens equal to the batch-8 greedy row "
        f"{agree.mean().item():.3f}")
    check(spec.shape == (1, SERVE_PROMPT + SPEC_NEW), "speculative output has the wrong shape")

    # Checks (their launches are not counted).
    step_logits = timer.logits()
    check(toks.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW) and torch.isfinite(step_logits).all(),
          "serving: bad greedy output")
    with torch.inference_mode():
        full = torch.cat([model(toks[i : i + 2, :-1])[:, SERVE_PROMPT - 1 :].clone()
                          for i in range(0, SERVE_BATCH, 2)])
    e_full = rel_l2(step_logits, full)
    agree_full = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    log(f"  incremental decode vs full recompute without a cache: logits rel-L2 {e_full:.3e}, "
        f"argmax agreement {agree_full:.3f}")
    check(e_full < SERVE_RECOMPUTE_TOL, "incremental decode disagrees with the full recompute")
    stats_out.update(recompute_rel_l2=e_full, recompute_argmax_agreement=agree_full,
                     **recompute_fault_readings(model, toks, full, step_logits))
    del full
    logits8, _ = teacher_forced_logits(model, toks, SERVE_PROMPT, SERVE_CAPACITY, quantize=True)
    e_int8 = rel_l2(logits8, step_logits)
    agree8 = (logits8.argmax(-1) == step_logits.argmax(-1)).float().mean().item()
    same8 = (toks8 == toks).float()[:, SERVE_PROMPT:].mean().item()
    log(f"  int8 vs bf16 cache, teacher-forced on the bf16 tokens: logits rel-L2 {e_int8:.3e}, "
        f"argmax agreement {agree8:.3f}; free-running tokens equal {same8:.3f}")
    stats_out.update(int8_rel_l2=e_int8, int8_argmax_agreement=agree8)
    del logits8
    refs = run_api(api_cpu)
    for name, out in api_out.items():
        e = rel_l2(out.float().cpu(), refs[name].float())
        log(f"  kvcache API {name}: card vs the CPU plain path rel-L2 {e:.2e}")
        check(e < DECODE_REL_TOL, f"kvcache API {name} disagrees with the CPU")

    _, inf = teacher_forced_logits(model, toks[:, : SERVE_PROMPT + 8], SERVE_PROMPT,
                                   SERVE_CAPACITY)
    stats_out["profile"] = profile_decode_steps(model, inf, 5, card)
    # B1 takes contiguous inputs, so prefill and multi-token steps copy the
    # cache prefix (K and V, every layer): its device time at the prefill
    # (8 x 1024 keys) and at a verify step (1 x prompt + 32 keys).
    kc, vc = inf.key_value_memory_dict[0][:2]

    def prefix_copy(rows, n):
        with torch.inference_mode():
            kc[:rows, :, :n].contiguous(), vc[:rows, :, :n].contiguous()

    copy_prefill = device_ms(lambda: prefix_copy(SERVE_BATCH, SERVE_PROMPT))[0] * cfg.num_layers
    copy_verify = device_ms(lambda: prefix_copy(1, SERVE_PROMPT + SPEC_NEW))[0] * cfg.num_layers
    stats_out.update(prefix_copy_ms_prefill=copy_prefill, prefix_copy_ms_verify=copy_verify)
    log(f"  cache-prefix copies for B1, all {cfg.num_layers} layers: {copy_prefill:.3f} ms per "
        f"prefill ({copy_prefill / prefill_ms:.2%} of it), {copy_verify:.3f} ms per verify step")
    return counts, stats_out


# ---------------------------------------------------------------- phase 6

# The rest of the engine at the Wan2.1-14B attention width (40 heads x 128,
# bf16): LiteAttention over 32 768 keys with the back half pre-skipped
# (union density 0.5, so the compaction gate engages), 4 calls at thr -6;
# the denoising slice over the 480p 61-frame latent (16 x 60 x 104 -> 24 960
# tokens, a multiple of 128); flash_attn_func and the super-tile mode over
# the slice's 32 760 tokens at the (256, 256) compute tile; fold_h 8.
ENGINE_SEQ, ENGINE_CALLS, ENGINE_THR = 32768, 4, -6.0
ENGINE_GRID = (16, 60, 104)
ENGINE_TILE = (256, 256)
FOLD_H = 8
SMALL_SEQ, SMALL_HEADS = 4096, 8  # the blocksparse and sequence-parallel checks


def timed(fn):
    """One call of ``fn``: its result and its device time in ms (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lite_attention_path(dev, h, d):
    """(a) LiteAttention with kv_compact True and False over the same
    calls: out, lse and masks must be equal. Returns the wall ms per call
    (median of calls 2..) of each and the last mask."""
    import statistics

    import torch
    from liteattention_torch import LiteAttention
    from liteattention_torch.ops.kv_compact import kv_union_map

    g = torch.Generator(device=dev).manual_seed(2025)
    s = ENGINE_SEQ

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    base = rnd(1, s, 1, d)
    calls = []
    for _ in range(ENGINE_CALLS):  # a slowly drifting trajectory
        base = base + 0.05 * rnd(1, s, 1, d)
        calls.append(tuple((base + 0.5 * rnd(1, s, h, d)).bfloat16() for _ in range(2))
                     + (rnd(1, s, h, d).bfloat16(),))
    skip = [s - 1, s // 2]  # keys s/2 .. s-1 pre-skipped
    runs = {}
    for flag in (True, False):
        attn = LiteAttention(threshold=ENGINE_THR, kv_compact=flag)
        res, ms = [], []
        for q, k, v in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, lse = attn(q, k, v, return_softmax_lse=True, must_skip_list=skip)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            res.append((out, lse, attn.state.do_mask.clone()))
        runs[flag] = (res, statistics.median(ms[1:]), attn)
    same = all(torch.equal(a, b) for ra, rb in zip(runs[True][0], runs[False][0])
               for a, b in zip(ra, rb))
    mask = runs[True][2].state.do_mask
    density = (kv_union_map(mask, hk=h)[2].float().mean() / mask.shape[3]).item()
    sparsity = runs[True][2].get_skip_percentage()
    log(f"  (a) LiteAttention 1x{s}x{h}x{d}, {ENGINE_CALLS} calls at thr {ENGINE_THR}, keys "
        f"{s // 2}-{s - 1} pre-skipped: union density {density:.3f}, sparsity {sparsity:.3f}; "
        f"kv_compact True vs False: out, lse and masks equal {same}; ms per call "
        f"{runs[True][1]:.2f} (compacted) vs {runs[False][1]:.2f}")
    check(same, "(a) kv_compact changed LiteAttention's results")
    check(density < 0.75, "(a) the compaction gate did not engage")
    return {"ms_per_call_compacted": runs[True][1], "ms_per_call_plain_schedule": runs[False][1],
            "union_density": density, "sparsity": sparsity}, calls[-1], mask


def denoise_compact_path(dev, full, card):
    """(b) denoise(kv_compact=True) against kv_compact=False on the 2-block
    Wan slice: the latents and masks must be bit-identical."""
    import torch
    from liteattention_torch.models import WanModel, denoise
    from liteattention_torch.ops.mask import SkipMaskState

    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS)
    model = WanModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(3)
    frames, hh, ww = ENGINE_GRID
    noise = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    n_tok = frames * (hh // cfg.patch_size[1]) * (ww // cfg.patch_size[2])
    kt = math.ceil(n_tok / 128)
    band = banded_mask(1, cfg.num_heads, kt, kt, 0.5, dev)
    states = {i: SkipMaskState(band, 0) for i in range(cfg.num_layers)}
    steps = 4
    runs = {}
    for flag in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, tel = denoise(model, noise, text, null, num_steps=steps, guidance_scale=5.0,
                         vote_stride=2, thresholds=[ENGINE_THR] * steps,
                         initial_states=dict(states), initial_states_uncond=dict(states),
                         kv_compact=flag)
        torch.cuda.synchronize()
        runs[flag] = (x, tel, (time.perf_counter() - t0) * 1e3 / steps)
    (xc, tc, msc), (xp, tp, msp) = runs[True], runs[False]
    same = torch.equal(xc, xp) and all(
        torch.equal(tc[key][i].do_mask, tp[key][i].do_mask)
        for key in ("final_states", "final_states_uncond") for i in range(cfg.num_layers))
    sp = [round(float(v), 4) for v in tc["sparsity_per_step"]]
    log(f"  (b) denoise, {frames}x{hh}x{ww} -> {n_tok} tokens, CFG, {steps} steps, vote_stride 2, "
        f"banded masks, thr {ENGINE_THR}: sparsity per step {sp}; kv_compact True vs False "
        f"latents and masks bit-identical {same}; ms/step {msc:.1f} vs {msp:.1f} [{card}]")
    check(same and bool(torch.isfinite(xc).all()), "(b) denoise(kv_compact=True) differs")
    return {"ms_per_step_compacted": msc, "ms_per_step_plain_schedule": msp, "tokens": n_tok}


def median_thr(headroom):
    """A threshold at which about half of the voting tiles skip."""
    import torch

    return headroom[torch.isfinite(headroom)].float().median().item()


def engine_phase(dev, full, card):
    """Phase 6: the counted run of the engine's paths (a)-(e), then each
    kernel against its plain version, then the kernels' times."""
    import torch
    from liteattention_torch import LiteAttention, SeqParallelLiteAttention
    from liteattention_torch.flash_attn_interface import flash_attn_func
    from liteattention_torch.flash_blocksparse import (
        FlashBlocksparseAttention,
        _blockmask_elementwise,
        _exact_attention,
    )
    from liteattention_torch.ops.combine import combine_attention
    from liteattention_torch.ops.kv_compact import compact_kv, compact_kv_plain, kv_union_map
    from liteattention_torch.ops.lite_flash_fwd import (
        lite_flash_attention,
        lite_flash_attention_coarse_plain,
        lite_flash_attention_plain,
        vote_headroom,
    )
    from liteattention_torch.ops.mask import (
        SkipMaskState,
        compact_mask,
        compact_mask_fine,
        update_mask,
    )
    from liteattention_torch.ops.schedule_pack import pack_schedule, pack_schedule_plain
    from liteattention_torch.ops.tile_sizes import BlockSizes

    h, d = full.num_heads, full.head_dim
    frames, hh, ww = SLICE_GRID
    s = frames * (hh // full.patch_size[1]) * (ww // full.patch_size[2])
    g = torch.Generator(device=dev).manual_seed(777)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    # (c)'s inputs, masks and thresholds, chosen from the plain versions.
    q, k, v = rnd(1, s, h, d), rnd(1, s, h, d), rnd(1, s, h, d)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt = math.ceil(s / 128)
    bq, bk = ENGINE_TILE
    band = banded_mask(1, h, kt, kt, 0.5, dev)
    fidx, count = pack_schedule_plain(band)
    head_f = vote_headroom(qh, kh, fidx, count)
    valid = torch.arange(kt, device=dev) < count[..., None]
    thr_f = median_thr(head_f[valid])
    (ro_f, rl_f, rv_f), plain_f_ms = timed(
        lambda: lite_flash_attention_plain(qh, kh, vh, fidx, count, thr_f, band))
    mask_c = banded_mask(1, h, math.ceil(s / bq), math.ceil(s / bk), 0.5, dev)
    idx_c, count_c = compact_mask(mask_c)
    (ro_c, rl_c, _, hr_c), plain_c_ms = timed(lambda: lite_flash_attention_coarse_plain(
        qh, kh, vh, idx_c, count_c, 0.0, qsub=bq // 128, ksub=bk // 128, return_headroom=True))
    thr_c = median_thr(hr_c[mask_c])
    idx_s, count_s, bits_s = compact_mask_fine(band, bq // 128, bk // 128)
    (ro_s, rl_s, _, hr_s), plain_s_ms = timed(lambda: lite_flash_attention_coarse_plain(
        qh, kh, vh, idx_s, count_s, 0.0, bits_s, qsub=bq // 128, ksub=bk // 128,
        return_headroom=True))
    thr_s = median_thr(hr_s[:, :, :kt, :kt][band])
    small = torch.Generator(device=dev).manual_seed(778)
    qkv_small = torch.randn(1, SMALL_SEQ, 3, SMALL_HEADS, 64, generator=small,
                            device=dev).bfloat16()
    layout = torch.rand(SMALL_SEQ // 128, SMALL_SEQ // 256, generator=small, device=dev) < 0.5
    layout[:, 0] = True
    layout = layout.repeat_interleave(8, dim=0).cpu().numpy()  # uniform per 8 rows
    qs_ = [rnd(1, SMALL_SEQ, SMALL_HEADS, 128) for _ in range(3)]

    # The counted run: every path of the engine through its entry points.
    torch.cuda.synchronize()
    reset_counts()
    res = {}
    res["lite_attention"], (qa, ka, va), mask_a = lite_attention_path(dev, h, d)
    res["denoise"] = denoise_compact_path(dev, full, card)
    fo, fl, fm = flash_attn_func(q, k, v, attn_read_list=band, thr=thr_f,
                                 return_softmax_lse=True, return_skip_mask=True)
    co, cl, cm = flash_attn_func(q, k, v, attn_read_list=mask_c, thr=thr_c,
                                 block_sizes=BlockSizes(bq, bk), return_softmax_lse=True,
                                 return_skip_mask=True)
    so, sl, sv = lite_flash_attention(qh, kh, vh, idx_s, count_s, thr_s, kv_bits=bits_s,
                                      block_sizes=BlockSizes(bq, bk), fine_schedule=False)
    fold = lite_flash_attention(qh, kh, vh, fidx, count, thr_f, band, fold_h=FOLD_H)
    bs_mod = FlashBlocksparseAttention(layout, max_seq_length=SMALL_SEQ)
    bso, _ = bs_mod(qkv_small)
    sp = SeqParallelLiteAttention(2, threshold=-math.inf)
    half = SMALL_SEQ // 2
    parts = [sp(qs_[0], qs_[1][:, sl_], qs_[2][:, sl_], i, return_softmax_lse=True)
             for i, sl_ in enumerate((slice(0, half), slice(half, None)))]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches during the engine run: {counts[0]}")
    check(all(counts[0][n] > 0 for n in ("schedule_pack", "lite_flash_fwd", "lite_flash_fwd_coarse",
                                         "lite_flash_fwd_hfold", "kv_compact")),
          "engine: a kernel of the path never launched")

    # Checks (their launches are not counted).
    def check_attn(label, out, lse, ro, rl):
        err_o = (out.float() - ro.float()).abs().max().item()
        fin = torch.isfinite(rl)
        check(torch.equal(fin, torch.isfinite(lse)), f"{label}: lse -inf rows differ")
        err_l = (lse[fin] - rl[fin]).abs().max().item()
        check(err_o < OUT_TOL and err_l < LSE_TOL, f"{label} disagrees")
        return err_o, err_l

    def check_votes(label, got, want, near, live):
        diff = (got != want) & live
        bad = int((diff & ~near).sum())
        check(bad == 0, f"{label}: votes disagree outside the margin")
        return f"votes differ at {int(diff.sum())} ({int((near & live).sum())} within {MARGIN} of thr)"

    err_f = check_attn("(c) fine B3", fo.transpose(1, 2), fl, ro_f, rl_f)
    margin = torch.where(valid, (head_f - thr_f).abs(), torch.full_like(head_f, math.inf))
    near_f = torch.full(band.shape, math.inf, device=dev)
    near_f.scatter_reduce_(-1, fidx.long(), margin, reduce="amin")
    near_f = near_f < MARGIN
    want_fm = update_mask(SkipMaskState(band, 0), rv_f).do_mask
    msg_f = check_votes("(c) fine B3 mask", fm, want_fm, near_f, band)
    err_c = check_attn("(c) coarse B4", co.transpose(1, 2), cl, ro_c, rl_c)
    rv_c = torch.where((hr_c > thr_c) | (hr_c == math.inf), 0, 1).int()
    want_cm = update_mask(SkipMaskState(mask_c, 0), rv_c).do_mask
    msg_c = check_votes("(c) coarse B4 mask", cm, want_cm, (hr_c - thr_c).abs() < MARGIN, mask_c)
    err_s = check_attn("(c) super-tile B4", so, sl, ro_s, rl_s)
    rv_s = torch.where((hr_s > thr_s) | (hr_s == math.inf), 0, 1).int()
    live_s = torch.zeros_like(hr_s, dtype=torch.bool)
    live_s[:, :, :kt, :kt] = band
    msg_s = check_votes("(c) super-tile B4 votes", sv, rv_s, (hr_s - thr_s).abs() < MARGIN, live_s)
    log(f"  (c) flash_attn_func 1x{s}x{h}x{d}: fine banded mask (B3) thr {thr_f:.3f}: max|out| "
        f"err {err_f[0]:.3e}, max|lse| err {err_f[1]:.3e}, mask {msg_f}; coarse mask at "
        f"BlockSizes{ENGINE_TILE} (B4) thr {thr_c:.3f}: {err_c[0]:.3e}, {err_c[1]:.3e}, mask "
        f"{msg_c}; super-tile bits (B4) thr {thr_s:.3f}: {err_s[0]:.3e}, {err_s[1]:.3e}, {msg_s}")
    base = lite_flash_attention(qh, kh, vh, fidx, count, thr_f, band)
    same_fold = all(torch.equal(a, b) for a, b in zip(fold, base))
    log(f"  (d) fold_h={FOLD_H} (B5) vs unfolded (B3): out, lse, votes equal {same_fold}")
    check(same_fold, "(d) fold_h changed the results")
    exact = _exact_attention(*qkv_small.unbind(2),
                             _blockmask_elementwise(layout, SMALL_SEQ, SMALL_SEQ, dev), None, False)
    err_bs = (bso.float() - exact.float()).abs().max().item()
    merged, _ = combine_attention(torch.stack([o.transpose(1, 2) for o, _ in parts]),
                                  torch.stack([l_ for _, l_ in parts]))
    one = LiteAttention(threshold=-math.inf)(*qs_)
    err_sp = (merged.transpose(1, 2).float() - one.float()).abs().max().item()
    log(f"  (e) FlashBlocksparseAttention kernel route vs the plain exact 16x256 path 1x{SMALL_SEQ}x"
        f"{SMALL_HEADS}x64: max|out| err {err_bs:.3e}; SeqParallelLiteAttention 2 splits merged "
        f"vs one call at thr -inf, 1x{SMALL_SEQ}x{SMALL_HEADS}x128: {err_sp:.3e}")
    check(err_bs < OUT_TOL and err_sp < OUT_TOL, "(e) disagrees")

    # The kernels' times beside their bounds, plain versions and libraries.
    kres = {}
    rows = (s - torch.arange(math.ceil(s / bq), device=dev) * bq).clamp(max=bq)
    cols = (s - torch.arange(math.ceil(s / bk), device=dev) * bk).clamp(max=bk)
    live_c = int((mask_c.long() * rows[:, None] * cols[None, :]).sum())
    rows_f = (s - torch.arange(kt, device=dev) * 128).clamp(max=128)
    live_f = int((band.long() * rows_f[:, None] * rows_f[None, :]).sum())
    io = nbytes(qh, kh, vh, qh, fl)  # q, k, v in; out (q's size), lse out
    coarse = {"err": max(err_c[0], err_s[0]), "library_ms": None}
    coarse["ms"] = cuda_ms(lambda: lite_flash_attention(
        qh, kh, vh, idx_c, count_c, thr_c, block_sizes=BlockSizes(bq, bk), fine_schedule=False))
    coarse["plain_ms"] = plain_c_ms
    coarse["bound_ms"], coarse["bound_by"] = bound(
        4 * d * live_c, io + nbytes(idx_c, count_c) + 4 * mask_c.numel())
    sup = {"max_abs_err": err_s[0], "plain_ms": plain_s_ms}
    sup["ms"] = cuda_ms(lambda: lite_flash_attention(
        qh, kh, vh, idx_s, count_s, thr_s, kv_bits=bits_s, block_sizes=BlockSizes(bq, bk),
        fine_schedule=False))
    sup["bound_ms"], sup["bound_by"] = bound(
        4 * d * live_f, io + nbytes(idx_s, count_s, bits_s) + 4 * hr_s.numel())
    coarse["super_tile"] = sup
    coarse["coarse_sparsity"] = 1 - mask_c.float().mean().item()
    kres["lite_flash_fwd_coarse"] = coarse
    unfolded = cuda_ms(lambda: lite_flash_attention(qh, kh, vh, fidx, count, thr_f, band))
    hf = {"err": err_f[0], "library_ms": None, "plain_ms": plain_f_ms, "ms_unfolded_b3": unfolded}
    hf["ms"] = cuda_ms(lambda: lite_flash_attention(qh, kh, vh, fidx, count, thr_f, band,
                                                    fold_h=FOLD_H))
    hf["bound_ms"], hf["bound_by"] = bound(
        4 * d * live_f, io + nbytes(fidx, count, band) + 4 * band.numel())
    kres["lite_flash_fwd_hfold"] = hf
    # B6 and the compacted B2/B3 at (a)'s shape and final mask.
    qa, ka, va = (x.transpose(1, 2).contiguous() for x in (qa, ka, va))
    kv_map, inv, _ = kv_union_map(mask_a, hk=h)
    kc, vc = compact_kv(ka, va, inv)
    (pk, pv_), plain_kv_ms = timed(lambda: compact_kv_plain(ka, va, inv))
    check(torch.equal(kc, pk) and torch.equal(vc, pv_), "B6 disagrees with its plain version")
    b_, hk_, sa, _ = ka.shape
    flat_idx = (inv.long() + torch.arange(b_ * hk_, device=dev).reshape(b_, hk_, 1)
                * (sa // 128)).reshape(-1)
    fk, fv = ka.reshape(-1, 128 * d), va.reshape(-1, 128 * d)
    kvc = {"err": 0.0, "plain_ms": plain_kv_ms,
           "library": "torch.index_select of K and V over the tile view (2 calls)"}
    kvc["ms"] = cuda_ms(lambda: compact_kv(ka, va, inv), reps=20)
    kvc["library_ms"] = cuda_ms(lambda: (torch.index_select(fk, 0, flat_idx),
                                         torch.index_select(fv, 0, flat_idx)), reps=20)
    kvc["bound_ms"], kvc["bound_by"] = bound(0, 2 * nbytes(ka, va) + nbytes(inv))
    kres["kv_compact"] = kvc
    fa, ca, cia = pack_schedule(mask_a, kv_map)
    ext = {"pack_ms_kv_map": cuda_ms(lambda: pack_schedule(mask_a, kv_map), reps=20),
           "pack_ms": cuda_ms(lambda: pack_schedule(mask_a), reps=20),
           "pack_bound_ms_kv_map": bound(0, nbytes(mask_a, fa, ca, cia, kv_map))[0],
           "lite_ms_compacted": cuda_ms(lambda: lite_flash_attention(
               qa, kc, vc, fa, ca, ENGINE_THR, mask_a, cidx=cia)),
           "lite_ms_uncompacted": cuda_ms(lambda: lite_flash_attention(
               qa, ka, va, fa, ca, ENGINE_THR, mask_a)),
           "a_sparsity": 1 - mask_a.float().mean().item()}
    log(f"  B4 coarse {ENGINE_TILE} banded {coarse['coarse_sparsity']:.3f}: kernel "
        f"{coarse['ms']:.3f} ms, plain {coarse['plain_ms']:.3f} ms, bound {coarse['bound_ms']:.3f} "
        f"ms ({coarse['bound_by']}); super-tile {sup['ms']:.3f} ms, plain {sup['plain_ms']:.3f} "
        f"ms, bound {sup['bound_ms']:.3f} ms ({sup['bound_by']})")
    log(f"  B5 fold_h={FOLD_H}: {hf['ms']:.3f} ms vs B3 {unfolded:.3f} ms, bound "
        f"{hf['bound_ms']:.3f} ms ({hf['bound_by']})")
    log(f"  B6 compact_kv 1x{h}x{sa}x{d} K and V: kernel {kvc['ms']:.4f} ms, plain "
        f"{kvc['plain_ms']:.3f} ms, index_select {kvc['library_ms']:.4f} ms, bound "
        f"{kvc['bound_ms']:.4f} ms ({kvc['bound_by']})")
    log(f"  at (a)'s mask (sparsity {ext['a_sparsity']:.3f}): B2 {ext['pack_ms']:.4f} ms, with "
        f"kv_map {ext['pack_ms_kv_map']:.4f} ms; B3 on compacted K/V {ext['lite_ms_compacted']:.3f}"
        f" ms vs on K/V {ext['lite_ms_uncompacted']:.3f} ms (+ B6 {kvc['ms']:.4f} ms) [{card}]")
    return counts, kres, ext, res


# ---------------------------------------------------------------- phase 7

# MLA at DeepSeek-V3's published widths (config.json: num_attention_heads
# 128, kv_lora_rank 512, qk_rope_head_dim 64, qk_nope_head_dim 128,
# v_head_dim 128; random bf16 inputs from a seed). Absorbed decode: every
# head attends one latent row of 512 + 64 = 576 channels, V its first 512;
# 64 requests with ragged cache lengths in 1024-8192 over one layer's pool
# of 64-token pages (64 x 8192 x 576 bf16, 604 MB). Prefill: 2 prompts x
# 4096 tokens through flash_attn_func at (q/k 192 = 128 + 64, v 128), causal.
MLA_HEADS, MLA_D, MLA_DV = 128, 576, 512
MLA_BATCH, MLA_MIN_LEN, MLA_MAX_LEN, MLA_PAGE = 64, 1024, 8192, 64
MLA_PREFILL_BATCH, MLA_PREFILL_SEQ, MLA_QK, MLA_V = 2, 4096, 192, 128
# B10 against its plain version: rel-L2 of the outputs over the tensor and
# over each request's block of rows (bf16 output, P rounded to bf16 before
# PV); lse as LSE_TOL. B1-MLA: as check_flash, plus the same rel-L2 over
# every (b, h, 128-row block).
MLA_REL_TOL = 1e-2
MLA_BLOCK_TOL = 2e-2
MLA_KERNELS = ("mla_decode_kernel", "decode_merge_kernel")


def sdpa_backend_ms(label, call):
    """The first of SDPA's backends that takes ``call`` (flash, efficient,
    cuDNN, math): its name, its device time per call and the timer
    (device_ms); (None, None, None), with each backend's refusal logged,
    when none does."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    refused = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                call()
                torch.cuda.synchronize()
                ms, _, timer = device_ms(call, reps=10)
                return backend.name, ms, timer
        except RuntimeError as e:  # a backend that refuses the call, or runs out of memory
            refused.append(f"{backend.name}: {str(e).strip().splitlines()[0][:200]}")
            torch.cuda.empty_cache()
    log(f"  SDPA {label}: no backend took the call ({'; '.join(refused)})")
    return None, None, None


def mla_inputs(dev, seed=5151):
    """q, one layer's latent pool, ragged lengths, and the four cache forms
    of phase 7 (a): contiguous, paged with an identity table, paged with a
    random permutation, and a 640-lane contiguous cache."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, s, ps = MLA_BATCH, MLA_MAX_LEN, MLA_PAGE
    pages = b * s // ps
    x = {"q": torch.randn(b, 1, MLA_HEADS, MLA_D, generator=g, device=dev).bfloat16(),
         "pool": torch.randn(pages, ps, 1, MLA_D, generator=g, device=dev).bfloat16()}
    x["lens"] = torch.randint(MLA_MIN_LEN, s + 1, (b,), generator=g, device=dev).int()
    x["lens"][0] = s
    wide = torch.randn(b, s, 1, 640, generator=g, device=dev).bfloat16() * 50
    wide[..., :MLA_D] = x["pool"].reshape(b, s, 1, MLA_D)
    ident = torch.arange(pages, device=dev).reshape(b, s // ps).int()
    perm = torch.randperm(pages, generator=g, device=dev).reshape(b, s // ps).int()
    x["forms"] = {"contiguous": (x["pool"].reshape(b, s, 1, MLA_D), None),
                  "paged identity": (x["pool"], ident),
                  "paged permuted": (x["pool"], perm),
                  "640-lane contiguous": (wide, None)}
    return x


def check_mla(label, out, lse, ro, rl):
    """B10 against its plain version (module constants); returns max abs
    error and the worst per-request rel-L2."""
    import torch

    fin = torch.isfinite(rl)
    check(torch.equal(fin, torch.isfinite(lse)), f"{label}: lse -inf rows differ")
    check(torch.isfinite(out).all().item(), f"{label}: non-finite output")
    err = (out.float() - ro.float()).abs().max().item()
    rel = rel_l2(out.float(), ro.float())
    per = [rel_l2(out[i].float(), ro[i].float()) for i in range(out.shape[0])
           if ro[i].abs().max().item() > 0]
    worst = max(per) if per else 0.0
    err_l = (lse[fin] - rl[fin]).abs().max().item() if fin.any() else 0.0
    msg = (f"  {label}: max|out| err {err:.3e}, rel-L2 {rel:.2e}, worst request "
           f"{worst:.2e}, max|lse| err {err_l:.3e}")
    if not fin.all():
        check(out.float()[~fin.transpose(1, 2)].abs().max().item() == 0.0,
              f"{label}: a row with no key is not 0")
        msg += f", {int((~fin).sum())} rows with no valid key (out 0, lse -inf)"
    log(msg)
    check(rel < MLA_REL_TOL and worst < MLA_REL_TOL and err_l < LSE_TOL,
          f"{label} disagrees")
    return err


def check_flash_mla(q, k, v, label, causal=False, qv=None):
    """B1's MLA instantiation against the plain version: out within
    OUT_TOL (over max(1, |plain|) when causal), lse within LSE_TOL, rel-L2
    over each (b, h, 128-row block) within MLA_BLOCK_TOL."""
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain

    out, lse = flash_attention(q, k, v, causal=causal, qv=qv, return_lse=True)
    torch.cuda.synchronize()
    ro, rl = flash_attention_plain(q, k, v, 1.0 / q.shape[-1] ** 0.5, causal, qv=qv)
    diff = (out.float() - ro.float()).abs()
    err = diff.max().item()
    err_chk = (diff / ro.float().abs().clamp_min(1.0)).max().item() if causal else err
    fin = torch.isfinite(rl)
    check(torch.equal(fin, torch.isfinite(lse)), f"B1-MLA {label}: lse -inf rows differ")
    err_l = (lse[fin] - rl[fin]).abs().max().item()
    rel, blk = block_rel_l2(out, ro)
    log(f"  B1-MLA {label}: max|out| err {err:.3e}, rel-L2 {rel:.2e}, worst 128-row block "
        f"{blk:.2e}, max|lse| err {err_l:.3e}")
    check(err_chk < OUT_TOL and err_l < LSE_TOL and blk < MLA_BLOCK_TOL,
          f"B1-MLA {label} disagrees")
    return err


def mla_phase(dev, card):
    """Phase 7: the counted run of the MLA path through its entry points
    (flash_mla_with_kvcache in four cache forms, flash_attn_func at the
    prefill shape), each against its plain version, small causal, empty-row
    and other-width checks, then the kernels' times."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_func, flash_mla_with_kvcache
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain
    from liteattention_torch.ops.mla import mla_decode, mla_decode_plain

    x = mla_inputs(dev)
    q, lens = x["q"], x["lens"]
    g = torch.Generator(device=dev).manual_seed(6262)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    b, hp, sp = MLA_PREFILL_BATCH, MLA_HEADS, MLA_PREFILL_SEQ
    pq, pk, pv = rnd(b, sp, hp, MLA_QK), rnd(b, sp, hp, MLA_QK), rnd(b, sp, hp, MLA_V)

    # The counted run: the MLA path through the entry points a server calls.
    torch.cuda.synchronize()
    reset_counts()
    outs = {name: flash_mla_with_kvcache(q, cache, table, lens, MLA_DV)
            for name, (cache, table) in x["forms"].items()}
    prefill = flash_attn_func(pq, pk, pv, causal=True, return_softmax_lse=True)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches during the MLA run: {counts[0]}")
    check(counts[0]["mla_decode"] == len(outs) and counts[0]["flash_fwd_mla"] == 1,
          "mla: a kernel of the path did not launch as often as the path calls it")

    # Checks (their launches are not counted).
    shape = (f"{MLA_BATCH}x{MLA_HEADS}x{MLA_D}/{MLA_DV}, lengths "
             f"{lens.min().item()}-{lens.max().item()}, pages of {MLA_PAGE}")
    err = 0.0
    for name, (cache, table) in x["forms"].items():
        ro, rl = mla_decode_plain(q, cache, lens, MLA_DV, page_table=table, return_lse=True)
        err = max(err, check_mla(f"B10 {name} {shape}", *outs[name], ro, rl))
        del ro, rl
    same = all(torch.equal(a, c) for a, c in zip(outs["640-lane contiguous"],
                                                outs["contiguous"]))
    log(f"  B10 640-lane cache equals the 576 one: {same}")
    check(same, "B10: the 640-lane cache changed the result")
    # Causal Sq 2 x Hq 32 on the permuted pages, with a request of length 0.
    q2 = rnd(MLA_BATCH, 2, 32, MLA_D)
    lens2 = lens.clone()
    lens2[1] = 0
    cache, table = x["forms"]["paged permuted"]
    o2 = mla_decode(q2, cache, lens2, MLA_DV, page_table=table, return_lse=True)
    r2 = mla_decode_plain(q2, cache, lens2, MLA_DV, page_table=table, return_lse=True)
    err = max(err, check_mla("B10 causal Sq 2 x Hq 32, one request of length 0", *o2, *r2))
    check(bool((o2[0][1] == 0).all()) and bool(torch.isneginf(o2[1][1]).all()),
          "B10: the empty request is not out 0 / lse -inf")

    po, pl = prefill
    ro, rl = flash_attention_plain(*(a.transpose(1, 2) for a in (pq, pk, pv)), MLA_QK**-0.5,
                                   True)
    diff = (po.transpose(1, 2).float() - ro.float()).abs()
    err_f = diff.max().item()
    rel, blk = block_rel_l2(po.transpose(1, 2), ro)
    err_l = (pl - rl).abs().max().item()
    log(f"  B1-MLA flash_attn_func causal {b}x{sp}x{hp}, ({MLA_QK}, {MLA_V}), all heads: max|out|"
        f" err {err_f:.3e}, rel-L2 {rel:.2e}, worst 128-row block {blk:.2e}, max|lse| err "
        f"{err_l:.3e}")
    check((diff / ro.float().abs().clamp_min(1.0)).max().item() < OUT_TOL
          and err_l < LSE_TOL and blk < MLA_BLOCK_TOL, "B1-MLA prefill disagrees")
    del ro, rl, diff
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (pq, pk, pv))
    for causal in (False, True):
        err_f = max(err_f, check_flash_mla(rnd(1, 8, 700, 576), rnd(1, 8, 900, 576),
                                           rnd(1, 8, 900, 512), f"(576, 512) {causal=}", causal))
        err_f = max(err_f, check_flash_mla(rnd(2, 4, 300, 64), rnd(2, 2, 555, 64),
                                           rnd(2, 2, 555, 512), f"(64, 512) + qv {causal=}",
                                           causal, qv=rnd(2, 4, 300, 512)))

    # The kernels' times beside their bounds, plain versions and SDPA.
    res = {}
    keys = int(lens.clamp(max=MLA_MAX_LEN).sum())

    def need(n_keys, extra=0):
        """(FLOPs, bytes) of a call: QK over D and PV over Dv for every
        (row, key); each latent row read once, q, out and lse once."""
        flops = 2 * (MLA_D + MLA_DV) * MLA_HEADS * n_keys
        return flops, n_keys * MLA_D * 2 + nbytes(q) + MLA_BATCH * MLA_HEADS * (MLA_DV * 2 + 4) + extra

    forms = {}
    for name, (cache, table) in x["forms"].items():
        call = lambda c=cache, tb=table: mla_decode(q, c, lens, MLA_DV, page_table=tb)  # noqa: E731
        f = dict(zip(("ms", "kernel_ms", "timer"), device_ms(call, names=MLA_KERNELS)))
        f["bound_ms"], f["bound_by"] = bound(*need(keys, 0 if table is None else nbytes(table)))
        forms[name] = f
        log(f"  B10 {name}: device {f['ms']:.4f} ms per call (kernels {fmt_ms(f['kernel_ms'])}, "
            f"timer {f['timer']}), "
            f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}), {f['bound_ms'] / f['ms']:.1%} of it")
    cache, table = x["forms"]["paged permuted"]
    r = {"err": err, **forms["paged permuted"], "forms": forms, "shape": shape}
    r["timer"] = {"ms": r["timer"]}
    r["plain_ms"], _, r["timer"]["plain_ms"] = device_ms(
        lambda: mla_decode_plain(q, cache, lens, MLA_DV, page_table=table), reps=3)
    full = torch.full_like(lens, MLA_MAX_LEN)
    cont = x["forms"]["contiguous"][0][:, :, 0]
    r["ms_full_lengths"], _, r["timer"]["ms_full_lengths"] = device_ms(
        lambda: mla_decode(q, cont, full, MLA_DV))
    r["bound_ms_full_lengths"] = bound(*need(MLA_BATCH * MLA_MAX_LEN))[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4 = q.transpose(1, 2), cont[:, None]
    torch.cuda.empty_cache()
    # SDPA over the same cache at full lengths: the heads as GQA heads of
    # one KV head, and the same function with the heads as query rows of
    # one head; the first that some backend takes is the library call.
    calls = {"enable_gqa": lambda: sdpa(q4, k4, k4[..., :MLA_DV], enable_gqa=True),
             "heads as query rows": lambda: sdpa(q, k4, k4[..., :MLA_DV])}
    lib = {name: sdpa_backend_ms(name, call) for name, call in calls.items()}
    r["library_calls"] = {name: {"backend": be, "ms": ms, "timer": t}
                          for name, (be, ms, t) in lib.items()}
    name, (backend, r["library_ms"], r["timer"]["library_ms"]) = next(
        ((n, v) for n, v in lib.items() if v[1] is not None), ("none", (None, None, None)))
    r["library"] = f"torch SDPA {name} ({backend} backend), full lengths"
    libs = ", ".join(f"{n} ({be}) {'n/a' if ms is None else f'{ms:.4f} ms'}"
                     for n, (be, ms, _) in lib.items())
    log(f"  B10 plain {r['plain_ms']:.3f} ms; at full lengths {MLA_MAX_LEN}: kernel "
        f"{r['ms_full_lengths']:.4f} ms, bound {r['bound_ms_full_lengths']:.4f} ms; SDPA "
        f"{libs} [{card}]")
    res["mla_decode"] = r

    flops = 2 * (MLA_QK + MLA_V) * attn_pairs(sp, sp, True) * b * hp
    f = {"err": err_f, "shape": f"{b}x{hp}x{sp}, ({MLA_QK}, {MLA_V}), causal"}
    f["ms"] = cuda_ms(lambda: flash_attention(qh, kh, vh, causal=True))
    f["plain_ms"] = cuda_ms(lambda: flash_attention_plain(qh, kh, vh, None, True), reps=1)
    f["bound_ms"], f["bound_by"] = bound(flops, nbytes(qh, kh, vh, po, pl))
    backend, f["library_ms"], t_lib = sdpa_backend_ms(
        "prefill", lambda: sdpa(qh, kh, vh, is_causal=True))
    f["timer"] = {"ms": "events", "plain_ms": "events", "library_ms": t_lib}
    f["library"] = f"torch SDPA ({backend} backend), V of its own head dim"
    f["tflops"] = flops / f["ms"] / 1e9
    lib = "n/a" if f["library_ms"] is None else f"{f['library_ms']:.3f} ms"
    log(f"  B1-MLA prefill: kernel {f['ms']:.3f} ms ({f['tflops']:.1f} TFLOP/s), plain "
        f"{f['plain_ms']:.3f} ms, bound {f['bound_ms']:.3f} ms ({f['bound_by']}), "
        f"{f['library']} {lib} [{card}]")
    res["flash_fwd_mla"] = f
    return counts, res


# Kernels whose ptxas registers and spills ab_times reports ("flash_bwd"
# names the one-pass backward kernel and the two kernels it replaced).
AB_KERNELS = ("attention_fwd_kernel", "flash_decode_kernel", "mla_fwd_kernel",
              "mla_decode_kernel", "flash_bwd")


def ab_times(reps):
    """``--ab DIR``: one JSON line for the checkout at DIR (whose
    ``liteattention_torch`` is imported): the card, the registers and
    spills ptxas reported per kernel of ``AB_KERNELS``, the device time
    of B1 and of B3 with and without votes at the Wan slice's shape (1 x
    40 x 32 760 x 128 bf16, banded ~50 % mask), of the decode kernel B8
    with its split merge at the kvcache API's shape (device_ms), and of
    the whole backward ``flash_attention_bwd`` at the GPT-2 small shape
    (causal) and at the Wan width (1 x 40 x 8192 x 128, non-causal). It
    calls only entry points every version of the port has since the
    decode kernel, so checkouts can be timed in turns on one card (older,
    newer, newer, older)."""
    import re

    import torch
    from liteattention_torch.ops import _build
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_decode
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
    from liteattention_torch.ops.schedule_pack import pack_schedule

    card = nvidia_smi_line()
    regs, name = {}, None
    for line in _build.build_kernels().log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        name = m.group(1) if m else name
        m = re.search(r"Used (\d+) registers", line)
        if m and name and any(k in name for k in AB_KERNELS):
            regs[name] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and any(k in name for k in AB_KERNELS) and int(m.group(1)):
            regs[name + " spill bytes"] = int(m.group(1))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    h, s, d = 40, 32760, 128
    q, k, v = (torch.randn(1, h, s, d, generator=g, device=dev).bfloat16() for _ in range(3))
    kt = math.ceil(s / 128)
    mask = banded_mask(1, h, kt, kt, 0.5, dev)
    fidx, count = pack_schedule(mask)[:2]
    dq = torch.randn(API_B, API_HQ, 1, API_D, generator=g, device=dev).bfloat16()
    dk, dv = (torch.randn(API_B, API_CACHE, API_HK, API_D, generator=g, device=dev).bfloat16()
              for _ in range(2))
    b8_ms, b8_kernel_ms, b8_timer = device_ms(lambda: flash_attention_decode(dq, dk, dv),
                                              names=DECODE_KERNELS)

    def bwd_ms(shape, causal):
        bq, bk, bv, bdo = (torch.randn(*shape, generator=g, device=dev).bfloat16()
                           for _ in range(4))
        bo, blse = flash_attention(bq, bk, bv, causal=causal, return_lse=True)
        scale = shape[-1] ** -0.5
        return cuda_ms(lambda: flash_attention_bwd(bq, bk, bv, bo, blse, bdo, scale, causal), reps)

    bwd = {"bwd_gpt2_ms": bwd_ms((GPT_BATCH, 12, GPT_SEQ, 64), True),
           "bwd_wan_ms": bwd_ms(WAN_BWD_SHAPE, False)}
    print(json.dumps({
        "root": sys.path[0], "card": card, "registers": regs,
        "b1_ms": cuda_ms(lambda: flash_attention(q, k, v), reps),
        "b3_ms": cuda_ms(lambda: lite_flash_attention(q, k, v, fidx, count, -1.0, mask), reps),
        "b3_novote_ms": cuda_ms(lambda: lite_flash_attention(
            q, k, v, fidx, count, -1.0, mask, emit_votes=False), reps),
        "sparsity": 1.0 - mask.float().mean().item(),
        "b8_ms": b8_ms, "b8_kernel_ms": b8_kernel_ms, "b8_timer": b8_timer, **bwd,
    }))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ab"]:
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        return ab_times(int(sys.argv[3]) if len(sys.argv) > 3 else 10)
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
        kres["flash_fwd_causal"]["err"] = max(kres["flash_fwd_causal"]["err"],
                                              serve_flash_check(dev))
        kres.update(decode_kernel_phase(dev))
        log("phase 3: Wan2.1-14B-width denoising slice")
        counts = {"wan_denoise": slice_phase(dev, card, cfg, SLICE_GRID)}
        log("phase 4: GPT-2 small training slice")
        counts["gpt2_train"], train_stats = train_phase(dev, card)
        log("phase 5: Llama-3-8B-width serving slice")
        counts["serve"], serve_stats = serve_phase(dev, card)
        log("phase 6: the rest of the LiteAttention engine at Wan2.1-14B attention width")
        counts["engine"], eres, ext, engine_stats = engine_phase(dev, cfg, card)
        kres.update(eres)
        log("phase 7: MLA at DeepSeek-V3 width")
        counts["mla"], mres = mla_phase(dev, card)
        kres.update(mres)
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # flash_fwd's own numbers are the Wan shape's; the causal ones sit
    # under causal_gpt2 (times at GPT-2's shape; the error over both GPT
    # shapes and the serving path's prefill and verify shapes).
    causal = kres["flash_fwd_causal"]
    kres["flash_fwd"]["causal_gpt2"] = {
        "max_abs_err": causal["err"],
        **{k: causal[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    kres["flash_bwd_dq"]["fwd_bwd"] = kres["fwd_bwd"]
    # The new channels of B2 (kv_map) and B3 (compacted K/V), at (a)'s mask.
    kres["schedule_pack"]["kv_map"] = {
        "ms": ext["pack_ms_kv_map"], "ms_without": ext["pack_ms"],
        "bound_ms": ext["pack_bound_ms_kv_map"], "shape": f"(a)'s mask, sparsity {ext['a_sparsity']:.4f}"}
    kres["lite_flash_fwd"]["compacted_kv"] = {
        "ms": ext["lite_ms_compacted"], "ms_same_mask_uncompacted": ext["lite_ms_uncompacted"],
        "kv_compact_ms": kres["kv_compact"]["ms"], "shape": "(a)'s inputs and final mask"}
    # Each path's counted run read every wrapper's count (reset just before).
    by_path = {name: {path: c[0][name] for path, c in counts.items()}
               for name in kernel_wrappers()}
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    for name in counts["serve"][1]:
        merges = {path: c[1][name] for path, c in counts.items()}
        kres[name]["merge_launches"] = sum(merges.values())
        kres[name]["merge_launches_by_path"] = merges
    sources = {
        "flash_fwd": ("flash_fwd.cu", "liteattention_tpu/ops/flash_fwd.py:84"),
        "schedule_pack": ("schedule_pack.cu", "liteattention_tpu/ops/schedule_pack.py:52"),
        "lite_flash_fwd": ("lite_flash_fwd.cu", "liteattention_tpu/ops/lite_flash_fwd.py:376"),
        "lite_flash_fwd_coarse": ("lite_flash_fwd.cu", "liteattention_tpu/ops/lite_flash_fwd.py:123"),
        "lite_flash_fwd_hfold": ("lite_flash_fwd.cu", "liteattention_tpu/ops/lite_flash_fwd.py:885"),
        "kv_compact": ("kv_compact.cu", "liteattention_tpu/ops/kv_compact.py:81"),
        "flash_bwd_dq": ("flash_bwd.cu", "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_bwd_dkv": ("flash_bwd.cu", "liteattention_tpu/ops/flash_bwd.py:238"),
        "flash_decode": ("flash_decode.cu", "liteattention_tpu/ops/flash_fwd.py:843"),
        "paged_decode": ("flash_decode.cu", "liteattention_tpu/ops/paged_attention.py:40"),
        "paged_decode_folded": ("flash_decode.cu", "liteattention_tpu/ops/paged_attention.py:276"),
        "flash_fwd_mla": ("flash_fwd.cu", "liteattention_tpu/ops/flash_fwd.py:84"),
        "mla_decode": ("mla_decode.cu", "liteattention_tpu/ops/mla.py:52"),
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
    log(f"serving: {json.dumps(serve_stats)}")
    log(f"engine: {json.dumps(engine_stats)}")
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
