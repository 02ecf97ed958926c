#!/usr/bin/env python3
"""Smoke run of the PyTorch port (liteattention_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: the card's name and power limit (nvidia-smi), then the build
   of every kernel from ``liteattention_torch/ops/csrc`` (one nvcc per
   source, in parallel).
2. Kernels against their plain PyTorch versions on the card, bf16: the
   dense forward (B1), the schedule packer (B2: bit for bit; timed by
   device time and call time, beside an empty launch through the same
   ctypes path and one fill of as many bytes) and the sparse forward
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
   function (aten's flash backward for B7); B1 at the Wan self- and
   cross-attention shapes, causal at GPT-2 small and at the serving
   prefill (beside SDPA ``enable_gqa`` where a backend takes it), by CUDA
   events and by profiler device time.
3. The denoising slice: the Wan2.1-14B DiT (full width, depth cut to 2
   blocks, random weights from a seed) denoising a 480p 81-frame latent
   (21 x 60 x 104 -> 32 760 tokens) with CFG, 4 steps, vote_stride 2,
   three ways: (a) dense, (b) lite from a full mask at threshold -inf,
   which must match (a), (c) lite from banded ~50% masks and a
   thresholded run. The launch counters of B1-B3 must move. A small model
   is also checked on the card against the plain versions on the CPU.
   Then (i) Wan2.1-I2V-14B (in_channels 36 = 16 + 20 conditioning
   channels, decoupled image K/V over 257 x 1280 CLIP tokens, 2 blocks,
   the same grid, CFG, 4 steps): B1 at the image branch's shape (1 x 40 x
   32 760 x 128, Sk 257) against its plain version (out, lse, every
   128-row block) and timed beside SDPA; dense, lite from a full mask at
   -inf (must match dense) and lite from banded masks; and (ii) Wan2.2-
   T2V-A14B, two experts of the 14B geometry (2 blocks each, their own
   seeds) through ``denoise_two_expert`` (4 steps, boundary 0.875: the
   switch after step 2): dense, lite at -inf (must match dense), and lite
   voting at thr 0 before the switch and -10 after it, where the sparsity
   the high-noise steps reach must not drop at the switch (masks restarted
   from full would read about 0). B1, B2 and B3 must launch in each.
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
   plain version and SDPA (``enable_gqa``: with a boolean key-padding mask
   at the ragged lengths, and at uniform full lengths). A small
   LLaMA's card decode is held against the CPU plain path, teacher-forced.
   Then a Llama-3-8B-width server (full width and depth, random weights
   from a seed) answers 8 requests of 1024-token prompts: greedy decoding
   of 64 tokens into a 2048-token cache, the same with the int8 cache,
   batch-1 speculative decoding with a 2-layer draft (lookahead 3, 32
   tokens), and the kvcache API in its four forms plus the head-major
   paged entry. The decode kernel must launch once per layer per decode
   step, with its split merge inside it (no merge kernel in the
   profile). Reported: prefill and decode ms, tokens/s, peak memory, the
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
   -inf); the run must launch B10 once a call and, as torch.profiler
   counts the kernels of its decode calls, no merge kernel (the split
   merge runs inside the launch); (b) ``flash_attn_func`` at the prefill shape, 2 prompts x 4096
   tokens x 128 heads at (q/k 192, v 128), causal (B1's kernel at D 192
   and Dv 128), and at the absorbed shapes at V 512, one 4096-token
   prompt x 128 heads on one KV head, causal: (576, 512) and (64, 512) +
   qv (the split-O kernel), each against its plain version over all
   heads, plus small checks (Sq > Sk, GQA, ragged tails); (c) the
   kernels' times beside their bounds, plain versions and SDPA (the
   backend that ran is named).
8. Wan training and threshold calibration at Wan2.1-14B width: (a) B7
   at the training step's shapes, self-attention over the slice's 32 760
   tokens (a ragged last key tile) and the text cross-attention (Sq 32 760,
   Sk 512), non-causal, against its plain versions and timed; (b) the
   rectified-flow step of ``examples/torch_structured_calibration.py`` on
   the 2-block slice (0.94 B fp32 master weights, bf16 products), 3 AdamW
   steps with remat on one fixed batch (the loss must fall; 4 B1 and 2 B7
   launches a block a step), then one forward and backward with and
   without remat at the same weights (ms, peak memory; gradients in
   agreement); (c) the attention probe (64 rows) at that width, its
   entropy's gradient reaching the q projection; (d)
   ``calibrate_constant_threshold`` on the phase-3 slice (4 steps, CFG,
   budget 0.05, 3 bisection steps), every probe printed; (e)
   ``examples/torch_structured_calibration.py`` at its 4096-token
   settings: the trained proxy's sweep and calibrated schedule; (f)
   ``examples/torch_wan_e2e_speed.py --modes band --steps 2`` at 73 728
   tokens. In (b)-(f) every plain version raises: the runs launch the
   kernels or fail.
10. (Runs after 8, before the result lines of 9.) ALiBi and padded-batch
   serving, on B1's per-batch channels: (a) B1 with ``kv_bound`` /
   ``kv_low`` / ``bound_causal`` and with ALiBi against its plain version
   (out, lse and every 128-row block) at BERT-large's attention (32 x 16 x
   512 x 64, right-padded lengths), a left-padded cache append (8 x 32/8 x
   1024 x 128 over 4096 keys), Baichuan2-13B's ALiBi prefill over its cache,
   its single-token steps at ragged bounds and a verify step (Sq 4), non-
   causal ALiBi with [B, H] slopes at scale 1/d, and rows that see no key;
   the paths' shapes timed beside their bounds (visible key pairs only),
   the plain version and SDPA with the equivalent mask (backend named);
   (b) Baichuan2-13B (full width and depth: 40 layers, 40 heads of 128,
   ffn 13 696, vocab 125 696, random weights from a seed, fp32 master
   weights) serving 4 requests of 1024-token prompts, 64 greedy tokens into
   a 2048-token cache and batch-1 speculative decoding (a 2-layer draft
   sharing its weights, lookahead 3): every step on B1's ALiBi channel, no
   decode-kernel launch; a small 10-head ALiBi model teacher-forced against
   the CPU; the decode logits against a full recompute, with the two
   planted cache faults read above its limit; (c) BERT-large
   (``BertForPreTraining``, 24 layers, 1024 wide) over 32 sequences
   right-padded to 512: 24 bound launches a forward, each sequence's rows
   equal to the sequence alone; (d) ``flash_attn_func`` and
   ``flash_attn_qkvpacked_func`` with ``alibi_slopes`` against the plain
   version.
11. (Runs after 10.) Training through B1's and B7's per-batch channels:
   (a) B7 with ``kv_bound`` / ``kv_low`` / ``bound_causal`` and with ALiBi
   against B7a's / B7b's plain versions (rel-L2 over each tensor and every
   128-row block; dK/dV bit-stable over two runs and exactly 0 on keys no
   row sees, dQ exactly 0 on rows with no key) at BERT-large's attention
   (32 x 16 x 512 x 64, lengths 64-512), a GQA cache append (8 x 32/8 x
   1024 x 128 over 4096 keys, bound + low + bound_causal), the edges,
   Baichuan2-13B's training shape (4 x 40 x 2048 x 128, causal ALiBi),
   ALiBi + bound_causal over two cache capacities (the valid keys'
   gradients compared across them), and non-causal ALiBi with [B, H]
   slopes at scale 1/d; the paths' shapes timed beside their bounds, the
   plain version and SDPA's backward with the equivalent mask or bias;
   (b) BERT-large pretraining (MLM + NSP) on phase 10's padded batch, fp32
   master weights, 5 AdamW steps (24 bound launches of B1 and of B7 a
   step; the loss falls; a few sequences' gradient alone equals their
   share of the padded batch's); (c) a Baichuan2-13B-width ALiBi GPT (2
   of its 40 layers, 1.92 B parameters) on 4 x 2048 tokens, 3 AdamW steps
   through ``training/trainer.py`` (2 ALiBi launches of B1 and of B7 a
   step; the loss falls); (d) small ALiBi GPTs (6 heads of 64, 3 of 128)
   and a small BERT, one step on the card against the CPU; (e) the
   gradient of ``flash_attn_func`` / ``flash_attn_qkvpacked_func`` with
   ``alibi_slopes`` against the plain versions.
12. (Runs after 11.) Head dims 80 and 96, and BTLM-3B-8K on the card: (a)
   B1 and B7 against their plain versions (rel-L2 over each tensor and
   every 128-row block; dK/dV bit for bit over two runs) at BTLM's shapes,
   head dim 80 -- the ALiBi prefill of 8 x 32 x 4096 over an 8192-key
   cache with bound_causal, its single-token steps at bounds 4097-4160,
   causal ALiBi and channel-free causal over one 8192-token training
   sequence -- and at GPT-NeoX-20B's attention, 4 x 64 x 2048 x 96 causal
   (head dim 96); each timed beside its bound, its plain version and one
   SDPA call; (b) a small BTLM at head dim 80 on the card against the CPU
   (decode teacher-forced, one training step), then BTLM-3B-8K (cerebras/
   btlm-3b-8k-base config.json: 2560 wide, 32 layers, 32 heads of 80,
   ALiBi, SwiGLU ffn 6826 passed explicitly, vocab 50 257, muP, scale 1/d;
   2.65 B random fp32 parameters) serving 8 requests of 4096-token prompts,
   64 greedy tokens each into an 8192-token cache: one ALiBi B1 launch a
   layer a model call and no decode-kernel launch; the decode logits
   against a full recompute, two planted faults read above its limit; (c)
   the same model trained on one repeated 8192-token sequence through
   ``training/trainer.py``, remat, AdamW, 3 steps (32 ALiBi B7 launches a
   step; the loss falls).
13. (Runs after 12.) Packed documents through the varlen functions, B1's
   and B7's segment channel: (a) BERT-large's phase-10 batch (32 x 512,
   8 916 valid tokens, 16 heads of 64) through ``unpad_input`` ->
   ``flash_attn_varlen_func`` -> ``pad_input`` against B1's and B7's bound
   channel over the padded batch (valid rows, gradients); Llama-3-8B's
   attention (32 / 8 heads of 128) over 16 384 tokens of causal documents
   of seeded lengths 128-4096 and BTLM-3B-8K's (32 heads of 80, scale 1/d)
   over 8192 tokens of lengths 256-4096, against each document alone
   through causal B1 / B7 (rel-L2 within 1e-2); at each shape B1 and B7
   with the segment ids against their plain versions (out, lse and
   gradients, every 128-row block; dK / dV bit for bit over two runs),
   timed beside their bound over the visible pairs, the plain versions
   and SDPA's efficient backend with the block-diagonal mask; at the Llama
   shape the segment kernel under 0.6x causal B1 over all the tokens as
   one sequence, ``seqused_q`` / ``seqused_k`` with ``attention_chunk``
   1024 (dead rows give out 0 and lse -inf) and (b) the kvpacked and
   qkvpacked forms bit-equal to the unpacked call; then the counted run:
   the three shapes' varlen calls forward and backward, 3 segment launches
   each of B1 and B7 and no other B1 / B7 launch.
14. (Runs after 13.) Head dim 256 and GPT-J-6B on the card: (a) B1, B7 and
   the decode kernel at head dim 256 against their plain versions, each
   timed beside its bound, its plain version and one library call: causal
   B1 and B7 at GPT-J training's attention (2 x 16 x 2048 x 256; SDPA
   flash, aten's flash backward), B1 with the bound and bound_causal at its
   serving prefill (8 x 16 x 1024 over a 2048-slot cache; SDPA with a
   boolean mask), B8 bf16 over that cache at ragged and full lengths (SDPA
   with a key-padding mask) and int8, and B9b over native pools of 64-token
   pages; (b) a small GPT-J-shaped model (dim 512, 2 heads of 256, 2
   layers, vocab 1000, interleaved rotary 64) on the card against the CPU:
   the forward, one training step's loss and gradients, and greedy decoding
   with a cache, teacher-forced; (c) GPT-J-6B (EleutherAI/gpt-j-6b
   config.json through ``gptj_config()``: 28 layers, 6.05 B random fp32
   parameters) serving 8 requests of 1024-token prompts, 32 greedy tokens
   into a 2048-token cache, with a bf16 and with an int8 cache: one bound
   B1 launch a layer at each prefill and one decode-kernel launch a layer
   a step; each run's decode logits against a full recompute (and the two
   planted faults), the device's and the decode kernel's share of five
   profiled decode steps; (d) its first 8 layers at full width trained
   with remat, AdamW, on 2 x 2048 tokens for 3 steps through
   ``training/trainer.py`` (2 B1 and 1 B7 launches a layer a step; finite
   losses). The kernels line gains the D 256 rows, their launches read on
   (c)'s and (d)'s counted runs.
15. (Runs after 14.) Attention dropout, B1's and B7's dropout
   instantiations: (a) B1's keep mask read back through the kernel bit for
   bit (q = k = 0, V one-hot over 64 keys made visible by kv_low / kv_bound:
   every output is keep / (1 - p) / 64), against ``dropout_keep_mask`` at
   every (b, h), rows into the thousands, key offsets 0, 128 and 960, p 0.1
   and 0.5, head dims 64 and 128, the dropped share within 4 sigma of p;
   (b) causal B1 and B7 with dropout 0.1 against their plain versions at
   GPT-2 XL's attention (8 x 25 x 1024 x 64) and Llama-3-8B's (4 x 32/8 x
   2048 x 128): out, lse (dropout-free), dQ / dK / dV (dK, dV bit-stable),
   each timed beside its operation and integer-issue bounds, the plain
   version, the kernel without dropout and SDPA's flash kernels with
   dropout; (c) GPT-2 XL (openai-community/gpt2-xl config.json through
   ``gpt2_config(dim=1600, num_layers=48, num_heads=25)``: 1.56 B random
   fp32 parameters, full width and depth, dropout 0.1) on 8 x 1024 tokens,
   5 AdamW steps with ``deterministic=False`` and a seeded CUDA generator
   (48 dropout launches of B1 and of B7 a step; the loss falls), one
   ``deterministic=True`` forward equal to a dropout-0 model's logits, and
   the same steps at dropout 0. The kernels line gains the dropout rows.
9. A JSON line of kernel results (launches read on each path's counted
   run, every counter set to 0 just before it), the nvidia-smi line, and
   the result line ``{"ok": true, "device": {...}}``.

It needs nothing but the repository, PyTorch built for CUDA and nvcc.

    python3 chip_smoke.py --ab DIR [REPS]

times B1 (at four shapes), B2 (device and call time, with and without
``kv_map``, beside an empty ctypes launch and a fill of as many bytes), B3, B4 (coarse and super-tile), B5, the decode
kernel (B8 full and ragged, bf16 and int8, B9b paged), the MLA decode B10
(ragged permuted pages and full lengths, beside SDPA), B1's MLA kernels
at phase 7's three shapes, B6 (beside ``index_select``) and the backward
B7 of the checkout at DIR instead, with digests of B1's, B3's and B5's
outputs and of B2's (see ``ab_times``): to compare two checkouts on one card, run it
for each in turns in one job.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import statistics
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
# rel-L2 of B1's output over every (b, h, 128-row block) against its plain
# version (bf16 output, P rounded to bf16 before PV), where a shape is
# checked block by block.
B1_BLOCK_TOL = 2e-2
SMALL_FWD_TOL = 2e-2  # rel-L2 of a small bf16 model forward on the card vs fp32 CPU
SMALL_DENOISE_TOL = 5e-2  # same for a 3-step CFG denoise (CFG amplifies error)
# B7: rel-L2 of each of dq, dk, dv over the whole tensor, and over every
# (b, h, 128-row block), so that one wrong tile cannot hide (bf16 grads,
# P and dS rounded to bf16 before their products).
BWD_TOL = 1e-2
BWD_BLOCK_TOL = 2e-2
# B7 with ALiBi: a key block far from every row it meets under a steep slope
# has P below 2^-126, which the card's exp2 flushes to 0 (ex2.approx.ftz)
# where the fp32 plain version keeps subnormals. So B7's channel checks take
# each block's error against at least 2^-100 of the whole tensor's norm:
# a wrong tile still reads as large as its error.
BWD_BLOCK_FLOOR = 2.0**-100
# B7 at the Wan2.1-14B attention width: batch, heads, tokens, head dim;
# the training step's tokens (the slice's 21 x 30 x 52 patches).
WAN_BWD_SHAPE = (1, 40, 8192, 128)
WAN_TRAIN_TOKENS = 32760
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
# The decode kernel, and the merge kernel older checkouts launch after it.
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
    ``names``, the timer). The first is ``queued_ms``: CUDA events around
    calls queued behind a busy wait, so host time between calls does not
    count (timer ``"queued_events"``; ``"events"`` for a call that waits
    on the device itself). The second is torch.profiler's device time of
    the named kernels, None where no names are given or the profile
    recorded fewer of their launches than calls (on an H100 under torch
    2.11 it sometimes records none midway through a run, or one call's
    worth of twenty; the cause was not found), so that no time is taken
    from a profile that missed launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    total, timer = queued_ms(fn, reps)
    if not names:
        return total, None, timer
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        picked, launches = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and any(n in e.key for n in names)):
                picked += e.self_device_time_total / 1e3
                launches += e.count
        if launches >= reps:
            return total, picked / reps, timer
    log("  torch.profiler recorded fewer launches than calls in 3 tries: the named kernels' "
        "share is not measured")
    return total, None, timer


def fmt_ms(ms, digits=4):
    """A time for the log, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def queued_ms(fn, reps):
    """Device time per call of ``fn`` by CUDA events, with the device held
    in a busy wait while the host enqueues every call, so that host time
    between calls does not count: (ms, ``"queued_events"``). The wait is
    sized from one warm call's host time (a first call may load code or
    build a library's plan, a second or more of host time that would
    size a wait of minutes) and must still be running when the last call
    is queued (checked; one retry with a wait 8x as long). A call that
    waits on the device itself ends the wait early: it is then timed by
    plain events over back-to-back calls, (ms, ``"events"``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wait_ms = max(50.0, 4.0 * reps * host_ms)
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(wait_ms * 2e6))  # cycles: >= wait_ms at up to 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the device still waits: every call queued behind it
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, "queued_events"
        wait_ms *= 8
    return cuda_ms(fn, reps), "events"


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


def block_rel_l2(got, ref, rows=128, floor=0.0):
    """rel-L2 of ``got`` against ``ref`` ([B, H, S, D]) over the whole
    tensor and the worst over (b, h, ``rows``-row block); a block whose
    reference is 0 must be 0 too. With ``floor`` a block's error is taken
    against at least ``floor`` times the whole reference's norm."""
    import torch

    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % rows)
    g = torch.nn.functional.pad(got.double(), pad).reshape(b, h, -1, rows * d)
    r = torch.nn.functional.pad(ref.double(), pad).reshape(b, h, -1, rows * d)
    num, den = (g - r).norm(dim=-1), r.norm(dim=-1)
    if floor:
        den = den.clamp_min(floor * r.norm().item())
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
    counts B3, B5 and B4 apart, flash_attention B1, B1 with its per-batch
    bound / low channels, B1 with ALiBi, B1 at the MLA prefill shape (192,
    128), the split-O MLA kernel at V 512 and B1 with dropout; flash_bwd
    B7, B7 with the bound / low channels, B7 with ALiBi and B7 with
    dropout)."""
    from liteattention_torch.ops.flash_bwd import flash_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_decode
    from liteattention_torch.ops.kv_compact import compact_kv
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
    from liteattention_torch.ops.mla import mla_decode
    from liteattention_torch.ops.paged_attention import paged_attention, paged_attention_folded
    from liteattention_torch.ops.schedule_pack import pack_schedule

    return {"flash_fwd": (flash_attention, "launches"),
            "flash_fwd_bound": (flash_attention, "bound_launches"),
            "flash_fwd_alibi": (flash_attention, "alibi_launches"),
            "flash_fwd_mla": (flash_attention, "mla_launches"),
            "flash_fwd_mla_v512": (flash_attention, "mla_v512_launches"),
            "flash_fwd_segments": (flash_attention, "segment_launches"),
            "schedule_pack": (pack_schedule, "launches"),
            "lite_flash_fwd": (lite_flash_attention, "launches"),
            "lite_flash_fwd_coarse": (lite_flash_attention, "coarse_launches"),
            "lite_flash_fwd_hfold": (lite_flash_attention, "hfold_launches"),
            "kv_compact": (compact_kv, "launches"),
            "flash_bwd_dq": (flash_bwd, "launches"),
            "flash_bwd_dkv": (flash_bwd, "launches"),
            "flash_bwd_bound": (flash_bwd, "bound_launches"),
            "flash_bwd_alibi": (flash_bwd, "alibi_launches"),
            "flash_bwd_segments": (flash_bwd, "segment_launches"),
            "flash_fwd_dropout": (flash_attention, "dropout_launches"),
            "flash_bwd_dropout": (flash_bwd, "dropout_launches"),
            "flash_decode": (flash_attention_decode, "launches"),
            "paged_decode": (paged_attention, "launches"),
            "paged_decode_folded": (paged_attention_folded, "launches"),
            "mla_decode": (mla_decode, "launches")}


def reset_counts():
    """Set every wrapper's launch counts to 0 (just before a path's
    counted run)."""
    for fn, attr in kernel_wrappers().values():
        setattr(fn, attr, 0)


def read_counts():
    """Every wrapper's launch count (just after a path's counted run)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_wrappers().items()}


def kernel_launches(fn):
    """``fn()`` under torch.profiler: (its result, {CUDA kernel name:
    launches recorded})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ret = fn()
        torch.cuda.synchronize()
    return ret, {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)}


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


def check_flash(q, k, v, label, causal=False, time_it=False, blocks=False):
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain
    from torch.nn.attention import SDPBackend, sdpa_kernel

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
    if blocks:
        res["rel_l2"], res["worst_block_rel_l2"] = block_rel_l2(out, ro)
        log(f"  B1 {label}: rel-L2 {res['rel_l2']:.3e}, worst (b, h, 128-row block) "
            f"{res['worst_block_rel_l2']:.3e} (tolerance {B1_BLOCK_TOL})")
        check(res["worst_block_rel_l2"] < B1_BLOCK_TOL, f"B1 {label}: a 128-row block disagrees")
    if time_it:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        call = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        res["ms"] = cuda_ms(call)
        # Device time beside the events: at small shapes the events follow
        # the host.
        res["device_ms"], _, res["timer"] = device_ms(call)
        res["plain_ms"] = cuda_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal), reps=1
        )
        res["bound_ms"], res["bound_by"] = bound(
            4 * d * attn_pairs(sq, sk, causal) * b * h, nbytes(q, k, v, out, lse)
        )
        # SDPA aligns causal masks top-left: comparable only when Sq == Sk.
        res["library_ms"], res["library"] = None, None
        if sq == sk or not causal:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            if k.shape[1] == h:
                res["library_ms"], res["library"] = sdpa_ms(q, k, v, causal), "SDPA flash (events)"
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    res["library_device_ms"] = device_ms(lambda: sdpa(q, k, v, is_causal=causal))[0]
            else:
                backend, res["library_ms"], timer = sdpa_backend_ms(
                    f"B1 {label}", lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
                if backend is not None:
                    res["library"] = f"SDPA {backend} enable_gqa ({timer})"
        lib = "n/a" if res["library"] is None else f"{res['library_ms']:.4f} ms {res['library']}"
        log(f"  B1 {label}: kernel {res['ms']:.4f} ms (events), {fmt_ms(res['device_ms'])} "
            f"({res['timer']}), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}), library {lib}")
    return res


def sdpa_bwd(q, k, v, dout, causal, dropout_p=0.0):
    """aten's flash-attention backward on ``q, k, v, dout`` (from its own
    forward's out and lse, with its own Philox dropout at ``dropout_p``):
    dq, dk, dv in one call."""
    import torch

    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, off, _ = aten._scaled_dot_product_flash_attention(
        q, k, v, dropout_p, causal, False
    )
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        dout, q, k, v, out, lse, cq, ck, mq, mk, dropout_p, causal, seed, off
    )


def verify_bwd(label, q, k, v, dout, kw, floor=0.0):
    """The one-pass backward B7 (``flash_attention_bwd``: delta, the main
    kernel, dQ to bf16) on B1's out / lse with the same channels (``kw``:
    causal, scale and B1's kv_bound, kv_low, bound_causal, alibi_slopes,
    segments, dropout_p and dropout_seed; the inputs the training path
    gives it): dq against B7a's plain
    version, dk / dv against B7b's, by rel-L2 over each tensor and every
    (b, h, 128-row block) (``floor``: block_rel_l2's); dk / dv bit-stable
    over two runs and exactly 0 on keys no row sees, dq exactly 0 on rows
    that see no key and held by the same rel-L2 on a second run (summed
    across CTAs by atomics in no fixed order). Returns the backward's
    arguments, its channels, (dq, dk, dv), the max abs errors and the
    rel-L2s."""
    import torch
    from liteattention_torch.ops.flash_bwd import (
        flash_attention_bwd,
        flash_bwd_dkv_plain,
        flash_bwd_dq_plain,
    )
    from liteattention_torch.ops.flash_fwd import flash_attention_masked

    b, d, sk = q.shape[0], q.shape[-1], k.shape[2]
    causal = kw.get("causal", False)
    scale = kw.get("scale") or d**-0.5
    ch = {n: kw[n] for n in ("kv_bound", "kv_low", "bound_causal", "alibi_slopes", "q_segments",
                             "kv_segments", "dropout_p", "dropout_seed") if n in kw}
    out, lse = flash_attention_masked(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout, scale, causal)
    dq, dk, dv = flash_attention_bwd(*args, **ch)
    torch.cuda.synchronize()
    delta = (out.float() * dout.float()).sum(-1)
    pargs = (q, k, v, dout, lse, delta, scale, causal)
    rq = flash_bwd_dq_plain(*pargs, **ch)
    rk, rv = flash_bwd_dkv_plain(*pargs, **ch)
    errs, rels = {}, {}
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[name] = (got.float() - ref.float()).abs().max().item()
        rels[name] = block_rel_l2(got, ref, floor=floor)
    del rk, rv
    dq2, dk2, dv2 = flash_attention_bwd(*args, **ch)
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"B7 {label}: dK/dV not bit-stable")
    rels["dq (2nd run)"] = block_rel_l2(dq2, rq, floor=floor)
    del dq2, dk2, dv2, rq
    msg = (f"  B7 {label}: rel-L2 tensor / worst (b, h, 128-row block): "
           + ", ".join(f"{n} {t:.2e} / {w:.2e}" for n, (t, w) in rels.items())
           + "; max abs err " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
           + " (dK, dV bit-stable over two runs")
    hidden = hidden_keys(b, sk, q.device, ch.get("kv_bound"), ch.get("kv_low"),
                         ch.get("q_segments"), ch.get("kv_segments"))
    if hidden.any():
        zero = max(g.transpose(1, 2)[hidden].abs().max().item() for g in (dk, dv))
        check(zero == 0.0, f"B7 {label}: keys no row sees got dK/dV {zero:.3e}, not 0")
        msg += f"; {int(hidden.sum())} key rows no row sees: dK, dV exactly 0"
    empty = ~torch.isfinite(lse)
    if empty.any():
        check(dq[empty].abs().max().item() == 0.0, f"B7 {label}: a row with no key has dQ != 0")
        msg += f"; {int(empty.sum())} rows with no key: dQ exactly 0"
    log(msg + ")")
    for name, (tensor, block) in rels.items():
        check(tensor < BWD_TOL and block < BWD_BLOCK_TOL,
              f"B7 {label}: {name} rel-L2 {tensor:.3e} / block {block:.3e}")
    return args, ch, (dq, dk, dv), errs, rels


def check_bwd(q, k, v, dout, label, causal, time_it=False):
    """B7 without channels, checked by ``verify_bwd``; with ``time_it``
    also timed whole and beside aten's flash backward."""
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd, flash_bwd_plain
    from liteattention_torch.ops.flash_fwd import flash_attention

    b, h, sq, d = q.shape
    sk = k.shape[2]
    args, _, (dq, dk, dv), errs, rels = verify_bwd(label, q, k, v, dout, dict(causal=causal))
    out, lse = args[3], args[4]
    res = {
        "flash_bwd_dq": {"err": errs["dq"], "rel_l2": max(rels["dq"][0], rels["dq (2nd run)"][0]),
                         "worst_block_rel_l2": max(rels["dq"][1], rels["dq (2nd run)"][1])},
        "flash_bwd_dkv": {"err": max(errs["dk"], errs["dv"]),
                          "rel_l2": max(rels["dk"][0], rels["dv"][0]),
                          "worst_block_rel_l2": max(rels["dk"][1], rels["dv"][1])},
    }
    if time_it:
        # The whole backward (pre + main + post) as the autograd Function
        # runs it; its bound counts the work the inputs need: S, dP, dV, dK
        # and dQ (10 d FLOPs per pair), q, k, v, o, dO, lse read once and
        # dq, dk, dv written once.
        ms = cuda_ms(lambda: flash_attention_bwd(*args), reps=20)
        # Device time of the three launches, and the main kernel's share.
        dev_ms, main_ms, timer = device_ms(lambda: flash_attention_bwd(*args),
                                           names=("flash_bwd_kernel", "flash_bwd_d256_kernel"))
        plain_ms = cuda_ms(lambda: flash_bwd_plain(*args), reps=1)
        bound_ms, bound_by = bound(10 * d * attn_pairs(sq, sk, causal) * b * h,
                                   nbytes(q, k, v, out, dout, lse, dq, dk, dv))
        # aten's flash backward computes dq, dk and dv in one call; it aligns
        # causal masks top-left, so a causal shape compares only at Sq == Sk.
        lib = lib_err = None
        if k.shape[1] == h and (sq == sk or not causal):
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


def check_pack(m, label, time_it=False, kv_map=None):
    """B2 bit-equal to its plain version on ``m`` (and ``kv_map``); with
    ``time_it`` its device time (queued_ms: the kernel alone, host time
    between calls left out), its call time (CUDA events around back-to-back
    calls of the wrapper: the host's time per call at this size) and, beside
    them, an empty kernel launched through the same ctypes path (call and
    device time) and one fill of as many bytes as B2 writes (device
    time)."""
    import torch
    from liteattention_torch.ops.schedule_pack import (
        noop_launch,
        pack_schedule,
        pack_schedule_plain,
    )

    extra = () if kv_map is None else (kv_map,)
    got = pack_schedule(m, *extra)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, pack_schedule_plain(m, *extra)))
    log(f"  B2 {label} {tuple(m.shape)}{' with kv_map' if extra else ''}: exact {same}")
    check(same, f"B2 {label} disagrees")
    res = {"err": 0.0}
    if time_it:
        call = lambda: pack_schedule(m, *extra)  # noqa: E731
        res["ms"], _, res["timer"] = device_ms(call, reps=50)
        res["call_ms"] = cuda_ms(call, reps=50)
        res["noop_call_ms"] = cuda_ms(lambda: noop_launch(m.device), reps=50)
        res["noop_ms"] = queued_ms(lambda: noop_launch(m.device), 50)[0]
        # The card's rate for the bytes B2 writes: one fill of as many bytes.
        sink = torch.empty(sum(x.numel() for x in got), dtype=torch.int32, device=m.device)
        res["fill_ms"] = queued_ms(lambda: sink.fill_(1), 50)[0]
        res["plain_ms"] = cuda_ms(lambda: pack_schedule_plain(m, *extra), reps=5)
        res["bound_ms"], res["bound_by"] = bound(0, nbytes(m, *got, *extra))
        res["library_ms"] = None
        log(f"  B2 {label}: device {res['ms']:.5f} ms ({res['timer']}), call {res['call_ms']:.4f} "
            f"ms (events; an empty launch through ctypes: call {res['noop_call_ms']:.4f} ms, device "
            f"{res['noop_ms']:.5f} ms; one fill of as many bytes {res['fill_ms']:.5f} ms), plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.5f} ms ({res['bound_by']}), "
            f"{res['bound_ms'] / res['ms']:.1%} of it")
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
    log(f"  launches during the slice: {counts}")
    check(all(counts[n] > 0 for n in ("flash_fwd", "schedule_pack", "lite_flash_fwd")),
          "a kernel of the path never launched")
    log(f"  ms/step [{card}]: (a) {ms_a:.1f}, (b) {ms_b:.1f}, (c1) {ms_c1:.1f}, "
        f"(c2) {ms_c2:.1f}")
    return counts


# Wan2.1-I2V-14B (Wan-Video/Wan2.1 wan/configs/wan_i2v_14B.py): the 14B
# geometry with in_dim 36 = 16 noise + 20 conditioning channels, decoupled
# image K/V, and 257 CLIP ViT-H/14 tokens of width 1280. Wan2.2-T2V-A14B:
# two experts of the 14B geometry, switched at sigma 0.875.
I2V_COND, I2V_IMAGE_TOKENS, I2V_IMAGE_DIM = 20, 257, 1280
TWO_EXPERT_BOUNDARY = 0.875
PHASE3_STEPS = 4


def timed_denoise(label, card, call, steps):
    """``call()`` -> (latents, telemetry), timed on the host around a
    synchronized run: (latents, sparsity per step, ms/step, telemetry)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, tel = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    sp = [float(v) for v in tel["sparsity_per_step"]]
    finite = bool(torch.isfinite(x).all())
    log(f"  ({label}) {ms:.1f} ms/step, sparsity per step {[round(v, 4) for v in sp]}, "
        f"finite {finite} [{card}]")
    check(finite, f"({label}) output not finite")
    return x, sp, ms, tel


def check_path_counts(label):
    """The counted run's launches (read just after it): B1, B2 and B3 must
    each have launched."""
    counts = read_counts()
    log(f"  launches during {label}: {counts}")
    check(all(counts[n] > 0 for n in ("flash_fwd", "schedule_pack", "lite_flash_fwd")),
          f"{label}: a kernel of the path never launched")
    return counts


def i2v_phase(dev, card, full, grid):
    """Configuration (i): Wan2.1-I2V-14B at full width, depth cut to 2
    blocks, random weights from a seed; B1 at the image branch's Sk 257 held
    against its plain version, then the counted run: (a) dense, (b) lite
    from a full mask at -inf (must match (a)), (c) lite from banded masks."""
    import torch
    from liteattention_torch.models import WanModel, denoise
    from liteattention_torch.ops.mask import SkipMaskState

    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS, in_channels=16 + I2V_COND,
                              i2v_decoupled=True)
    log(f"  Wan2.1-I2V-14B: dim {cfg.dim}, {cfg.num_heads} heads x {cfg.head_dim}, in_channels "
        f"{cfg.in_channels} (16 + {I2V_COND}), decoupled image K/V, {I2V_IMAGE_TOKENS} x "
        f"{I2V_IMAGE_DIM} image tokens; depth cut {full.num_layers} -> {cfg.num_layers} blocks")
    g = torch.Generator(device=dev).manual_seed(11)
    frames, hh, ww = grid
    n_tok = frames * (hh // 2) * (ww // 2)
    h, d = cfg.num_heads, cfg.head_dim

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    b1 = check_flash(rnd(1, h, n_tok, d), rnd(1, h, I2V_IMAGE_TOKENS, d),
                     rnd(1, h, I2V_IMAGE_TOKENS, d),
                     f"image cross 1x{h}x{n_tok}x{d} Sk={I2V_IMAGE_TOKENS}", time_it=True,
                     blocks=True)
    model = WanModel(cfg, device=dev, image_dim=I2V_IMAGE_DIM)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(10))
    model.requires_grad_(False)
    noise = rnd(1, frames, hh, ww, 16)
    cond = rnd(1, frames, hh, ww, I2V_COND)
    img = rnd(1, I2V_IMAGE_TOKENS, I2V_IMAGE_DIM)
    text, null = rnd(1, cfg.text_len, cfg.text_dim), rnd(1, cfg.text_len, cfg.text_dim)
    steps = PHASE3_STEPS
    common = dict(num_steps=steps, guidance_scale=5.0, vote_stride=2, image_ctx=img,
                  latent_cond=cond)

    def run(label, **kw):
        return timed_denoise(label, card, lambda: denoise(model, noise, text, null, **common,
                                                           **kw), steps)

    denoise(model, noise, text, null, num_steps=1, enable_skipping=False, image_ctx=img,
            latent_cond=cond)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    xa, _, ms_a, _ = run("i.a: I2V dense", enable_skipping=False)
    xb, sp_b, ms_b, _ = run("i.b: I2V lite, full mask, thr -inf", thresholds=[-math.inf] * steps)
    e_ab = rel_l2(xb.float(), xa.float())
    log(f"  (i.b) vs (i.a) rel-L2 {e_ab:.3e} (tolerance {SLICE_AB_TOL})")
    check(xa.shape == noise.shape and e_ab < SLICE_AB_TOL and max(sp_b) == 0.0,
          "(i.b) does not match (i.a)")
    kt = math.ceil(n_tok / 128)
    band = banded_mask(1, h, kt, kt, 0.5, dev)
    band_sparsity = 1.0 - band.float().mean().item()
    states = {i: SkipMaskState(band, 0) for i in range(cfg.num_layers)}
    _, sp_c, ms_c, _ = run(f"i.c: I2V lite, banded masks at {band_sparsity:.3f}, thr -10",
                           thresholds=[-10.0] * steps, initial_states=dict(states),
                           initial_states_uncond=dict(states))
    check(sp_c[0] >= band_sparsity - 1e-6, "(i.c) lost its sparsity")
    torch.cuda.synchronize()
    counts = check_path_counts("the I2V run")
    log(f"  I2V ms/step [{card}]: (a) {ms_a:.1f}, (b) {ms_b:.1f}, (c) {ms_c:.1f}")
    return counts, b1, {"ms_per_step": {"dense": ms_a, "lite_full_mask": ms_b,
                                        "lite_banded": ms_c},
                        "b_vs_a_rel_l2": e_ab, "sparsity_banded": sp_c}


def two_expert_phase(dev, card, full, grid):
    """Configuration (ii): Wan2.2-T2V-A14B's two experts, each the 14B
    geometry cut to 2 blocks with its own seed, through
    ``denoise_two_expert`` (4 steps, boundary 0.875: the switch after step
    2). Dense, lite at -inf (must match dense), and lite voting at thr 0
    before the switch and -10 after it: the sparsity the high-noise steps
    reach must not drop at the switch."""
    import torch
    from liteattention_torch.models import WanModel, denoise, denoise_two_expert

    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS)
    experts = []
    for seed in (20, 21):
        m = WanModel(cfg, device=dev)
        m.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
        experts.append(m.requires_grad_(False))
    log(f"  Wan2.2-T2V-A14B: two experts of the 14B geometry, depth cut {full.num_layers} -> "
        f"{cfg.num_layers} blocks each, boundary {TWO_EXPERT_BOUNDARY}")
    g = torch.Generator(device=dev).manual_seed(22)
    frames, hh, ww = grid
    noise = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    steps = PHASE3_STEPS

    def run(label, **kw):
        return timed_denoise(label, card, lambda: denoise_two_expert(
            *experts, noise, text, null, num_steps=steps, boundary=TWO_EXPERT_BOUNDARY, **kw),
            steps)

    for m in experts:  # warm-up, not counted
        denoise(m, noise, text, null, num_steps=1, enable_skipping=False)
    torch.cuda.synchronize()
    reset_counts()
    xa, _, ms_a, tel_a = run("ii.a: two experts dense", enable_skipping=False)
    n_high = tel_a["num_high_noise_steps"]
    log(f"  high-noise steps {n_high} of {steps}")
    check(n_high == 2, f"(ii) the experts switch after step {n_high}, not 2")
    xb, sp_b, ms_b, _ = run("ii.b: two experts lite, full mask, thr -inf",
                            thresholds=[-math.inf] * steps)
    e_ab = rel_l2(xb.float(), xa.float())
    log(f"  (ii.b) vs (ii.a) rel-L2 {e_ab:.3e} (tolerance {SLICE_AB_TOL})")
    check(xa.shape == noise.shape and e_ab < SLICE_AB_TOL and max(sp_b) == 0.0,
          "(ii.b) does not match (ii.a)")
    # (ii.c): the high-noise steps vote at thr 0 from full masks, so their
    # masks gain sparsity; the low-noise steps vote at thr -10, which skips
    # nothing new. Carried masks keep the high segment's sparsity after the
    # switch; masks restarted from full would read about 0 there.
    thr_c = [0.0] * n_high + [-10.0] * (steps - n_high)
    _, sp_c, ms_c, _ = run(f"ii.c: two experts lite, thresholds {thr_c}", thresholds=thr_c)
    log(f"  sparsity before the switch {sp_c[n_high - 1]}, after it {sp_c[n_high]}")
    check(sp_c[n_high - 1] > 0.0 and sp_c[n_high] >= sp_c[n_high - 1],
          "(ii.c) the masks did not carry across the expert switch")
    torch.cuda.synchronize()
    counts = check_path_counts("the two-expert run")
    log(f"  two-expert ms/step [{card}]: (a) {ms_a:.1f}, (b) {ms_b:.1f}, (c) {ms_c:.1f}")
    return counts, {"ms_per_step": {"dense": ms_a, "lite_full_mask": ms_b, "lite_voting": ms_c},
                    "b_vs_a_rel_l2": e_ab, "num_high_noise_steps": n_high,
                    "sparsity_voting": sp_c}


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
    counts = launches = read_counts()
    log(f"  launches during the training run: {launches}")
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
    attn = sum(t for k, t in kern.items() if "lite::fwd::" in k or "lite::bwd::" in k)
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
        # included) and of the decode kernel alone (its merge inside); the
        # call's CUDA-event time is host-bound at this size.
        # "timer" names how each time was taken (see device_ms).
        res["ms"], res["kernel_ms"], t_ms = device_ms(lambda: fn(*args, **kw),
                                                      names=DECODE_KERNELS)
        res["call_ms"] = cuda_ms(lambda: fn(*args, **kw), reps=20)
        res["plain_ms"], _, t_plain = device_ms(lambda: plain(*args, **kw), reps=3)
        res["bound_ms"], res["bound_by"] = bound(need[1], need[0])
        res["library_ms"], _, t_lib = (None, None, None) if library is None else device_ms(library)
        res["timer"] = {"ms": t_ms, "call_ms": "events", "plain_ms": t_plain, "library_ms": t_lib}
        lib = "none" if library is None else f"{res['library_ms']:.4f} ms"
        log(f"  decode {label}: device {res['ms']:.4f} ms per call (decode kernel "
            f"{fmt_ms(res['kernel_ms'])}; events over back-to-back calls {res['call_ms']:.4f} ms), "
            f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}), library {lib}")
    return res


def serve_flash_check(dev):
    """Causal B1 at the serving path's shapes (Llama-3-8B heads, GQA): the
    prefill (every request's prompt) and a speculative verify step
    (lookahead + 1 rows against the prompt and the tokens so far,
    bottom-right causal), the prefill timed. Returns the larger max abs
    error and the prefill's times."""
    import torch

    cfg = llama3_8b_config(1)
    hq, hk, d = cfg.num_heads, cfg.num_heads_kv, cfg.dim // cfg.num_heads
    g = torch.Generator(device=dev).manual_seed(8642)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    sk = SERVE_PROMPT + SPEC_NEW + SPEC_LOOKAHEAD
    shapes = (("prefill", SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT),
              ("verify", 1, SPEC_LOOKAHEAD + 1, sk))
    err, prefill = 0.0, None
    for label, b, sq, sk in shapes:
        q, k, v = rnd(b, hq, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d)
        name = f"causal {label} {b}x{hq}/{hk}, Sq {sq} Sk {sk} D {d}"
        r = check_flash(q, k, v, name, causal=True, time_it=label == "prefill")
        err = max(err, r["err"])
        if label == "prefill":
            prefill = {"shape": f"{b}x{hq}/{hk}x{sq}x{d} causal", **r}
            prefill.pop("err")
    return err, prefill


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
    # The library call at this shape: SDPA (enable_gqa) with a boolean
    # key-padding mask at the ragged lengths, by whichever backend takes it;
    # at uniform full lengths, beside SDPA (enable_gqa) with no mask.
    r = res["flash_decode"]
    pad = (torch.arange(s, device=dev) < lens[:, None])[:, None, None]  # [B, 1, 1, S]
    backend, r["library_ms"], r["timer"]["library_ms"] = sdpa_backend_ms(
        "B8 ragged", lambda: sdpa(q4, kc_h, vc_h, attn_mask=pad, enable_gqa=True))
    r["library"] = f"torch SDPA enable_gqa, boolean key-padding mask ({backend} backend)"
    r["ms_full_lengths"], _, r["timer"]["ms_full_lengths"] = device_ms(
        lambda: flash_attention_decode(q4, x["kc"], x["vc"], kv_bound=full))
    r["bound_ms_full_lengths"] = bound(need(2, b * s)[1], need(2, b * s)[0])[0]
    r["library_ms_full_lengths"], _, r["timer"]["library_ms_full_lengths"] = device_ms(
        lambda: sdpa(q4, kc_h, vc_h, enable_gqa=True))
    log(f"  decode B8 ragged: SDPA (enable_gqa, key-padding mask, {backend}) "
        f"{fmt_ms(r['library_ms'])}; full lengths: device {r['ms_full_lengths']:.4f} ms, bound "
        f"{r['bound_ms_full_lengths']:.4f} ms; SDPA (enable_gqa) "
        f"{r['library_ms_full_lengths']:.4f} ms")
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
    kern, calls = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            kern[e.key] = e.self_device_time_total / 1e3
            calls[e.key] = e.count
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
    launches = {k: sum(n for name, n in calls.items() if k in name)
                for k in ("flash_decode_kernel", "decode_merge_kernel")}
    log(f"    decode-kernel launches {launches['flash_decode_kernel']}, merge launches "
        f"{launches['decode_merge_kernel']} in {steps} steps")
    return {"busy_ms_per_step": busy / steps, "wall_ms_per_step_profiled": wall / steps,
            "decode_kernel_launches": launches["flash_decode_kernel"],
            "decode_merge_launches": launches["decode_merge_kernel"],
            **{f"{c}_ms_per_step": ms / steps for c, ms in split.items()}}


def recompute_fault_readings(model, toks, full, step_logits, prompt=SERVE_PROMPT,
                             capacity=SERVE_CAPACITY, late_by=1, rows=1, quantize=False):
    """What the recompute comparison can see: the first FAULT_STEPS decode
    steps, teacher-forced, with one fault planted in the cache after the
    prefill of ``prompt`` tokens (a cache of ``capacity``, int8 with
    ``quantize``), against the same full recompute, beside the sound run
    over the same steps. Faults: (late) every step ``late_by`` positions
    late, so rotary is that far off and as many zero rows lie at the
    prompt's end; (row) the prompt's last ``rows`` K and V rows zeroed in
    every layer. Each must read above the recompute limit."""

    def late(inf):
        inf.seqlen_offset += late_by

    def row(inf):
        for kc, vc, *_ in inf.key_value_memory_dict.values():
            kc[:, :, prompt - rows : prompt] = 0
            vc[:, :, prompt - rows : prompt] = 0

    n = FAULT_STEPS
    ref = full[:, 1:n]
    res = {"recompute_rel_l2_sound_first_steps": rel_l2(step_logits[:, 1:n], ref)}
    for name, fault in (("late", late), ("row", row)):
        got, _ = teacher_forced_logits(model, toks[:, : prompt + n], prompt, capacity,
                                       quantize=quantize, fault=fault)
        res[f"recompute_rel_l2_fault_{name}"] = rel_l2(got[:, 1:], ref)
        res[f"recompute_argmax_agreement_fault_{name}"] = (
            (got[:, 1:].argmax(-1) == ref.argmax(-1)).float().mean().item())
    log(f"  recompute comparison over decode steps 1-{n - 1}"
        f"{' (int8 cache)' if quantize else ''}: sound rel-L2 "
        f"{res['recompute_rel_l2_sound_first_steps']:.3e}; planted faults: {late_by} "
        f"position{'s' if late_by > 1 else ''} late {res['recompute_rel_l2_fault_late']:.3e} "
        f"(argmax agreement {res['recompute_argmax_agreement_fault_late']:.3f}), prompt's last "
        f"{rows} K/V row{'s' if rows > 1 else ''} zeroed {res['recompute_rel_l2_fault_row']:.3e} "
        f"(argmax agreement {res['recompute_argmax_agreement_fault_row']:.3f})")
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
    counts = launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the serving run: {launches}")
    want = 2 * cfg.num_layers * n_decode
    check(launches["flash_decode"] >= want,
          f"serving: expected at least {want} decode-kernel launches (one per layer per step)")
    check(all(launches[n] > 0 for n in ("flash_fwd_bound", "flash_decode", "paged_decode",
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
    stats_out["profile"] = prof = profile_decode_steps(model, inf, 5, card)
    if prof is not None:  # one launch per layer per step, the merge inside it
        check(prof["decode_kernel_launches"] == 5 * cfg.num_layers
              and prof["decode_merge_launches"] == 0,
              "serving: the decode step should launch the decode kernel once per layer, no merge")
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
    log(f"  launches during the engine run: {counts}")
    check(all(counts[n] > 0 for n in ("schedule_pack", "lite_flash_fwd", "lite_flash_fwd_coarse",
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
    pack_kv = check_pack(mask_a, "(a)'s mask", time_it=True, kv_map=kv_map)
    pack = check_pack(mask_a, "(a)'s mask", time_it=True)
    ext = {"pack_kv_map": pack_kv, "pack": pack,
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
    log(f"  at (a)'s mask (sparsity {ext['a_sparsity']:.3f}): B2 {pack['ms']:.5f} ms, with "
        f"kv_map {pack_kv['ms']:.5f} ms; B3 on compacted K/V {ext['lite_ms_compacted']:.3f}"
        f" ms vs on K/V {ext['lite_ms_uncompacted']:.3f} ms (+ B6 {kvc['ms']:.4f} ms) [{card}]")
    return counts, kres, ext, res


# ---------------------------------------------------------------- phase 7

# MLA at DeepSeek-V3's published widths (config.json: num_attention_heads
# 128, kv_lora_rank 512, qk_rope_head_dim 64, qk_nope_head_dim 128,
# v_head_dim 128; random bf16 inputs from a seed). Absorbed decode: every
# head attends one latent row of 512 + 64 = 576 channels, V its first 512;
# 64 requests with ragged cache lengths in 1024-8192 over one layer's pool
# of 64-token pages (64 x 8192 x 576 bf16, 604 MB). Prefill: 2 prompts x
# 4096 tokens through flash_attn_func at (q/k 192 = 128 + 64, v 128), causal;
# and the absorbed forms of a 4096-token prompt at V 512, every head on one
# KV head (the latent row): (576, 512), and (64, 512) with the qv term.
MLA_HEADS, MLA_D, MLA_DV = 128, 576, 512
MLA_BATCH, MLA_MIN_LEN, MLA_MAX_LEN, MLA_PAGE = 64, 1024, 8192, 64
MLA_PREFILL_BATCH, MLA_PREFILL_SEQ, MLA_QK, MLA_V = 2, 4096, 192, 128
MLA_ABS_BATCH, MLA_ABS_SEQ, MLA_ROPE = 1, 4096, 64
# B10 against its plain version: rel-L2 of the outputs over the tensor and
# over each request's block of rows (bf16 output, P rounded to bf16 before
# PV); lse as LSE_TOL. B1-MLA: as check_flash, plus the same rel-L2 over
# every (b, h, 128-row block).
MLA_REL_TOL = 1e-2
MLA_BLOCK_TOL = 2e-2
# B10's kernel, and the merge kernel that ran after it before the merge
# moved into the launch (kept, so that an older checkout's time holds it).
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


def check_flash_mla(q, k, v, label, causal=False, qv=None, got=None, scale=None):
    """B1's MLA kernels against the plain version: out within OUT_TOL (over
    max(1, |plain|) when causal), lse within LSE_TOL, rel-L2 over each (b,
    h, 128-row block) within MLA_BLOCK_TOL. ``got``: the kernel's (out,
    lse) from an earlier call with these inputs and ``scale`` (default
    1/sqrt(D)), else it is called here."""
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain

    scale = 1.0 / q.shape[-1] ** 0.5 if scale is None else scale
    out, lse = got or flash_attention(q, k, v, scale, causal=causal, qv=qv, return_lse=True)
    torch.cuda.synchronize()
    ro, rl = flash_attention_plain(q, k, v, scale, causal, qv=qv)
    diff = (out.float() - ro.float()).abs()
    err = diff.max().item()
    err_chk = (diff / ro.float().abs().clamp_min(1.0)).max().item() if causal else err
    fin = torch.isfinite(rl)
    check(torch.equal(fin, torch.isfinite(lse)), f"B1-MLA {label}: lse -inf rows differ")
    err_l = (lse[fin] - rl[fin]).abs().max().item()
    rel, blk = block_rel_l2(out, ro)
    dead = int((~fin).sum())
    if dead:
        check(out[~fin].abs().max().item() == 0.0, f"B1-MLA {label}: a row with no key is not 0")
    log(f"  B1-MLA {label}: max|out| err {err:.3e}, rel-L2 {rel:.2e}, worst 128-row block "
        f"{blk:.2e}, max|lse| err {err_l:.3e}" + (f", {dead} rows with no key" if dead else ""))
    check(err_chk < OUT_TOL and err_l < LSE_TOL and blk < MLA_BLOCK_TOL,
          f"B1-MLA {label} disagrees")
    return err


def mla_abs_inputs(dev, seed=7373):
    """phase 7's absorbed prefill inputs in flash_attn_func's [B, S, H, D]
    layout: (576, 512) as (q, k, v) and (64, 512) + qv as (q, k, v, qv),
    every head on one KV head."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, s, h = MLA_ABS_BATCH, MLA_ABS_SEQ, MLA_HEADS

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    return {"(576, 512)": (rnd(b, s, h, MLA_D), rnd(b, s, 1, MLA_D), rnd(b, s, 1, MLA_DV)),
            "(64, 512) + qv": (rnd(b, s, h, MLA_ROPE), rnd(b, s, 1, MLA_ROPE),
                               rnd(b, s, 1, MLA_DV), rnd(b, s, h, MLA_DV))}


def mla_fwd_timed(label, q, k, v, qv, card):
    """B1's MLA kernel at one shape ([B, H, S, D], causal, default scale)
    by CUDA events, beside its bound, its plain version and SDPA (the
    first backend that takes it; with qv on the concatenated [q | qv], [k
    | v], concatenated before the timer; KV heads expanded to the q heads
    where they differ)."""
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain

    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[3]
    ds = d + (dv if qv is not None else 0)
    scale = d**-0.5
    f = {"shape": f"{b}x{h}/{k.shape[1]}x{sq}, ({d}, {dv}){' + qv' if qv is not None else ''}, "
                  "causal"}
    f["ms"] = cuda_ms(lambda: flash_attention(q, k, v, scale, causal=True, qv=qv))
    f["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, scale, True, qv=qv), reps=1)
    torch.cuda.empty_cache()
    flops = 2 * (ds + dv) * attn_pairs(sq, sk, True) * b * h
    out_bytes = b * h * sq * (dv * 2 + 4)
    f["bound_ms"], f["bound_by"] = bound(
        flops, nbytes(q, k, v) + (0 if qv is None else nbytes(qv)) + out_bytes)
    f["tflops"] = flops / f["ms"] / 1e9
    qs, ks = (q, k) if qv is None else (torch.cat([q, qv], -1), torch.cat([k, v], -1))
    ks, vs = (x.expand(b, h, sk, x.shape[-1]) for x in (ks, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend, f["library_ms"], t_lib = sdpa_backend_ms(
        label, lambda: sdpa(qs, ks, vs, is_causal=True, scale=scale))
    f["timer"] = {"ms": "events", "plain_ms": "events", "library_ms": t_lib}
    f["library"] = (f"torch SDPA ({backend} backend)" if backend else "none") + (
        ", [q | qv] and [k | v] concatenated" if qv is not None else "") + (
        ", KV heads expanded" if k.shape[1] != h else "")
    lib = "n/a" if f["library_ms"] is None else f"{f['library_ms']:.3f} ms"
    log(f"  B1-MLA {label} {f['shape']}: kernel {f['ms']:.3f} ms ({f['tflops']:.1f} TFLOP/s), "
        f"plain {f['plain_ms']:.3f} ms, bound {f['bound_ms']:.3f} ms ({f['bound_by']}, "
        f"{f['bound_ms'] / f['ms']:.1%} of it), {f['library']} {lib} [{card}]")
    del qs, ks, vs
    torch.cuda.empty_cache()
    return f


def mla_phase(dev, card):
    """Phase 7: the counted run of the MLA path through its entry points
    (flash_mla_with_kvcache in four cache forms, flash_attn_func at the
    prefill shape and at the absorbed shapes at V 512), each against its
    plain version, small causal, empty-row and other-width checks, then the
    kernels' times."""
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
    ab = mla_abs_inputs(dev)

    def decode():
        return {name: flash_mla_with_kvcache(q, cache, table, lens, MLA_DV)
                for name, (cache, table) in x["forms"].items()}

    # The counted run: the MLA path through the entry points a server calls,
    # its decode calls under torch.profiler, which counts the kernels they
    # launch by name.
    torch.cuda.synchronize()
    reset_counts()
    outs, seen = kernel_launches(decode)
    prefill = flash_attn_func(pq, pk, pv, causal=True, return_softmax_lse=True)
    absorbed = {name: flash_attn_func(*xs[:3], causal=True, qv=xs[3] if len(xs) > 3 else None,
                                      return_softmax_lse=True)
                for name, xs in ab.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches during the MLA run: {counts}")
    check(counts["mla_decode"] == len(outs) and counts["flash_fwd_mla"] == 1
          and counts["flash_fwd_mla_v512"] == len(absorbed),
          "mla: a kernel of the path did not launch as often as the path calls it")
    # The profiler can miss launches (see device_ms): then the same calls
    # again, uncounted, up to twice.
    for _ in range(2):
        if sum(n for k, n in seen.items() if "mla_decode_kernel" in k) >= len(outs):
            break
        _, seen = kernel_launches(decode)
    b10 = sum(n for k, n in seen.items() if "mla_decode_kernel" in k)
    merges = sum(n for k, n in seen.items() if "merge" in k) if b10 >= len(outs) else None
    log(f"  profiler over the {len(outs)} decode calls: {b10} B10 launches, merge-kernel "
        f"launches {'not measured' if merges is None else merges}; kernels {seen}")
    if merges is not None:
        check(b10 == len(outs) and merges == 0,
              "mla: a decode call launched other than one B10 kernel and no merge kernel")

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
    # The absorbed prefill forms, as flash_attn_func returned them (its
    # default scale covers the score's 576 channels).
    abh = {name: [a.transpose(1, 2).contiguous() for a in xs] for name, xs in ab.items()}
    del ab
    err_v = 0.0
    for name, xs in abh.items():
        o_, l_ = absorbed.pop(name)
        err_v = max(err_v, check_flash_mla(
            *xs[:3], f"flash_attn_func {name} causal {MLA_ABS_BATCH}x{MLA_ABS_SEQ}x"
            f"{MLA_HEADS}, one KV head", True, qv=xs[3] if len(xs) > 3 else None,
            got=(o_.transpose(1, 2), l_), scale=MLA_D**-0.5))
        del o_, l_
    torch.cuda.empty_cache()
    for causal in (False, True):
        err_v = max(err_v, check_flash_mla(rnd(1, 8, 700, 576), rnd(1, 8, 900, 576),
                                           rnd(1, 8, 900, 512), f"(576, 512) {causal=}", causal))
        err_v = max(err_v, check_flash_mla(rnd(2, 4, 300, 64), rnd(2, 2, 555, 64),
                                           rnd(2, 2, 555, 512), f"(64, 512) + qv {causal=}",
                                           causal, qv=rnd(2, 4, 300, 512)))
        err_v = max(err_v, check_flash_mla(rnd(1, 4, 300, 576), rnd(1, 1, 100, 576),
                                           rnd(1, 1, 100, 512), f"(576, 512) Sq > Sk {causal=}",
                                           causal))

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
    r["merge_launches"] = merges
    res["mla_decode"] = r

    del prefill, po, pl
    res["flash_fwd_mla"] = {"err": err_f, **mla_fwd_timed("prefill", qh, kh, vh, None, card)}
    del qh, kh, vh
    abs_t = {name: mla_fwd_timed(name, *xs[:3], xs[3] if len(xs) > 3 else None, card)
             for name, xs in abh.items()}
    res["flash_fwd_mla_v512"] = {"err": err_v, **abs_t["(576, 512)"], "qv": abs_t["(64, 512) + qv"]}
    return counts, res


# ---------------------------------------------------------------- phase 8

# The Wan training step at Wan2.1-14B width (the slice's depth and grid):
# AdamW steps with remat, on one fixed batch, at a constant rate small
# enough for Adam's first steps to lower this random model's loss (the
# example's schedule starts at 0; at 1e-4 the first step raised the loss
# 14x, at 1e-5 it fell 14 % and rose 6 % at the next).
TRAIN_STEPS, TRAIN_LR = 3, 3e-6
# The remat / no-remat gradients: each leaf's difference scaled by the
# largest gradient of its module (the leaf and its siblings: a key bias
# with its weight), within the bf16 bound of the JAX package's remat test
# (tests/test_wan_model.py), or within twice the leaf's own run-to-run
# spread without remat (scaled alike): B7 sums dQ by atomics in no fixed
# order. Not by the leaf's own max: a leaf whose exact gradient is 0 (a
# cross-attention key bias: the rows of dK sum to 0 before the norm) has
# only that noise for a max, and its difference then reads near 2x itself.
REMAT_GRAD_TOL = 2e-2
PROBE_ROWS = 64
# Calibration on the phase-3 slice: steps (CFG, vote_stride 2), rel-L2
# budget, bisection steps.
CAL_STEPS, CAL_BUDGET, CAL_ITERS = 4, 0.05, 3
# The trained proxy at the JAX artifact's 4k settings (CALIBRATION_R5_4K.json:
# 16 frames of 32 x 32 latents -> 4096 tokens).
PROXY_ARGS = ["--train-steps", "3000", "--eval-steps", "24", "--entropy-reg", "0.05",
              "--entropy-target", "4.5", "--tile-reg", "0.03"]
# The headline geometry's band curve (the example's default 73 728 tokens).
E2E_ARGS = ["--modes", "band", "--steps", "2"]


def load_example(name):
    """The module of ``examples/<name>.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class plain_forbidden:
    """While open, each plain version that a wrapper of this path falls back
    to for CPU tensors raises: a run inside it launched the kernels or
    failed."""

    def __enter__(self):
        from liteattention_torch.ops import flash_bwd, flash_fwd, lite_flash_fwd, schedule_pack

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (flash_fwd, "flash_attention_plain"), (flash_bwd, "flash_bwd_plain"),
            (lite_flash_fwd, "lite_flash_attention_plain"),
            (schedule_pack, "pack_schedule_plain"))]
        for module, name, _ in self.saved:
            setattr(module, name, self._refuse(name))
        return self

    @staticmethod
    def _refuse(name):
        def refuse(*args, **kwargs):
            raise SmokeError(f"{name} ran on the card's path")
        return refuse

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)
        return False


def events_ms(fn):
    """(fn's result, its ms by CUDA events after a synchronize)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wan_train_bwd(dev, cfg, n_tok):
    """(a) B7 at the shapes the training step launches: self-attention over
    the slice's tokens (a ragged last key tile) and the text
    cross-attention (Sq != Sk), non-causal; checked and timed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(8080)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    h, d, sk = cfg.num_heads, cfg.head_dim, cfg.text_len
    q, k, v, do = (rnd(1, h, n_tok, d) for _ in range(4))
    self_res = check_bwd(q, k, v, do, f"self 1x{h}x{n_tok}x{d} non-causal ({n_tok % 128} keys "
                         "in the last tile)", causal=False, time_it=True)
    del k, v
    cross_res = check_bwd(q, rnd(1, h, sk, d), rnd(1, h, sk, d), do,
                          f"cross 1x{h}x{n_tok}x{d}, Sk {sk}, non-causal", causal=False,
                          time_it=True)
    return {"wan_train_self": (f"1x{h}x{n_tok}x{d} non-causal, ragged last tile", self_res),
            "wan_train_cross": (f"1x{h}x{n_tok}x{d}, Sk {sk}, non-causal", cross_res)}


def wan_train_step(dev, card, full, grid):
    """(b) The rectified-flow step of ``examples/torch_structured_calibration.py``
    at Wan2.1-14B width, the slice's depth and grid, fp32 master weights
    and bf16 products: AdamW steps with remat on one fixed batch (the
    counted run), then the gradients with and without remat at the same
    weights."""
    import torch
    from liteattention_torch.models import WanModel

    ex = load_example("torch_structured_calibration")
    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS, remat=True)
    model = WanModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(80))
    model.float()
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(81)
    frames, hh, ww = grid
    x0 = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    noise = torch.randn(x0.shape, generator=g, device=dev)
    sig = torch.rand(1, 1, 1, 1, 1, generator=g, device=dev)
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, weight_decay=0.01)
    log(f"  {n_params / 1e9:.3f} B parameters (fp32 master, bf16 products), {SLICE_LAYERS} "
        f"blocks, batch 1 x {x0.shape[1:4]} latent, sigma {sig.item():.4f}, AdamW lr {TRAIN_LR}")

    def fwd_bwd():
        loss, _, _ = ex.flow_loss(model, x0, noise, sig, text)
        loss.backward()
        return loss.detach()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = fwd_bwd()
        opt.step()
        return loss

    fwd_bwd()  # warm-up (cuBLAS handles, allocator), not counted
    model.zero_grad(set_to_none=True)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with plain_forbidden():
        for _ in range(TRAIN_STEPS):
            loss, ms = events_ms(step)
            losses.append(loss.item())
            step_ms.append(ms)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_steps = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the training steps: {counts}")
    log(f"  loss per step {losses}; ms/step (fwd + bwd + AdamW, events) {step_ms}; peak "
        f"{peak_steps:.2f} GB [{card}]")
    check(all(math.isfinite(x) for x in losses), "Wan training loss is not finite")
    check(losses[-1] < losses[0], "Wan training loss does not fall on a fixed batch")
    # Remat runs each block's forward again inside the backward: B1 four
    # times a block a step (self and cross, twice), B7 twice.
    want = {"flash_fwd": 4 * SLICE_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": 2 * SLICE_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": 2 * SLICE_LAYERS * TRAIN_STEPS}
    check(all(counts[n] == c for n, c in want.items()), f"Wan training: expected launches {want}")

    # The same weights, with remat and twice without it: fwd + bwd time,
    # peak, grads.
    res = {"ms_per_step": step_ms, "losses": losses, "peak_gb_steps": peak_steps}
    grads = []
    for remat in (True, False, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with plain_forbidden():
            _, ms = events_ms(fwd_bwd)
        peak = torch.cuda.max_memory_allocated() / 1e9
        key = "remat" if remat else "no_remat"
        res[f"fwd_bwd_ms_{key}"], res[f"peak_gb_{key}"] = ms, peak
        log(f"  fwd + bwd {'with' if remat else 'without'} remat: {ms:.1f} ms, peak {peak:.2f} GB "
            f"(AdamW state resident) [{card}]")
        if len(grads) < 2:
            grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    bad, worst = [], {"remat": (-1.0, ""), "spread": (-1.0, "")}
    module_max = {}
    for n, gr in grads[1].items():
        mod = n.rpartition(".")[0]
        module_max[mod] = max(module_max.get(mod, 0.0), gr.abs().max().item())
    for n, p in model.named_parameters():
        ref = grads[1][n].to(dev).float()
        scale = max(module_max[n.rpartition(".")[0]], 1e-6)
        err = ((grads[0][n].to(dev).float() - ref).abs().max() / scale).item()
        spread = ((p.grad.float() - ref).abs().max() / scale).item()
        worst["remat"] = max(worst["remat"], (err, n))
        worst["spread"] = max(worst["spread"], (spread, n))
        if err >= max(REMAT_GRAD_TOL, 2 * spread):
            bad.append((n, err, spread))
    res["remat_grad_scaled_err"], res["no_remat_grad_scaled_spread"] = (
        worst["remat"][0], worst["spread"][0])
    log(f"  gradients, max |diff| / max |grad of the leaf's module| per leaf: remat vs no "
        f"remat worst "
        f"{worst['remat'][0]:.3e} ({worst['remat'][1]}); no remat run to run worst "
        f"{worst['spread'][0]:.3e} ({worst['spread'][1]}); tolerance {REMAT_GRAD_TOL} or twice "
        f"the leaf's spread")
    check(not bad, f"remat and no-remat gradients disagree: {bad[:4]}")
    return counts, res


def wan_probe_check(dev, full, grid):
    """(c) The attention probe at Wan2.1-14B width: one forward and backward
    with ``attn_probe_rows``; per-layer entropy and tile excess finite, the
    entropy's gradient reaching the first block's q projection."""
    import torch
    from liteattention_torch.models import WanModel

    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS, remat=True,
                              attn_probe_rows=PROBE_ROWS)
    model = WanModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(80))
    model.float()
    g = torch.Generator(device=dev).manual_seed(82)
    frames, hh, ww = grid
    x = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    with plain_forbidden():
        model(x, torch.full((1,), 500.0, device=dev), text)
        ent = [e for e in model.intermediates["attn_entropy"]]
        tiles = [e.item() for e in model.intermediates["attn_tile_excess"]]
        torch.stack(ent).sum().backward()
    ent = [e.item() for e in ent]
    gq = model.blocks[0].self_attn.q.weight.grad
    gnorm = gq.float().norm().item()
    log(f"  probe ({PROBE_ROWS} rows): entropy per layer {ent} (nats; uniform would be "
        f"{math.log(x.shape[1] * x.shape[2] * x.shape[3] // 4):.3f}), tile excess {tiles}; "
        f"|d entropy / d blocks.0.self_attn.q.weight| {gnorm:.3e}")
    check(len(ent) == len(tiles) == SLICE_LAYERS, "probe: a layer is missing")
    check(all(math.isfinite(v) for v in ent + tiles), "probe values not finite")
    check(math.isfinite(gnorm) and gnorm > 0, "probe: the entropy's gradient does not reach q")
    return {"entropy": ent, "tile_excess": tiles, "q_grad_norm": gnorm}


def wan_calibrate(dev, card, full, grid):
    """(d) ``calibrate_constant_threshold`` on the phase-3 T2V slice (random
    weights), every probed threshold printed; the counted run."""
    import torch
    import liteattention_torch.models.calibrate as calibrate
    from liteattention_torch.models import WanModel

    cfg = dataclasses.replace(full, num_layers=SLICE_LAYERS)
    model = WanModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(1)
    frames, hh, ww = grid
    noise = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    probes, inner = [], calibrate.evaluate_sparsity_quality

    def probed(*args, **kw):
        r = inner(*args, **kw)
        probes.append((float(kw["thresholds"][0]), float(r["relative_l2"]),
                       float(r["mean_sparsity"])))
        log(f"    threshold {probes[-1][0]}: rel-L2 {probes[-1][1]:.4e}, mean sparsity "
            f"{probes[-1][2]:.4f}")
        return r

    calibrate.evaluate_sparsity_quality = probed
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with plain_forbidden():
            result = calibrate.calibrate_constant_threshold(
                model, noise, text, target_rel_l2=CAL_BUDGET, iters=CAL_ITERS,
                num_steps=CAL_STEPS, null_text=null, guidance_scale=5.0, vote_stride=2)
    finally:
        calibrate.evaluate_sparsity_quality = inner
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = check_path_counts("the calibration run")
    log(f"  calibrated: {result} ({seconds:.1f} s) [{card}]")
    if "warning" not in result:
        check(result["relative_l2"] <= CAL_BUDGET, "calibrated threshold misses the budget")
    by_thr = sorted(probes)
    monotone = all(a[1] <= b[1] for a, b in zip(by_thr, by_thr[1:]))
    log(f"  rel-L2 non-decreasing in the threshold across the probes (the bisection's "
        f"premise): {monotone}")
    return counts, {"result": result, "probes": probes, "rel_l2_monotone": monotone,
                    "seconds": seconds}


def wan_proxy(card):
    """(e) ``examples/torch_structured_calibration.py`` at the JAX artifact's
    4k settings: lite's quality on trained weights."""
    ex = load_example("torch_structured_calibration")
    out = ROOT / "runs" / "torch_structured_calibration.json"
    log(f"  python examples/torch_structured_calibration.py {' '.join(PROXY_ARGS)}")
    reset_counts()
    t0 = time.perf_counter()
    with plain_forbidden():
        art = ex.main(PROXY_ARGS + ["--device", "cuda", "--out", str(out)])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    log(f"  launches during the proxy run: {counts} ({seconds:.1f} s) [{card}]")
    check(all(counts[n] > 0 for n in ("flash_fwd", "flash_bwd_dq", "schedule_pack",
                                      "lite_flash_fwd")),
          "the proxy run did not launch B1, B2, B3 and B7")
    wl, cal = art["workload"], art["calibrated"]
    log(f"  training loss {wl['first_train_loss']:.4f} -> {wl['final_train_loss']:.4f}, "
        f"final probed entropy {wl['final_attn_entropy']:.3f}")
    log("  threshold  mean sparsity  rel-L2  flicker  subject-consistency delta  PSNR dB")
    for r in art["curve"]:
        log(f"  {r['threshold']:9.1f}  {r['mean_sparsity']:13.4f}  {r['relative_l2']:.4f}  "
            f"{r['temporal_flicker']:.4f}  {r['subject_consistency_delta']:.6f}  "
            f"{r['psnr_db']:.2f}")
    log(f"  calibrated schedule at rel-L2 <= {art['budget_rel_l2']}: mean sparsity "
        f"{cal['mean_sparsity']:.4f}, final {cal['final_sparsity']:.4f}, rel-L2 "
        f"{cal['relative_l2']:.4f}, thr* {cal['threshold']}, +delta {cal['loosen_delta']}"
        + (f"; WARNING: {cal['warning']}" if "warning" in cal else ""))
    check(wl["final_train_loss"] < wl["first_train_loss"], "the proxy's loss did not fall")
    check("warning" in cal or cal["relative_l2"] <= art["budget_rel_l2"],
          "the calibrated schedule misses the budget")
    return counts, {"seconds": seconds, **art}


def wan_e2e(card):
    """(f) ``examples/torch_wan_e2e_speed.py --modes band --steps 2`` at its
    default 73 728 tokens."""
    ex = load_example("torch_wan_e2e_speed")
    out = ROOT / "runs" / "torch_wan_e2e_speed.json"
    log(f"  python examples/torch_wan_e2e_speed.py {' '.join(E2E_ARGS)}")
    reset_counts()
    with plain_forbidden():
        art = ex.main(E2E_ARGS + ["--device", "cuda", "--out", str(out)])
    counts = check_path_counts("the e2e band run")
    band = art["banded_curve"]
    log(f"  {art['tokens']} tokens: dense {art['dense_ms_per_step']:.1f} ms/step; sparsity -> "
        f"ms/step {[(round(r['sparsity'], 4), round(r['ms_per_step'], 1)) for r in band]} [{card}]")
    check(len(band) == 5 and all(math.isfinite(r["ms_per_step"]) for r in band),
          "the band curve is incomplete")
    return counts, art


def wan_train_phase(dev, card, full, grid):
    """Phase 8: the Wan training and threshold-calibration path."""
    import torch

    n_tok = grid[0] * (grid[1] // full.patch_size[1]) * (grid[2] // full.patch_size[2])
    log("  (a) B7 at the training step's shapes")
    bwd = wan_train_bwd(dev, full, n_tok)
    torch.cuda.empty_cache()
    log("  (b) a Wan2.1-14B-width training step")
    counts = {}
    counts["wan_train"], train = wan_train_step(dev, card, full, grid)
    torch.cuda.empty_cache()
    log("  (c) the attention probe at that width")
    train["probe"] = wan_probe_check(dev, full, grid)
    torch.cuda.empty_cache()
    log(f"  (d) calibrate_constant_threshold on the T2V slice ({CAL_STEPS} steps, CFG, budget "
        f"{CAL_BUDGET}, iters {CAL_ITERS})")
    counts["wan_calibrate"], train["calibrate"] = wan_calibrate(dev, card, full, grid)
    torch.cuda.empty_cache()
    log("  (e) lite's quality with trained weights: the structured-calibration proxy")
    counts["wan_proxy"], train["proxy"] = wan_proxy(card)
    torch.cuda.empty_cache()
    log("  (f) the band curve at the headline 73 728 tokens")
    counts["wan_e2e"], train["e2e"] = wan_e2e(card)
    return counts, bwd, train


# ---------------------------------------------------------------- phase 10

# Baichuan2-13B-Base (baichuan-inc/Baichuan2-13B-Base config.json): hidden
# 5120, 40 layers, 40 heads of 128, intermediate 13 696, vocab 125 696,
# RMSNorm eps 1e-6, ALiBi, untied normalised head; served like phase 5 at
# ALIBI_BATCH requests of SERVE_PROMPT tokens, SERVE_NEW greedy tokens into
# a SERVE_CAPACITY cache, fp32 master weights.
ALIBI_BATCH, ALIBI_LAYERS = 4, 40
# BERT-large (google-bert/bert-large-uncased config.json): 1024 wide, 24
# layers, 16 heads of 64, ffn 4096, vocab 30 522, 512 positions; a batch of
# BERT_BATCH sequences right-padded to BERT_SEQ, lengths seeded in
# [BERT_MIN_LEN, BERT_SEQ].
BERT_BATCH, BERT_SEQ, BERT_MIN_LEN = 32, 512, 64
# rel-L2 of a padded sequence's valid rows (bf16 MLM logits) against the
# same sequence run alone: the keys and the tile arithmetic are the same,
# only the GEMMs may take other algorithms at other row counts.
BERT_PAD_TOL = 2e-2
# Phase 10 (a)'s other shapes: a left-padded cache's append (b, h, hk, Sq,
# Sk, d), and non-causal ALiBi at BTLM's 1/d scale (b, h, Sq, Sk, d) at
# Baichuan2-13B's heads.
CACHE_APPEND_SHAPE = (8, 32, 8, 1024, 4096, 128)
ALIBI_NONCAUSAL_SHAPE = (2, 40, 1000, 1536, 128)


def visible_keys(b, sq, sk, dev, causal=False, kv_bound=None, kv_low=None, bound_causal=False,
                 q_segments=None, kv_segments=None):
    """Bool ``[B, 1, Sq, Sk]``: the keys each q row of B1 with these
    channels sees (the plain version's rule; segments: the keys of the
    row's id)."""
    import torch

    row = torch.arange(sq, device=dev)[:, None]
    col = torch.arange(sk, device=dev)[None, :]
    vis = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=dev)
    if causal:
        vis &= col <= row + (sk - sq)
    if kv_bound is not None:
        end = kv_bound.reshape(-1, 1, 1, 1)
        vis &= col < (end - sq + row + 1 if bound_causal else end)
    if kv_low is not None:
        vis &= col >= kv_low.reshape(-1, 1, 1, 1)
    if q_segments is not None:
        vis &= q_segments.reshape(b, 1, sq, 1) == kv_segments.reshape(b, 1, 1, sk)
    return vis


def hidden_keys(b, sk, dev, kv_bound=None, kv_low=None, q_segments=None, kv_segments=None):
    """Bool ``[B, Sk]``: keys no q row of the batch sees (at or past the
    bound, before kv_low, of an id no row carries)."""
    import torch

    col = torch.arange(sk, device=dev)[None]
    hidden = torch.zeros(b, sk, dtype=torch.bool, device=dev)
    if kv_bound is not None:
        hidden |= col >= kv_bound.reshape(-1, 1)
    if kv_low is not None:
        hidden |= col < kv_low.reshape(-1, 1)
    if q_segments is not None:
        hidden |= ~torch.isin(kv_segments.reshape(b, sk), q_segments)
    return hidden


def segment_kernel_call(q, k, v, scale, kw):
    """B1's segment kernel alone on the ids' precomputed walk (no ranges
    computed in the call)."""
    from liteattention_torch.ops import flash_fwd
    from liteattention_torch.ops.segments import segment_walk

    walk = segment_walk(kw["q_segments"], kw["kv_segments"])
    return lambda: flash_fwd._launch(q, k, v, scale, kw.get("causal", False), walk=walk,
                                     q_segments=kw["q_segments"], kv_segments=kw["kv_segments"])


def check_channels(label, q, k, v, kw, time_it=False):
    """B1 with its per-batch channels (``kw``: kv_bound, kv_low,
    bound_causal, alibi_slopes, causal, scale) against its plain version
    on the same inputs: out within OUT_TOL of max(1, |plain|), lse within
    LSE_TOL, every (b, h, 128-row block) within B1_BLOCK_TOL. With
    ``time_it`` also its device time beside its bound (only the visible
    key pairs and the key rows inside each batch's range), the plain
    version's time and SDPA's with the equivalent mask (a boolean mask; an
    additive bias for ALiBi), the backend named. Where the channels are the
    same over the batch the mask is one [1, H, Sq, Sk] that SDPA broadcasts
    (BTLM's prefill would not fit a [B, H, Sq, Sk] bias beside the plain
    version)."""
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention_masked, flash_attention_plain

    out, lse = flash_attention_masked(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ro, rl = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (out.float() - ro.float()).abs()
    err_o = diff.max().item()
    err_chk = (diff / ro.float().abs().clamp_min(1.0)).max().item()
    fin = torch.isfinite(rl)
    check(torch.equal(fin, torch.isfinite(lse)), f"B1 {label}: lse -inf rows differ")
    err_l = (lse[fin] - rl[fin]).abs().max().item() if fin.any() else 0.0
    res = {"err": err_o}
    res["rel_l2"], res["worst_block_rel_l2"] = block_rel_l2(out, ro)
    msg = (f"  B1 {label}: max|out| err {err_o:.3e}, max|lse| err {err_l:.3e}, rel-L2 "
           f"{res['rel_l2']:.3e}, worst 128-row block {res['worst_block_rel_l2']:.3e}")
    if not fin.all():
        check(out[~fin].abs().max().item() == 0.0, f"B1 {label}: a row with no key is not 0")
        msg += f", {int((~fin).sum())} rows with no valid key (out 0, lse -inf)"
    log(msg)
    check(err_chk < OUT_TOL and err_l < LSE_TOL and res["worst_block_rel_l2"] < B1_BLOCK_TOL,
          f"B1 {label} disagrees")
    if not time_it:
        return res
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    bound_t, low_t = kw.get("kv_bound"), kw.get("kv_low")
    vis = visible_keys(b, sq, sk, q.device, kw.get("causal", False), bound_t, low_t,
                       kw.get("bound_causal", False), kw.get("q_segments"), kw.get("kv_segments"))
    pairs = int(vis.sum().item()) * h
    lim = torch.full((b,), sk, device=q.device) if bound_t is None else bound_t.clamp(0, sk)
    first = torch.zeros_like(lim) if low_t is None else low_t.clamp(0, sk)
    key_rows = int((lim - first).clamp_min(0).sum().item())
    kv_bytes = 2 * key_rows * hk * d * k.element_size()
    res["bound_ms"], res["bound_by"] = bound(4 * d * pairs, nbytes(q, out, lse) + kv_bytes)
    res["visible_pairs"] = pairs
    scale = kw.get("scale") or d**-0.5
    call = lambda: flash_attention_masked(q, k, v, **kw)  # noqa: E731
    if "q_segments" in kw:
        # The whole call computes the segment walk's ranges first (ops/
        # segments.py); the kernel alone runs on them (as the backward does).
        res["call_ms"], _, res["call_timer"] = device_ms(call)
        call = segment_kernel_call(q, k, v, scale, kw)
    res["ms"], _, res["timer"] = device_ms(call)
    res["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), reps=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    slopes = kw.get("alibi_slopes")
    mb = b
    if torch.equal(vis, vis[:1].expand_as(vis)) and (slopes is None or slopes.dim() == 1):
        mb, vis = 1, vis[:1]
    if slopes is None:
        mask, kind = vis, "a boolean mask"
    else:
        slopes = slopes.float().reshape(-1, h).expand(mb, h)[:, :, None, None]
        dist = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                - torch.arange(sk, device=q.device)[None, :]).float()
        dist = dist if kw.get("causal", False) else dist.abs()
        mask = (-slopes * dist).masked_fill(~vis, -torch.inf).to(q.dtype)
        kind = "an additive ALiBi bias"
    kl, vl, gqa = k, v, hk < h
    if "q_segments" in kw:  # the efficient backend, as the backward's: K/V expanded
        kl, vl, gqa = k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1), False
    backend, res["library_ms"], t_lib = sdpa_backend_ms(
        f"B1 {label}", lambda: sdpa(q, kl, vl, attn_mask=mask, scale=scale, enable_gqa=gqa))
    res["library"] = None if backend is None else f"SDPA {backend} with {kind} ({t_lib})"
    del mask, kl, vl
    lib = "n/a" if backend is None else f"{res['library_ms']:.4f} ms {res['library']}"
    if "call_ms" in res:
        log(f"  B1 {label}: the whole call (ranges and kernel) {res['call_ms']:.4f} ms "
            f"({res['call_timer']})")
    log(f"  B1 {label}: kernel {res['ms']:.4f} ms ({res['timer']}), plain {res['plain_ms']:.3f} "
        f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; {pairs} visible pairs), "
        f"library {lib}")
    return res


def channel_kernel_phase(dev):
    """Phase 10 (a): B1's bound, low, bound_causal and ALiBi channels at the
    paths' shapes and at the edges, each against its plain version; the
    paths' shapes timed. Returns the kernels line's flash_fwd_bound and
    flash_fwd_alibi entries."""
    import torch
    from liteattention_torch.modules.mha import alibi_slopes

    g = torch.Generator(device=dev).manual_seed(2468)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def ints(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=dev, dtype=torch.int32)

    bound_res, alibi_res = {}, {}
    # BERT-large's attention: right-padded lengths, non-causal.
    b, h, s, d = BERT_BATCH, 16, BERT_SEQ, 64
    lens = ints(BERT_MIN_LEN, BERT_SEQ, b)
    bound_res["bert_large_padded"] = check_channels(
        f"bound {b}x{h}x{s}x{d}, lengths {BERT_MIN_LEN}-{BERT_SEQ}", rnd(b, h, s, d),
        rnd(b, h, s, d), rnd(b, h, s, d), dict(kv_bound=lens), time_it=True)
    # A left-padded cache (kv_low) with an append of Sq rows at its end.
    b, h, hk, sq, sk, d = CACHE_APPEND_SHAPE
    low, bound_t = ints(0, sk // 4 - 1, b), ints(sk // 2, sk, b)
    bound_res["cache_low_bound_causal"] = check_channels(
        f"bound + low + bound_causal {b}x{h}/{hk}x{sq}x{d} over {sk} keys",
        rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d),
        dict(kv_bound=bound_t, kv_low=low, bound_causal=True), time_it=True)
    # Phase 5's prefill as MHA now runs it: Llama-3-8B's heads over the whole
    # cache with the bound (beside the causal B1 over the prompt alone that
    # serve_flash_check times: the same keys and tiles, once copied out).
    b, h, hk, d = SERVE_BATCH, 32, 8, 128
    bound_res["serving_prefill_over_cache"] = check_channels(
        f"bound_causal {b}x{h}/{hk}x{SERVE_PROMPT}x{d} over a {SERVE_CAPACITY}-key cache",
        rnd(b, h, SERVE_PROMPT, d), rnd(b, hk, SERVE_CAPACITY, d), rnd(b, hk, SERVE_CAPACITY, d),
        dict(kv_bound=torch.full((b,), SERVE_PROMPT, dtype=torch.int32, device=dev),
             bound_causal=True), time_it=True)
    # Rows that see no key: bound 0, bound == low, bound < low, bound_causal
    # with bound < Sq; and the walk's first tile inside the range.
    edges = (("no-key rows", dict(kv_bound=torch.tensor([0, 100, 90, 60], device=dev),
                                  kv_low=torch.tensor([0, 100, 120, 0], device=dev),
                                  bound_causal=True)),
             ("low inside a tile, causal", dict(
                 kv_bound=torch.tensor([260, 200, 255, 129], device=dev),
                 kv_low=torch.tensor([5, 129, 250, 0], device=dev), causal=True)))
    bound_res["edges"] = {"err": max(
        check_channels(f"{label} 4x2x150x64 over 260 keys", rnd(4, 2, 150, 64),
                       rnd(4, 2, 260, 64), rnd(4, 2, 260, 64), kw)["err"] for label, kw in edges)}
    # ALiBi at Baichuan2-13B's heads: the prefill over the cache (MHA's
    # route: causal off, bound_causal on, Sk = the cache), single-token
    # steps at ragged bounds, a verify step (Sq 4), and non-causal Sq != Sk
    # with [B, H] slopes at BTLM's 1/d scale.
    b, h, sq, sk, d = ALIBI_NONCAUSAL_SHAPE
    cap = SERVE_CAPACITY
    slopes = alibi_slopes(h).to(dev)
    b = ALIBI_BATCH
    full_bound = torch.full((b,), SERVE_PROMPT, dtype=torch.int32, device=dev)
    alibi_res["prefill_over_cache"] = check_channels(
        f"ALiBi prefill {b}x{h}x{SERVE_PROMPT}x{d} over a {cap}-key cache, bound_causal",
        rnd(b, h, SERVE_PROMPT, d), rnd(b, h, cap, d), rnd(b, h, cap, d),
        dict(kv_bound=full_bound, bound_causal=True, alibi_slopes=slopes), time_it=True)
    kc, vc = rnd(b, h, cap, d), rnd(b, h, cap, d)
    alibi_res["decode_sq1"] = check_channels(
        f"ALiBi single-token step {b}x{h}x1x{d} over {cap} keys, ragged bounds",
        rnd(b, h, 1, d), kc, vc,
        dict(kv_bound=ints(SERVE_PROMPT + 1, cap, b), bound_causal=True, alibi_slopes=slopes),
        time_it=True)
    verify_bound = torch.tensor([SERVE_PROMPT + SPEC_NEW], dtype=torch.int32, device=dev)
    alibi_res["verify_sq4"] = check_channels(
        f"ALiBi verify step 1x{h}x{SPEC_LOOKAHEAD + 1}x{d} over {cap} keys",
        rnd(1, h, SPEC_LOOKAHEAD + 1, d), kc[:1], vc[:1],
        dict(kv_bound=verify_bound, bound_causal=True, alibi_slopes=slopes), time_it=True)
    bh = slopes * torch.linspace(1.0, 0.5, b, device=dev)[:, None]
    alibi_res["noncausal_bh_scale_d"] = check_channels(
        f"ALiBi non-causal {b}x{h}x{sq}x{d} over {sk} keys, [B, H] slopes, scale 1/d",
        rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d),
        dict(alibi_slopes=bh, scale=1.0 / d))
    r = check_channels("ALiBi causal Sq > Sk 2x10/2x300x64 over 140 keys, 10 heads",
                       rnd(2, 10, 300, 64), rnd(2, 2, 140, 64), rnd(2, 2, 140, 64),
                       dict(alibi_slopes=alibi_slopes(10).to(dev), causal=True))
    alibi_res["edges"] = {"err": r["err"]}
    torch.cuda.empty_cache()
    return {"flash_fwd_bound": _channel_entry(bound_res, "bert_large_padded"),
            "flash_fwd_alibi": _channel_entry(alibi_res, "prefill_over_cache")}


def _channel_entry(results, headline):
    """A kernels-line entry: the headline shape's numbers at the top, every
    shape's under ``shapes``, the error the largest over all."""
    return {**results[headline], "shape": headline,
            "err": max(r["err"] for r in results.values()), "shapes": results}


def baichuan2_13b_config(layers):
    """Baichuan2-13B-Base (config.json): hidden 5120, 40 heads of 128, ALiBi,
    intermediate 13 696 (baichuan_config's own rounding gives 13 568),
    vocab 125 696, RMSNorm eps 1e-6, untied head."""
    from liteattention_torch.models.configs import baichuan_config

    cfg = baichuan_config(dim=5120, num_layers=layers, num_heads=40, vocab=125696)
    return dataclasses.replace(cfg, ffn_dim=13696)


def shared_draft(model, layers):
    """A draft of ``model`` that shares its embedding, first ``layers``
    blocks, final norm and head (no copy of the weights)."""
    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel

    draft = GPTLMHeadModel(dataclasses.replace(model.cfg, num_layers=layers), device="meta")
    draft.transformer.wte = model.transformer.wte
    draft.transformer.blocks = torch.nn.ModuleList(model.transformer.blocks[:layers])
    draft.transformer.ln_f_scale = model.transformer.ln_f_scale
    draft.lm_head = model.lm_head
    check(all(t.device.type != "meta" for t in [*draft.parameters(), *draft.buffers()]),
          "the draft kept a tensor of its own")
    return draft


def small_alibi_check(dev, cfg=None, label="small ALiBi model (dim 640, 2 layers, 10 heads of 64)"):
    """A small ALiBi model (``cfg``; by default 10 heads of 64: the slopes'
    non-power-of-two interleave) decoding on the card (bf16, B1's ALiBi
    channel at every step) against greedy decoding on the CPU (fp32, the
    plain versions), teacher-forced on the CPU's tokens; returns the
    logits' rel-L2."""
    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_decode
    from liteattention_torch.utils.generation import greedy_decode

    prompt, new = 100, 12
    if cfg is None:
        cfg = dataclasses.replace(baichuan2_13b_config(2), dim=640, num_heads=10,
                                  vocab_size=1000, ffn_dim=1024)
    cpu = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(11))
    gpu = GPTLMHeadModel(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 1000, (2, prompt), generator=torch.Generator().manual_seed(12))
    rec = StepTimer(cpu)
    toks = greedy_decode(rec, ids, new, 128)
    ref = rec.logits()
    n0, d0 = flash_attention.alibi_launches, flash_attention_decode.launches
    got, _ = teacher_forced_logits(gpu, toks.to(dev), prompt, 128)
    torch.cuda.synchronize()
    n, nd = flash_attention.alibi_launches - n0, flash_attention_decode.launches - d0
    check(n == cfg.num_layers * new and nd == 0,
          f"{label}: {n} ALiBi B1 launches, {nd} decode-kernel launches")
    err = rel_l2(got.float().cpu(), ref)
    same = (got.argmax(-1).cpu() == ref.argmax(-1)).float().mean().item()
    log(f"  {label}, {new} tokens teacher-forced, bf16 card vs fp32 CPU: logits rel-L2 "
        f"{err:.2e}, argmax agreement {same:.3f}, {n} ALiBi B1 launches, no decode-kernel launch")
    check(err < SMALL_DECODE_TOL, f"{label}: decode disagrees")
    return err


def alibi_serve_phase(dev, card):
    """Phase 10 (b): Baichuan2-13B serving at full width and depth (the
    counted path: greedy decoding of ALIBI_BATCH requests and batch-1
    speculative decoding), then its checks."""
    import statistics

    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import decode_speculative, greedy_decode

    small_alibi_check(dev)
    cfg = baichuan2_13b_config(ALIBI_LAYERS)
    log(f"  Baichuan2-13B: dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} heads x "
        f"{cfg.dim // cfg.num_heads}, ALiBi, ffn {cfg.ffn_dim} (published; baichuan_config's "
        f"rounding gives 13568), vocab {cfg.vocab_size}; fp32 master weights, bf16 compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    draft = shared_draft(model, SPEC_DRAFT_LAYERS)
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (ALIBI_BATCH, SERVE_PROMPT), generator=g, device=dev)
    log(f"  {n_params / 1e9:.2f} B parameters; {ALIBI_BATCH} requests x {SERVE_PROMPT} prompt "
        f"tokens, {SERVE_NEW} new tokens each, cache capacity {SERVE_CAPACITY}")
    greedy_decode(model, ids[:1, :16], 2, 32)  # warm-up, not counted

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timer = StepTimer(model)
    toks = greedy_decode(timer, ids, SERVE_NEW, SERVE_CAPACITY)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n_decode = len(timer.calls) - 1
    spec, stats = decode_speculative(model, draft, ids[:1], SPEC_NEW, SERVE_CAPACITY,
                                     speculative_lookahead=SPEC_LOOKAHEAD, return_stats=True)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the ALiBi serving run: {counts}")
    want = cfg.num_layers * (1 + n_decode)
    check(counts["flash_fwd_alibi"] >= want,
          f"ALiBi serving: expected at least {want} ALiBi B1 launches (one per layer per step)")
    check(counts["flash_decode"] == 0, "ALiBi serving: a step went to the decode kernel B8")

    prefill_ms = timer.calls[0][1]
    step_ms = [ms for _, ms in timer.calls[1:]]
    dec_ms = statistics.median(step_ms)
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": dec_ms,
           "decode_tokens_per_s": ALIBI_BATCH * 1e3 / dec_ms,
           "end_to_end_tokens_per_s": ALIBI_BATCH * SERVE_NEW * 1e3 / wall,
           "peak_gb": peak_gb, "decode_steps": n_decode, "parameters_b": n_params / 1e9}
    log(f"  prefill {prefill_ms:.1f} ms ({ALIBI_BATCH * SERVE_PROMPT / prefill_ms * 1e3:.0f} "
        f"prompt tokens/s), decode {dec_ms:.2f} ms/step (median of {n_decode}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) = {out['decode_tokens_per_s']:.0f} "
        f"tokens/s; end to end {wall:.0f} ms = {out['end_to_end_tokens_per_s']:.0f} new "
        f"tokens/s; peak memory {peak_gb:.2f} GB [{card}]")
    acc = stats["accepted_per_round"]
    n_cmp = SERVE_PROMPT + min(SPEC_NEW, SERVE_NEW)
    agree = (spec[0, SERVE_PROMPT:n_cmp] == toks[0, SERVE_PROMPT:n_cmp]).float().mean().item()
    out.update(spec_rounds=len(acc), spec_tokens_per_round=sum(acc) / len(acc),
               spec_agreement_with_greedy=agree)
    log(f"  speculative (batch 1, {SPEC_DRAFT_LAYERS}-layer draft sharing the model's weights, "
        f"lookahead {SPEC_LOOKAHEAD}, {SPEC_NEW} tokens; verify steps Sq "
        f"{SPEC_LOOKAHEAD + 1} through bound_causal + ALiBi): {len(acc)} rounds, "
        f"{sum(acc) / len(acc):.2f} tokens per round; tokens equal to the batch greedy row "
        f"{agree:.3f}")
    check(spec.shape == (1, SERVE_PROMPT + SPEC_NEW), "speculative output has the wrong shape")

    # Checks (their launches are not counted): the incremental decode
    # against a full recompute without a cache (causal ALiBi at the
    # sequence's own Sk - Sq distance, where the cached steps take the
    # cache's), and that two faults planted in the cache read above it.
    step_logits = timer.logits()
    check(toks.shape == (ALIBI_BATCH, SERVE_PROMPT + SERVE_NEW)
          and torch.isfinite(step_logits).all(), "ALiBi serving: bad greedy output")
    with torch.inference_mode():
        full = torch.cat([model(toks[i : i + 1, :-1])[:, SERVE_PROMPT - 1 :].clone()
                          for i in range(ALIBI_BATCH)])
    e_full = rel_l2(step_logits, full)
    agree_full = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    log(f"  incremental decode vs full recompute without a cache: logits rel-L2 {e_full:.3e}, "
        f"argmax agreement {agree_full:.3f}")
    check(e_full < SERVE_RECOMPUTE_TOL, "ALiBi incremental decode disagrees with the recompute")
    out.update(recompute_rel_l2=e_full, recompute_argmax_agreement=agree_full,
               **recompute_fault_readings(model, toks, full, step_logits))
    del model, draft, full
    torch.cuda.empty_cache()
    return counts, out


def bert_phase(dev, card):
    """Phase 10 (c): BERT-large over a right-padded batch (the counted
    path: one forward), then each sequence alone against its rows."""
    import torch
    from liteattention_torch.models.bert import BertConfig, BertForPreTraining

    cfg = BertConfig(dim=1024, num_layers=24, num_heads=16, ffn_dim=4096)
    model = BertForPreTraining(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(3))
    model.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ), generator=g, device=dev)
    lens = torch.randint(BERT_MIN_LEN, BERT_SEQ + 1, (BERT_BATCH,), generator=g, device=dev)
    mask = (torch.arange(BERT_SEQ, device=dev)[None] < lens[:, None]).to(torch.int32)
    with torch.inference_mode():
        model(ids[:2, :64])  # warm-up, not counted
        reset_counts()
        logits, nsp = model(ids, mask)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["flash_fwd_bound"] == cfg.num_layers and counts["flash_fwd"] == 0,
              f"BERT-large: expected {cfg.num_layers} bound B1 launches, got {counts}")
        check(torch.isfinite(logits).all() and torch.isfinite(nsp).all()
              and logits.shape == (BERT_BATCH, BERT_SEQ, cfg.vocab_size), "BERT-large: bad output")
        worst = 0.0
        for i, n in enumerate(lens.tolist()):
            alone, _ = model(ids[i : i + 1, :n])
            worst = max(worst, rel_l2(logits[i, :n], alone[0]))
        ms = cuda_ms(lambda: model(ids, mask), reps=5)
    valid = int(lens.sum().item())
    out = {"ms_per_batch": ms, "valid_tokens_per_s": valid * 1e3 / ms, "valid_tokens": valid,
           "padded_tokens": BERT_BATCH * BERT_SEQ, "worst_padded_vs_alone_rel_l2": worst}
    log(f"  BERT-large ({cfg.num_layers} layers, {cfg.num_heads} heads of 64), {BERT_BATCH} "
        f"sequences right-padded to {BERT_SEQ} ({valid} valid tokens): {counts['flash_fwd_bound']} "
        f"bound B1 launches a forward; {ms:.2f} ms a batch (events) = "
        f"{out['valid_tokens_per_s']:.0f} valid tokens/s [{card}]; each sequence alone vs its "
        f"padded rows: worst rel-L2 {worst:.3e} (limit {BERT_PAD_TOL})")
    check(worst <= BERT_PAD_TOL, "BERT-large: a padded sequence differs from the sequence alone")
    del model, logits
    torch.cuda.empty_cache()
    return counts, out


def alibi_api_check(dev):
    """Phase 10 (d): flash_attn_func and flash_attn_qkvpacked_func with
    ``alibi_slopes`` on the card (the counted path) against the plain
    version on the same inputs."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_func, flash_attn_qkvpacked_func
    from liteattention_torch.modules.mha import alibi_slopes
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(99)
    qkv = torch.randn(2, 600, 3, 40, 128, generator=g, device=dev).to(torch.bfloat16)
    slopes = alibi_slopes(40).to(dev)
    reset_counts()
    outs = {"flash_attn_func causal [B, H] slopes": (
                flash_attn_func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True,
                                alibi_slopes=slopes.expand(2, 40)), True),
            "flash_attn_qkvpacked_func [H] slopes": (
                flash_attn_qkvpacked_func(qkv, alibi_slopes=slopes), False)}
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["flash_fwd_alibi"] == 2, f"API with alibi_slopes: {counts}")
    qh, kh, vh = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    err = 0.0
    for name, (out, causal) in outs.items():
        ro, _ = flash_attention_plain(qh, kh, vh, causal=causal, alibi_slopes=slopes)
        e = (out.transpose(1, 2).float() - ro.float()).abs().max().item()
        err = max(err, e)
        log(f"  {name} on the card vs the plain version: max|out| err {e:.3e}")
        check(e < OUT_TOL, f"{name} disagrees")
    return counts, err


def channel_phase(dev, card):
    """Phase 10: B1's channels, then the ALiBi and padded-batch paths."""
    import torch

    torch.cuda.empty_cache()
    log("  (a) B1's bound, low and ALiBi channels against their plain versions")
    kres = channel_kernel_phase(dev)
    counts, stats = {}, {}
    log("  (b) Baichuan2-13B serving at full width and depth")
    counts["alibi_serve"], stats["baichuan2_13b"] = alibi_serve_phase(dev, card)
    log("  (c) BERT-large over a right-padded batch")
    counts["bert"], stats["bert_large"] = bert_phase(dev, card)
    log("  (d) the flash API with alibi_slopes")
    counts["alibi_api"], api_err = alibi_api_check(dev)
    kres["flash_fwd_alibi"]["err"] = max(kres["flash_fwd_alibi"]["err"], api_err)
    return counts, kres, stats


# ---------------------------------------------------------------- phase 11

# B7's channels at Baichuan2-13B's training shape (b, h, S, d: causal
# ALiBi), and ALiBi with bound_causal over two cache capacities (b, h, Sq,
# bounds, capacities, d).
BAICHUAN_TRAIN_SHAPE = (4, 40, 2048, 128)
ALIBI_CAPACITY_SHAPE = (2, 40, 512, (1100, 1900), (2048, 4096), 128)
# BERT-large pretraining on phase 10's batch: AdamW steps, the share of
# valid tokens masked for MLM, the learning rate (at 1e-4 from random
# weights, no warm-up, the loss went 11.74, 15.10, 13.67, 14.61, 11.25 on
# an H100); bert-large-uncased's [MASK] id.
BERT_TRAIN_STEPS, BERT_MLM_SHARE, BERT_LR = 5, 0.15, 2e-5
BERT_MASK_ID = 103
# rel-L2 of each parameter's gradient, those sequences alone against their
# share of the padded batch: bf16 products on both sides, GEMMs at other
# row counts (the small models' bf16 gradient bound).
BERT_PAD_GRAD_TOL = SMALL_GRAD_TOL
# The Baichuan2-13B-width ALiBi GPT: depth (of 40), batch x tokens, AdamW
# steps through training/trainer.py, learning rate.
ALIBI_TRAIN_LAYERS, ALIBI_TRAIN_BATCH, ALIBI_TRAIN_SEQ = 2, 4, 2048
ALIBI_TRAIN_STEPS, ALIBI_TRAIN_LR = 3, 1e-4


def sdpa_bwd_backend_ms(label, q, k, v, dout, mask, scale):
    """One PyTorch call of the same backward: SDPA's backward (the
    memory-efficient backend first, then cuDNN and math) with ``mask``
    (boolean or additive), K/V expanded to the q heads, through
    torch.autograd.grad of its forward; (backend, device ms of the
    backward alone, timer), or (None, None, None) when no backend takes
    it."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    qg = q.detach().requires_grad_()
    kg, vg = (x.detach().repeat_interleave(group, dim=1).requires_grad_() for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    refused = []
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = sdpa(qg, kg, vg, attn_mask=mask, scale=scale)

            def call():
                return torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)

            call()
            torch.cuda.synchronize()
            ms, _, timer = device_ms(call, reps=10)
            return backend.name, ms, timer
        except RuntimeError as e:  # a backend that refuses the call, or runs out of memory
            refused.append(f"{backend.name}: {str(e).strip().splitlines()[0][:200]}")
            torch.cuda.empty_cache()
    log(f"  SDPA backward {label}: no backend took the call ({'; '.join(refused)})")
    return None, None, None


def check_bwd_channels(label, q, k, v, dout, kw, time_it=False, keep=False):
    """B7 with B1's per-batch channels (``kw``: kv_bound, kv_low,
    bound_causal, alibi_slopes, causal, scale), checked by ``verify_bwd``
    with the subnormal floor. With ``time_it`` also the whole backward's
    device time beside its bound (the visible key pairs and the key rows
    inside each batch's range), the plain version's time and SDPA's
    backward with the equivalent mask or bias. ``keep``: also return (dq,
    dk, dv)."""
    import torch
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd, flash_bwd_plain
    from liteattention_torch.ops.segments import segment_walk

    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    args, ch, grads, errs, rels = verify_bwd(label, q, k, v, dout, kw, floor=BWD_BLOCK_FLOOR)
    out, lse, dout, scale, causal = args[3], args[4], args[5], args[6], args[7]
    dq, dk, dv = grads
    res = {"err": max(errs.values()), "rel_l2": max(t for t, _ in rels.values()),
           "worst_block_rel_l2": max(w for _, w in rels.values()),
           "no_key_rows": int((~torch.isfinite(lse)).sum())}
    if time_it:
        bound_t, low_t = ch.get("kv_bound"), ch.get("kv_low")
        vis = visible_keys(b, sq, sk, q.device, causal, bound_t, low_t,
                           ch.get("bound_causal", False), ch.get("q_segments"),
                           ch.get("kv_segments"))
        pairs = int(vis.sum().item()) * h
        lim = torch.full((b,), sk, device=q.device) if bound_t is None else bound_t.clamp(0, sk)
        first = torch.zeros_like(lim) if low_t is None else low_t.clamp(0, sk)
        key_rows = int((lim - first).clamp_min(0).sum().item())
        kv_bytes = 2 * key_rows * hk * d * k.element_size()
        res["bound_ms"], res["bound_by"] = bound(
            10 * d * pairs, nbytes(q, out, dout, lse, dq, dk, dv) + kv_bytes)
        res["visible_pairs"] = pairs
        timed = ch
        if "q_segments" in ch:  # as autograd runs it: on the forward's segment walk
            res["call_ms"], _, res["call_timer"] = device_ms(lambda: flash_attention_bwd(*args,
                                                                                       **ch))
            timed = dict(ch, segment_walk=segment_walk(ch["q_segments"], ch["kv_segments"]))
        res["ms"], _, res["timer"] = device_ms(lambda: flash_attention_bwd(*args, **timed))
        res["plain_ms"] = cuda_ms(lambda: flash_bwd_plain(*args, **ch), reps=1)
        slopes = ch.get("alibi_slopes")
        if slopes is None:
            mask, kind = vis, "a boolean mask"
        else:
            slopes = slopes.float().reshape(-1, h).expand(b, h)[:, :, None, None]
            dist = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                    - torch.arange(sk, device=q.device)[None, :]).float()
            dist = dist if causal else dist.abs()
            mask = (-slopes * dist).masked_fill(~vis, -torch.inf).to(q.dtype)
            kind = "an additive ALiBi bias"
        backend, res["library_ms"], t_lib = sdpa_bwd_backend_ms(
            f"B7 {label}", q, k, v, dout, mask, scale)
        res["library"] = (None if backend is None
                          else f"SDPA {backend} backward with {kind} ({t_lib})")
        del mask
        torch.cuda.empty_cache()
        lib = "n/a" if backend is None else f"{res['library_ms']:.4f} ms {res['library']}"
        if "call_ms" in res:
            log(f"  B7 {label}: the whole call (ranges and kernels) {res['call_ms']:.4f} ms "
                f"({res['call_timer']})")
        log(f"  B7 {label}: backward {res['ms']:.4f} ms ({res['timer']}), plain "
            f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{pairs} visible pairs), library {lib}")
    return (res, (dq, dk, dv)) if keep else res


def bwd_capacity_check(rnd, dev):
    """ALiBi with bound_causal over two cache capacities (MHA's route over
    a KV cache): each against its plain version, and the valid keys'
    gradients across the capacities. They cannot be the same bits: B1
    returns lse less slope * (Sk - bound) and B7 adds it back, so lse
    comes back rounded at that constant's size, which differs between the
    capacities; they are held by B7's rel-L2 limits and the share of equal
    bits is logged."""
    import torch
    from liteattention_torch.modules.mha import alibi_slopes

    b, h, sq, bounds, caps, d = ALIBI_CAPACITY_SHAPE
    q, dout = rnd(b, h, sq, d), rnd(b, h, sq, d)
    k_all, v_all = rnd(b, h, max(caps), d), rnd(b, h, max(caps), d)
    bound_t = torch.tensor(bounds, dtype=torch.int32, device=dev)
    kw = dict(kv_bound=bound_t, bound_causal=True, alibi_slopes=alibi_slopes(h).to(dev))
    runs = {}
    for cap in caps:
        k, v = k_all[:, :, :cap].contiguous(), v_all[:, :, :cap].contiguous()
        runs[cap] = check_bwd_channels(
            f"ALiBi + bound_causal {b}x{h}x{sq}x{d} over a {cap}-key cache, bounds {bounds}",
            q, k, v, dout, kw, keep=True)
    (small_res, small), (big_res, big) = runs[caps[0]], runs[caps[1]]
    rels, same = {}, {}
    for i, name in enumerate(("dq", "dk", "dv")):
        for j, n in enumerate(bounds):
            got, ref = big[i][j : j + 1], small[i][j : j + 1]
            if i:  # dK, dV: the keys inside the bound
                got, ref = got[:, :, :n], ref[:, :, :n]
            t, w = block_rel_l2(got, ref, floor=BWD_BLOCK_FLOOR)
            prev = rels.get(name, (0.0, 0.0))
            rels[name] = (max(prev[0], t), max(prev[1], w))
            same[name] = same.get(name, 0.0) + (got == ref).float().mean().item() / len(bounds)
    log(f"  B7 ALiBi + bound_causal, cache {caps[1]} vs {caps[0]} over the valid keys: rel-L2 "
        + ", ".join(f"{n} {t:.2e} / worst block {w:.2e} ({same[n]:.4f} of the values equal)"
                    for n, (t, w) in rels.items()))
    for name, (t, w) in rels.items():
        check(t < BWD_TOL and w < BWD_BLOCK_TOL,
              f"B7 ALiBi over two capacities: {name} rel-L2 {t:.3e} / block {w:.3e}")
    return {"err": max(small_res["err"], big_res["err"]),
            "capacity_rel_l2": {n: t for n, (t, _) in rels.items()},
            "capacity_equal_share": same}


def bwd_channel_kernel_phase(dev):
    """Phase 11 (a): B7's bound, low, bound_causal and ALiBi channels at the
    training paths' shapes and at the edges, each against its plain
    versions; the paths' shapes timed. Returns the kernels line's
    flash_bwd_bound and flash_bwd_alibi entries."""
    import torch
    from liteattention_torch.modules.mha import alibi_slopes

    g = torch.Generator(device=dev).manual_seed(1357)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def ints(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=dev, dtype=torch.int32)

    bound_res, alibi_res = {}, {}
    # BERT-large's attention: right-padded lengths, non-causal.
    b, h, s, d = BERT_BATCH, 16, BERT_SEQ, 64
    lens = ints(BERT_MIN_LEN, BERT_SEQ, b)
    bound_res["bert_large_padded"] = check_bwd_channels(
        f"bound {b}x{h}x{s}x{d}, lengths {BERT_MIN_LEN}-{BERT_SEQ}", rnd(b, h, s, d),
        rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d), dict(kv_bound=lens), time_it=True)
    # A left-padded cache (kv_low) with Sq rows at its end, GQA.
    b, h, hk, sq, sk, d = CACHE_APPEND_SHAPE
    low, bound_t = ints(0, sk // 4 - 1, b), ints(sk // 2, sk, b)
    bound_res["cache_low_bound_causal"] = check_bwd_channels(
        f"bound + low + bound_causal {b}x{h}/{hk}x{sq}x{d} over {sk} keys",
        rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d), rnd(b, h, sq, d),
        dict(kv_bound=bound_t, kv_low=low, bound_causal=True), time_it=True)
    # Rows that see no key (bound 0, bound == low, bound < low, bound_causal
    # with bound < Sq), whole k-tiles past the bound or below the low key,
    # and the low key inside a tile under causal.
    edges = (("no-key rows", dict(kv_bound=torch.tensor([0, 100, 90, 60], device=dev),
                                  kv_low=torch.tensor([0, 100, 120, 0], device=dev),
                                  bound_causal=True)),
             ("low inside a tile, causal", dict(
                 kv_bound=torch.tensor([260, 200, 255, 129], device=dev),
                 kv_low=torch.tensor([5, 129, 250, 0], device=dev), causal=True)))
    bound_res["edges"] = {"err": max(
        check_bwd_channels(f"{label} 4x2x150x64 over 260 keys", rnd(4, 2, 150, 64),
                           rnd(4, 2, 260, 64), rnd(4, 2, 260, 64), rnd(4, 2, 150, 64),
                           kw)["err"] for label, kw in edges)}
    # ALiBi: Baichuan2-13B's training shape (causal, Sk = Sq), two cache
    # capacities with bound_causal, non-causal Sq != Sk with [B, H] slopes
    # at BTLM's 1/d scale, and GQA rows with no key.
    b, h, s, d = BAICHUAN_TRAIN_SHAPE
    slopes = alibi_slopes(h).to(dev)
    alibi_res["baichuan_train"] = check_bwd_channels(
        f"ALiBi causal {b}x{h}x{s}x{d} (Baichuan2-13B training)", rnd(b, h, s, d),
        rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d),
        dict(alibi_slopes=slopes, causal=True), time_it=True)
    alibi_res["cache_capacities"] = bwd_capacity_check(rnd, dev)
    b, h, sq, sk, d = ALIBI_NONCAUSAL_SHAPE
    bh = slopes * torch.linspace(1.0, 0.5, b, device=dev)[:, None]
    alibi_res["noncausal_bh_scale_d"] = check_bwd_channels(
        f"ALiBi non-causal {b}x{h}x{sq}x{d} over {sk} keys, [B, H] slopes, scale 1/d",
        rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d), rnd(b, h, sq, d),
        dict(alibi_slopes=bh, scale=1.0 / d))
    r = check_bwd_channels(
        "ALiBi + bound_causal, no-key rows 2x10/2x300x64 over 400 keys",
        rnd(2, 10, 300, 64), rnd(2, 2, 400, 64), rnd(2, 2, 400, 64), rnd(2, 10, 300, 64),
        dict(alibi_slopes=alibi_slopes(10).to(dev), bound_causal=True,
             kv_bound=torch.tensor([100, 400], dtype=torch.int32, device=dev)))
    check(r["no_key_rows"] > 0, "B7 ALiBi edges: no row without a key was tested")
    alibi_res["edges"] = {"err": r["err"]}
    torch.cuda.empty_cache()
    return {"flash_bwd_bound": _channel_entry(bound_res, "bert_large_padded"),
            "flash_bwd_alibi": _channel_entry(alibi_res, "baichuan_train")}


def pretrain_loss(model, ids, mask, types, pos, labels, nsp, n_mlm, n_seq, rows=None):
    """BERT's pretraining loss: MLM cross-entropy summed over the masked
    positions ``pos`` over ``n_mlm``, plus NSP cross-entropy summed over
    the sequences over ``n_seq`` (fp32). ``rows`` (bool ``[B]``): only
    those sequences' terms, so that a batch's loss is the sum of its
    sequences' shares."""
    import torch.nn.functional as F

    mlm, nsp_logits = model(ids, mask, types)
    nsp_ce = F.cross_entropy(nsp_logits.float(), nsp, reduction="none")
    if rows is not None:
        pos = pos & rows[:, None]
        nsp_ce = nsp_ce * rows
    sel = pos.nonzero(as_tuple=True)
    mlm_sum = F.cross_entropy(mlm[sel].float(), labels[sel], reduction="sum")
    return mlm_sum / n_mlm + nsp_ce.sum() / n_seq


def bert_batch(dev, cfg, b, s, min_len, seed):
    """A right-padded pretraining batch: ids, mask, segment ids (A then B),
    lengths, MLM positions (BERT_MLM_SHARE of the valid tokens, [MASK] in
    the input, the original ids as labels) and NSP labels."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    lens = torch.randint(min_len, s + 1, (b,), generator=g, device=dev)
    col = torch.arange(s, device=dev)[None]
    mask = (col < lens[:, None]).to(torch.int32)
    types = ((col >= (lens // 2)[:, None]) & mask.bool()).long()
    pos = (torch.rand(b, s, generator=g, device=dev) < BERT_MLM_SHARE) & mask.bool()
    pos[:, 0] = True  # at least one masked position a sequence
    inp = ids.masked_fill(pos, BERT_MASK_ID)
    nsp = torch.randint(0, 2, (b,), generator=g, device=dev)
    return inp, mask, types, lens, pos, ids, nsp


def bert_train_phase(dev, card):
    """Phase 11 (b): BERT-large pretraining (MLM + NSP) on phase 10's
    right-padded batch, fp32 master weights, bf16 products, AdamW (the
    counted path); then the gradient of a few sequences alone against their
    share of the padded batch's."""
    import torch
    from liteattention_torch.models.bert import BertConfig, BertForPreTraining

    cfg = BertConfig(dim=1024, num_layers=24, num_heads=16, ffn_dim=4096)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = BertForPreTraining(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(3))
    n_params = sum(p.numel() for p in model.parameters())
    inp, mask, types, lens, pos, labels, nsp = bert_batch(dev, cfg, BERT_BATCH, BERT_SEQ,
                                                          BERT_MIN_LEN, seed=4)
    n_mlm, n_seq = int(pos.sum().item()), BERT_BATCH
    batch = (inp, mask, types, pos, labels, nsp, n_mlm, n_seq)
    opt = torch.optim.AdamW(model.parameters(), lr=BERT_LR, weight_decay=0.01)
    log(f"  BERT-large: {n_params / 1e6:.1f} M parameters (fp32 master, bf16 products), "
        f"{BERT_BATCH} sequences right-padded to {BERT_SEQ} ({int(lens.sum())} valid tokens), "
        f"MLM on {n_mlm} positions + NSP, AdamW lr {BERT_LR}, {BERT_TRAIN_STEPS} steps on "
        "the one batch")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = pretrain_loss(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    pretrain_loss(model, *batch).backward()  # warm-up (cuBLAS, allocator), not counted
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    reset_counts()
    losses, step_ms = [], []
    for _ in range(BERT_TRAIN_STEPS):
        loss, ms = events_ms(step)
        losses.append(loss.item())
        step_ms.append(ms)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the training steps: {counts}")
    log(f"  loss per step {[round(x, 4) for x in losses]}; ms/step (fwd + bwd + AdamW, events) "
        f"{[round(x, 2) for x in step_ms]}; peak {peak:.2f} GB [{card}]")
    check(all(math.isfinite(x) for x in losses), "BERT-large training loss is not finite")
    check(losses[-1] < losses[0], "BERT-large training loss does not fall on a fixed batch")
    want = cfg.num_layers * BERT_TRAIN_STEPS
    check(counts["flash_fwd_bound"] == want and counts["flash_bwd_bound"] == want
          and counts["flash_fwd"] == 0 and counts["flash_bwd_dq"] == 0,
          f"BERT-large training: expected {cfg.num_layers} bound launches of B1 and of B7 a step")

    # The padded batch's gradient, the share of a few sequences, against
    # those sequences run alone (unpadded, no mask: the channel-free
    # kernels), with the batch's normalisers.
    order = torch.argsort(lens).tolist()
    pick = [order[0], order[len(order) // 2], order[-1]]
    rows = torch.zeros(BERT_BATCH, dtype=torch.bool, device=dev)
    rows[pick] = True
    model.zero_grad(set_to_none=True)
    pretrain_loss(model, *batch, rows=rows).backward()
    share = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    for i in pick:
        n = int(lens[i])
        sl = (slice(i, i + 1), slice(0, n))
        pretrain_loss(model, inp[sl], None, types[sl], pos[sl], labels[sl], nsp[i : i + 1],
                      n_mlm, n_seq).backward()
    errs = {n: rel_l2(p.grad, share[n]) for n, p in model.named_parameters()
            if share[n].abs().max() > 0}
    worst = max(errs, key=errs.get)
    log(f"  gradient of sequences {pick} (lengths {[int(lens[i]) for i in pick]}) alone vs their "
        f"share of the padded batch: worst parameter rel-L2 {errs[worst]:.3e} ({worst}; limit "
        f"{BERT_PAD_GRAD_TOL})")
    check(errs[worst] < BERT_PAD_GRAD_TOL,
          "BERT-large: a sequence's gradient alone differs from its share of the padded batch")
    steady = step_ms[1:]
    out = {"ms_per_step": step_ms, "median_ms_per_step": statistics.median(steady),
           "valid_tokens_per_s": int(lens.sum()) * 1e3 / statistics.median(steady),
           "losses": losses, "peak_gb": peak, "parameters_m": n_params / 1e6,
           "pad_grad_worst_rel_l2": errs[worst]}
    del model, opt, share
    torch.cuda.empty_cache()
    return counts, out


def alibi_train_phase(dev, card):
    """Phase 11 (c): a Baichuan2-13B-width ALiBi GPT, its depth cut, trained
    through training/trainer.py on one repeated batch (the counted path)."""
    import itertools

    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.training.data import synthetic_lm_batches
    from liteattention_torch.training.trainer import TrainConfig, Trainer

    cfg = baichuan2_13b_config(ALIBI_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(21))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = ALIBI_TRAIN_BATCH * ALIBI_TRAIN_SEQ
    batch = next(synthetic_lm_batches(cfg.vocab_size, ALIBI_TRAIN_BATCH, ALIBI_TRAIN_SEQ, seed=22))
    tcfg = TrainConfig(learning_rate=ALIBI_TRAIN_LR, warmup_steps=0, total_steps=1000,
                       grad_clip=1.0)
    trainer = Trainer(model, lambda m, x: gpt_loss_fn(m, x, x), tcfg, device=dev)
    log(f"  Baichuan2-13B width: dim {cfg.dim}, {cfg.num_layers} of 40 layers, {cfg.num_heads} "
        f"heads x {cfg.dim // cfg.num_heads}, ALiBi, ffn {cfg.ffn_dim}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.3f} B parameters (fp32 master, bf16 products); "
        f"{ALIBI_TRAIN_BATCH} x {ALIBI_TRAIN_SEQ} tokens, one repeated batch, "
        f"{ALIBI_TRAIN_STEPS} AdamW steps (lr {ALIBI_TRAIN_LR}) through Trainer.fit")
    x = torch.as_tensor(batch, device=dev)
    gpt_loss_fn(model, x, x).backward()  # warm-up (cuBLAS, allocator), not counted
    model.zero_grad(set_to_none=True)
    del x
    torch.cuda.synchronize()
    reset_counts()
    recs = []
    trainer.fit(itertools.repeat(batch), ALIBI_TRAIN_STEPS, log_every=1,
                tokens_per_batch=tokens, log_fn=recs.append)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in recs]
    step_ms = [1e3 / r["steps_per_s"] for r in recs]
    log(f"  launches during the training steps: {counts}")
    ms = statistics.median(step_ms)
    log(f"  loss per step {[round(v, 4) for v in losses]}; ms/step (host clock to the loss) "
        f"{[round(v, 1) for v in step_ms]}, median {ms:.1f} = {tokens / ms * 1e3:.0f} tokens/s; "
        f"peak {peak:.2f} GB [{card}]")
    check(all(math.isfinite(v) for v in losses), "ALiBi GPT training loss is not finite")
    check(losses[-1] < losses[0], "ALiBi GPT training loss does not fall on a repeated batch")
    want = cfg.num_layers * ALIBI_TRAIN_STEPS
    check(counts["flash_fwd_alibi"] == want and counts["flash_bwd_alibi"] == want
          and counts["flash_fwd"] == 0 and counts["flash_bwd_dq"] == 0,
          f"ALiBi GPT training: expected {cfg.num_layers} ALiBi launches of B1 and of B7 a step")
    out = {"ms_per_step": step_ms, "median_ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "losses": losses, "peak_gb": peak, "parameters_b": n_params / 1e9,
           "layers": cfg.num_layers}
    del trainer, model
    torch.cuda.empty_cache()
    return counts, out


def check_train_step(dev, label, cpu, gpu, loss_fn, counters, want):
    """One training step's loss and gradients of ``gpu`` (on the card,
    bf16) against ``cpu`` (the same weights, fp32, the plain versions):
    ``loss_fn(model, device)``; the launch counters ``counters`` ((wrapper,
    attribute) pairs) must move by ``want``. Returns the larger of the
    loss's relative error and the worst parameter's gradient rel-L2."""
    import torch

    ref = loss_fn(cpu, "cpu")
    ref.backward()
    n0 = [getattr(fn, attr) for fn, attr in counters]
    loss = loss_fn(gpu, dev)
    loss.backward()
    torch.cuda.synchronize()
    got = [getattr(fn, attr) - n for (fn, attr), n in zip(counters, n0)]
    check(got == want, f"{label}: channel launches {got}, expected {want}")
    e_loss = abs(loss.item() - ref.item()) / abs(ref.item())
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    e_grad = {n: rel_l2(p.grad.float().cpu(), grads[n]) for n, p in gpu.named_parameters()
              if grads[n].abs().max() > 0}
    worst = max(e_grad, key=e_grad.get)
    log(f"  {label}, bf16 card vs fp32 CPU: loss {loss.item():.5f} vs {ref.item():.5f} (rel "
        f"{e_loss:.2e}), worst grad rel-L2 {e_grad[worst]:.2e} ({worst})")
    check(e_loss < SMALL_LOSS_TOL, f"{label}: loss disagrees")
    check(e_grad[worst] < SMALL_GRAD_TOL, f"{label}: gradients disagree")
    return max(e_loss, e_grad[worst])


def small_channel_train_check(dev):
    """Phase 11 (d): one step's loss and gradients of small models on the
    card (bf16, B1's and B7's channels) against the CPU (fp32, the plain
    versions), from the same weights: a 2-layer ALiBi GPT at dim 384 with 6
    heads of 64 and with 3 of 128 (head counts whose slopes take the
    interleave), and a 2-layer BERT over a right-padded batch."""
    import torch
    from liteattention_torch.models.bert import BertConfig, BertForPreTraining
    from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.ops.flash_bwd import flash_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention

    worst = 0.0
    alibi = ((flash_attention, "alibi_launches"), (flash_bwd, "alibi_launches"))
    ids = torch.randint(0, 1000, (2, 300), generator=torch.Generator().manual_seed(32))
    for heads in (6, 3):
        cfg = dataclasses.replace(baichuan2_13b_config(2), dim=384, num_heads=heads,
                                  vocab_size=1000, ffn_dim=1024)
        cpu = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
        cpu.reset_parameters(torch.Generator().manual_seed(31))
        gpu = GPTLMHeadModel(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        worst = max(worst, check_train_step(
            dev, f"small ALiBi GPT (dim 384, 2 layers, {heads} heads of {384 // heads}, 2 x 300)",
            cpu, gpu, lambda m, where: gpt_loss_fn(m, ids.to(where), ids.to(where)), alibi,
            [2, 2]))
    cfg = BertConfig(vocab_size=1000, dim=256, num_layers=2, num_heads=4, ffn_dim=1024)
    cpu = BertForPreTraining(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(33))
    gpu = BertForPreTraining(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    batch = bert_batch(torch.device("cpu"), cfg, 4, 300, 1, seed=34)
    inp, mask, types, _, pos, labels, nsp = batch
    n_mlm = int(pos.sum())

    def bert_loss(m, where):
        t = [x.to(where) for x in (inp, mask, types, pos, labels, nsp)]
        return pretrain_loss(m, *t, n_mlm, 4)

    bound = ((flash_attention, "bound_launches"), (flash_bwd, "bound_launches"))
    worst = max(worst, check_train_step(
        dev, "small BERT (dim 256, 2 layers, 4 heads of 64, 4 x 300 padded)", cpu, gpu, bert_loss,
        bound, [2, 2]))
    return worst


def alibi_api_grad_check(dev):
    """Phase 11 (e): the gradient of flash_attn_func (causal, [B, H]
    slopes) and flash_attn_qkvpacked_func ([H] slopes) with
    ``alibi_slopes`` on the card (the counted path) against B7a's / B7b's
    plain versions on the plain forward's out and lse."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_func, flash_attn_qkvpacked_func
    from liteattention_torch.modules.mha import alibi_slopes
    from liteattention_torch.ops.flash_bwd import flash_bwd_dkv_plain, flash_bwd_dq_plain
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(98)
    b, s, h, d = 2, 600, 40, 128
    qkv = torch.randn(b, s, 3, h, d, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
    slopes = alibi_slopes(h).to(dev)
    reset_counts()
    q, k, v = (qkv[:, :, i].detach().requires_grad_() for i in range(3))
    flash_attn_func(q, k, v, causal=True, alibi_slopes=slopes.expand(b, h)).backward(dout)
    packed = qkv.detach().requires_grad_()
    flash_attn_qkvpacked_func(packed, alibi_slopes=slopes).backward(dout)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["flash_bwd_alibi"] == 2 and counts["flash_fwd_alibi"] == 2,
          f"API gradient with alibi_slopes: {counts}")
    heads = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    qh, kh, vh, doh = (heads(x) for x in (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dout))
    err = 0.0
    for name, grads, causal in (
            ("flash_attn_func causal [B, H] slopes", (q.grad, k.grad, v.grad), True),
            ("flash_attn_qkvpacked_func [H] slopes", packed.grad.unbind(2), False)):
        o, lse = flash_attention_plain(qh, kh, vh, causal=causal, alibi_slopes=slopes)
        delta = (o.float() * doh.float()).sum(-1)
        args = (qh, kh, vh, doh, lse, delta, d**-0.5, causal)
        refs = (flash_bwd_dq_plain(*args, alibi_slopes=slopes),
                *flash_bwd_dkv_plain(*args, alibi_slopes=slopes))
        rels = [block_rel_l2(heads(gr), r, floor=BWD_BLOCK_FLOOR) for gr, r in zip(grads, refs)]
        err = max(err, max((heads(gr).float() - r.float()).abs().max().item()
                           for gr, r in zip(grads, refs)))
        log(f"  {name}: gradient on the card vs the plain versions: rel-L2 tensor / worst "
            "block " + ", ".join(f"d{n} {t:.2e} / {w:.2e}" for n, (t, w) in zip("qkv", rels)))
        check(all(t < BWD_TOL and w < BWD_BLOCK_TOL for t, w in rels), f"{name}: gradient disagrees")
    return counts, err


def channel_train_phase(dev, card):
    """Phase 11: B7's channels, then training through B1's and B7's."""
    import torch

    torch.cuda.empty_cache()
    log("  (a) B7's bound, low and ALiBi channels against their plain versions")
    kres = bwd_channel_kernel_phase(dev)
    counts, stats = {}, {}
    log("  (b) BERT-large pretraining over a right-padded batch")
    counts["bert_train"], stats["bert_large_train"] = bert_train_phase(dev, card)
    log("  (c) a Baichuan2-13B-width ALiBi GPT (2 of 40 layers) through training/trainer.py")
    counts["alibi_gpt_train"], stats["baichuan2_13b_width_train"] = alibi_train_phase(dev, card)
    log("  (d) small models' training step on the card against the CPU")
    stats["small_models_worst_rel"] = small_channel_train_check(dev)
    log("  (e) the gradient of the flash API with alibi_slopes")
    counts["alibi_api_grad"], api_err = alibi_api_grad_check(dev)
    kres["flash_bwd_alibi"]["err"] = max(kres["flash_bwd_alibi"]["err"], api_err)
    return counts, kres, stats


# ---------------------------------------------------------------- phase 12

# BTLM-3B-8K (cerebras/btlm-3b-8k-base config.json: n_embd 2560, n_layer 32,
# n_head 32, so head dim 80; n_inner 6826, vocab 50 257, n_positions 8192,
# ALiBi, SwiGLU, muP). btlm_config leaves ffn_dim to its 4 x dim default
# (10 240), as JAX's does (ROADMAP C), so the published width is passed
# here. Serving: requests x prompt tokens, greedy tokens, the cache (its
# context); training: tokens of the one sequence, AdamW steps, rate.
BTLM_FFN = 6826
BTLM_BATCH, BTLM_PROMPT, BTLM_NEW, BTLM_CONTEXT = 8, 4096, 64, 8192
BTLM_TRAIN_TOKENS, BTLM_TRAIN_STEPS, BTLM_TRAIN_LR = 8192, 3, 1e-4
# GPT-NeoX-20B's attention (config.json: hidden 6144, 64 heads of 96): b,
# h, S, d, causal. Its model is not run (ROADMAP B-iii 2).
NEOX_ATTN_SHAPE = (4, 64, 2048, 96)


def btlm_3b_8k_config(layers):
    """BTLM-3B-8K's published geometry at ``layers`` (of 32) layers:
    btlm_config's widths, muP multipliers and 1/d attention scale, with
    the published n_inner 6826."""
    from liteattention_torch.models.configs import btlm_config

    return dataclasses.replace(btlm_config(num_layers=layers), ffn_dim=BTLM_FFN)


def btlm_kernel_phase(dev):
    """Phase 12 (a): B1 and B7 at head dims 80 and 96 against their plain
    versions at the BTLM paths' shapes and at GPT-NeoX-20B's attention,
    each timed. Returns {name: result} (check_channels' for B1's ALiBi
    channel, check_bwd_channels' for B7's, check_flash's and check_bwd's
    for the channel-free kernels)."""
    import torch
    from liteattention_torch.modules.mha import alibi_slopes

    g = torch.Generator(device=dev).manual_seed(8080)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    b, h, d = BTLM_BATCH, 32, 80
    slopes = alibi_slopes(h).to(dev)
    res = {}
    # MHA's prefill into the cache: causal off, bound_causal on, Sk = the
    # cache's 8192 keys, the bound the prompt's 4096; BTLM's scale 1/d.
    kc, vc = rnd(b, h, BTLM_CONTEXT, d), rnd(b, h, BTLM_CONTEXT, d)
    prompt = torch.full((b,), BTLM_PROMPT, dtype=torch.int32, device=dev)
    res["fwd_alibi_prefill"] = check_channels(
        f"ALiBi prefill {b}x{h}x{BTLM_PROMPT}x{d} over a {BTLM_CONTEXT}-key cache, bound_causal, "
        "scale 1/d (BTLM)", rnd(b, h, BTLM_PROMPT, d), kc, vc,
        dict(kv_bound=prompt, bound_causal=True, alibi_slopes=slopes, scale=1.0 / d),
        time_it=True)
    torch.cuda.empty_cache()
    # The decode steps: Sq 1 at the bounds 64 greedy steps reach.
    steps = torch.randint(BTLM_PROMPT + 1, BTLM_PROMPT + BTLM_NEW + 1, (b,), generator=g,
                          device=dev, dtype=torch.int32)
    res["fwd_alibi_decode"] = check_channels(
        f"ALiBi single-token step {b}x{h}x1x{d} over {BTLM_CONTEXT} keys, bounds "
        f"{BTLM_PROMPT + 1}-{BTLM_PROMPT + BTLM_NEW} (BTLM)", rnd(b, h, 1, d), kc, vc,
        dict(kv_bound=steps, bound_causal=True, alibi_slopes=slopes, scale=1.0 / d),
        time_it=True)
    del kc, vc
    torch.cuda.empty_cache()
    # Training: one 8192-token sequence, causal ALiBi; then the channel-free
    # kernels at the same shape.
    s = BTLM_TRAIN_TOKENS
    q, k, v, dout = (rnd(1, h, s, d) for _ in range(4))
    kw = dict(alibi_slopes=slopes, causal=True, scale=1.0 / d)
    res["fwd_alibi_train"] = check_channels(
        f"ALiBi causal 1x{h}x{s}x{d}, scale 1/d (BTLM training)", q, k, v, kw, time_it=True)
    res["bwd_alibi_train"] = check_bwd_channels(
        f"ALiBi causal 1x{h}x{s}x{d}, scale 1/d (BTLM training)", q, k, v, dout, kw,
        time_it=True)
    torch.cuda.empty_cache()
    res["fwd_causal_d80"] = check_flash(q, k, v, f"causal 1x{h}x{s}x{d} (head dim 80)",
                                        causal=True, time_it=True, blocks=True)
    res["bwd_causal_d80"] = check_bwd(q, k, v, dout, f"causal 1x{h}x{s}x{d} (head dim 80)",
                                      True, time_it=True)
    del q, k, v, dout
    torch.cuda.empty_cache()
    b, h, s, d = NEOX_ATTN_SHAPE
    q, k, v, dout = (rnd(b, h, s, d) for _ in range(4))
    res["fwd_causal_d96"] = check_flash(q, k, v, f"causal {b}x{h}x{s}x{d} (GPT-NeoX-20B)",
                                        causal=True, time_it=True, blocks=True)
    res["bwd_causal_d96"] = check_bwd(q, k, v, dout, f"causal {b}x{h}x{s}x{d} (GPT-NeoX-20B)",
                                      True, time_it=True)
    del q, k, v, dout
    torch.cuda.empty_cache()
    return res


def small_btlm_check(dev):
    """A small BTLM at head dim 80 (5 heads: the slopes' interleave; muP,
    1/d, biases, ffn of its own) on the card against the CPU: its decode
    (small_alibi_check), then one training step's loss and gradients
    (check_train_step; B1 and B7 at D 80)."""
    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.ops.flash_bwd import flash_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention

    cfg = dataclasses.replace(btlm_3b_8k_config(2), dim=400, num_heads=5, vocab_size=1000,
                              ffn_dim=1024)
    err = small_alibi_check(dev, cfg, "small BTLM (dim 400, 2 layers, 5 heads of 80)")
    cpu = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(41))
    gpu = GPTLMHeadModel(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 1000, (2, 300), generator=torch.Generator().manual_seed(43))
    alibi = ((flash_attention, "alibi_launches"), (flash_bwd, "alibi_launches"))
    worst = check_train_step(dev, "small BTLM training step (2 x 300)", cpu, gpu,
                             lambda m, where: gpt_loss_fn(m, x.to(where), x.to(where)), alibi,
                             [cfg.num_layers, cfg.num_layers])
    return {"decode_logits_rel_l2": err, "train_step_worst_rel": worst}


def btlm_serve_phase(dev, card):
    """Phase 12 (b): BTLM-3B-8K serving at full width and depth (the counted
    path: greedy decoding of BTLM_BATCH requests into a BTLM_CONTEXT cache),
    then its checks."""
    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import greedy_decode

    cfg = btlm_3b_8k_config(32)
    log(f"  BTLM-3B-8K: dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} heads x "
        f"{cfg.dim // cfg.num_heads}, ALiBi, SwiGLU ffn {cfg.ffn_dim} (published; btlm_config's "
        f"default gives {4 * cfg.dim}), vocab {cfg.vocab_size}, muP, scale 1/d; fp32 master "
        "weights, bf16 compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(50))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(51)
    ids = torch.randint(0, cfg.vocab_size, (BTLM_BATCH, BTLM_PROMPT), generator=g, device=dev)
    log(f"  {n_params / 1e9:.3f} B parameters; {BTLM_BATCH} requests x {BTLM_PROMPT} prompt "
        f"tokens, {BTLM_NEW} new tokens each, cache capacity {BTLM_CONTEXT}")
    greedy_decode(model, ids[:1, :16], 2, 32)  # warm-up, not counted

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timer = StepTimer(model)
    toks = greedy_decode(timer, ids, BTLM_NEW, BTLM_CONTEXT)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the BTLM serving run: {counts}")
    want = cfg.num_layers * len(timer.calls)
    check(counts["flash_fwd_alibi"] == want,
          f"BTLM serving: expected {want} ALiBi B1 launches (one per layer per model call)")
    check(counts["flash_decode"] == 0, "BTLM serving: a step went to the decode kernel B8")
    n_decode = len(timer.calls) - 1
    prefill_ms = timer.calls[0][1]
    step_ms = [ms for _, ms in timer.calls[1:]]
    dec_ms = statistics.median(step_ms)
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": dec_ms,
           "decode_tokens_per_s": BTLM_BATCH * 1e3 / dec_ms,
           "end_to_end_tokens_per_s": BTLM_BATCH * BTLM_NEW * 1e3 / wall,
           "peak_gb": peak_gb, "decode_steps": n_decode, "parameters_b": n_params / 1e9,
           "alibi_launches": counts["flash_fwd_alibi"]}
    log(f"  prefill {prefill_ms:.1f} ms ({BTLM_BATCH * BTLM_PROMPT / prefill_ms * 1e3:.0f} "
        f"prompt tokens/s), decode {dec_ms:.2f} ms/step (median of {n_decode}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) = {out['decode_tokens_per_s']:.0f} "
        f"tokens/s; end to end {wall:.0f} ms = {out['end_to_end_tokens_per_s']:.0f} new "
        f"tokens/s; peak memory {peak_gb:.2f} GB [{card}]")

    # Checks (their launches are not counted): the incremental decode
    # against a full recompute without a cache, and two planted faults.
    step_logits = timer.logits()
    check(toks.shape == (BTLM_BATCH, BTLM_PROMPT + BTLM_NEW)
          and torch.isfinite(step_logits).all(), "BTLM serving: bad greedy output")
    with torch.inference_mode():
        full = torch.cat([model(toks[i : i + 1, :-1])[:, BTLM_PROMPT - 1 :].clone()
                          for i in range(BTLM_BATCH)])
    e_full = rel_l2(step_logits, full)
    agree_full = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    log(f"  incremental decode vs full recompute without a cache: logits rel-L2 {e_full:.3e}, "
        f"argmax agreement {agree_full:.3f}")
    check(e_full < SERVE_RECOMPUTE_TOL, "BTLM incremental decode disagrees with the recompute")
    out.update(recompute_rel_l2=e_full, recompute_argmax_agreement=agree_full,
               **recompute_fault_readings(model, toks, full, step_logits, prompt=BTLM_PROMPT,
                                          capacity=BTLM_CONTEXT))
    del model, full, step_logits, timer
    torch.cuda.empty_cache()
    return counts, out


def trainer_run(dev, card, cfg, label, batch, seq, steps, lr, seeds, loss_fn=None, before=None):
    """``cfg``'s model (fp32 master weights, bf16 products) trained on one
    repeated synthetic batch of ``batch`` x ``seq`` tokens through
    training/trainer.py, AdamW at ``lr`` for ``steps`` steps: the counted
    path (every count set to 0 just before, read just after). ``seeds``:
    the weights' and the batch's; ``loss_fn(model, x)`` (default
    ``gpt_loss_fn(model, x, x)``) the step's loss; ``before(model, x)``
    runs on the new model and the batch before the warm-up. Returns the
    counts and {ms_per_step, median_ms_per_step, tokens_per_s, losses,
    peak_gb, parameters_b, layers}; the losses must be finite."""
    import itertools

    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.training.data import synthetic_lm_batches
    from liteattention_torch.training.trainer import TrainConfig, Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss_fn = loss_fn or (lambda m, x: gpt_loss_fn(m, x, x))
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seeds[0]))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    data = next(synthetic_lm_batches(cfg.vocab_size, batch, seq, seed=seeds[1]))
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=0, total_steps=1000, grad_clip=1.0)
    trainer = Trainer(model, loss_fn, tcfg, device=dev)
    log(f"  {label}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters (fp32 master, "
        f"bf16 products){', remat' if cfg.remat else ''}; {batch} x {seq} tokens, one repeated "
        f"batch, {steps} AdamW steps (lr {lr}) through Trainer.fit")
    x = torch.as_tensor(data, device=dev)
    if before is not None:
        before(model, x)
    loss_fn(model, x).backward()  # warm-up (cuBLAS, allocator), not counted
    model.zero_grad(set_to_none=True)
    del x
    torch.cuda.synchronize()
    reset_counts()
    recs = []
    trainer.fit(itertools.repeat(data), steps, log_every=1, tokens_per_batch=tokens,
                log_fn=recs.append)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in recs]
    step_ms = [1e3 / r["steps_per_s"] for r in recs]
    ms = statistics.median(step_ms)
    log(f"  launches during the training steps: {counts}")
    log(f"  loss per step {[round(v, 4) for v in losses]}; ms/step (host clock to the loss) "
        f"{[round(v, 1) for v in step_ms]}, median {ms:.1f} = {tokens / ms * 1e3:.0f} tokens/s; "
        f"peak {peak:.2f} GB [{card}]")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{label}: the training loss is not finite")
    out = {"ms_per_step": step_ms, "median_ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "losses": losses, "peak_gb": peak, "parameters_b": n_params / 1e9,
           "layers": cfg.num_layers}
    del trainer, model
    torch.cuda.empty_cache()
    return counts, out


def btlm_train_phase(dev, card):
    """Phase 12 (c): BTLM-3B-8K at full width and depth trained on one
    repeated 8192-token sequence through training/trainer.py (fp32 master
    weights, remat, AdamW; the counted path)."""
    cfg = dataclasses.replace(btlm_3b_8k_config(32), remat=True)
    counts, out = trainer_run(dev, card, cfg, "BTLM-3B-8K", 1, BTLM_TRAIN_TOKENS,
                              BTLM_TRAIN_STEPS, BTLM_TRAIN_LR, (52, 53))
    losses = out["losses"]
    check(losses[-1] < losses[0], "BTLM training loss does not fall on a repeated batch")
    # remat runs each block's forward again in the backward: two B1 launches
    # a layer a step, one B7.
    n = cfg.num_layers * BTLM_TRAIN_STEPS
    check(counts["flash_bwd_alibi"] == n and counts["flash_fwd_alibi"] == 2 * n
          and counts["flash_fwd"] == 0 and counts["flash_bwd_dq"] == 0,
          f"BTLM training: expected {cfg.num_layers} ALiBi launches of B7 and "
          f"{2 * cfg.num_layers} of B1 a step")
    return counts, out


def btlm_phase(dev, card):
    """Phase 12: B1 and B7 at head dims 80 and 96, then BTLM-3B-8K served
    and trained at full width and depth."""
    log("  (a) B1 and B7 at head dims 80 (BTLM) and 96 (GPT-NeoX-20B) against their plain "
        "versions")
    kres = btlm_kernel_phase(dev)
    counts, stats = {}, {}
    log("  (b) BTLM-3B-8K serving")
    stats["small_btlm"] = small_btlm_check(dev)
    counts["btlm_serve"], stats["btlm_3b_8k_serve"] = btlm_serve_phase(dev, card)
    log("  (c) BTLM-3B-8K training")
    counts["btlm_train"], stats["btlm_3b_8k_train"] = btlm_train_phase(dev, card)
    return counts, kres, stats


# ---------------------------------------------------------------- phase 13

# Packed documents through the varlen functions (B1's and B7's segment
# channel). Llama-3-8B's attention (32 q heads, 8 KV heads of 128) over
# tokens of causal documents of seeded lengths; BTLM-3B-8K's (32 heads of
# 80, scale 1/d) likewise; each: tokens, heads, KV heads, head dim, the
# lengths' range, the seed. The last document is cut to fill the tokens.
LLAMA_PACK = (16384, 32, 8, 128, (128, 4096), 1616)
BTLM_PACK = (8192, 32, 32, 80, (256, 4096), 8080)
# The packed documents against each document alone (rel-L2, out and
# gradients); the segment walk's time over causal B1's over all tokens as
# one sequence (the visible work is ~0.17 of it at LLAMA_PACK).
PACKED_DOC_TOL = 1e-2
SEG_TIME_LIMIT = 0.6
VARLEN_CHUNK = 1024


def bert_padded_mask(dev):
    """Phase 10's BERT-large batch: its lengths (the generator's draws after
    the token ids, as bert_phase makes them), the [B, S] int32 mask, the
    valid total, and the generator to draw on from."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)
    torch.randint(0, 30522, (BERT_BATCH, BERT_SEQ), generator=g, device=dev)  # the ids
    lens = torch.randint(BERT_MIN_LEN, BERT_SEQ + 1, (BERT_BATCH,), generator=g, device=dev)
    mask = (torch.arange(BERT_SEQ, device=dev)[None] < lens[:, None]).to(torch.int32)
    return lens, mask, int(lens.sum()), g


def doc_lengths(total, lo, hi, seed):
    """Document lengths uniform in [lo, hi] from ``seed``, the last cut so
    that they sum to ``total``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = []
    while sum(out) < total:
        out.append(int(torch.randint(lo, hi + 1, (1,), generator=g)))
    out[-1] -= sum(out) - total
    return out


def packed_docs(dev, pack, grad=True):
    """Packed q [T, H, D], k, v [T, Hk, D], dO (bf16, from the seed), the
    document lengths and cu_seqlens of a ``LLAMA_PACK``-like entry."""
    import torch

    total, h, hk, d, (lo, hi), seed = pack
    lengths = doc_lengths(total, lo, hi, seed)
    cu = torch.tensor([0, *itertools.accumulate(lengths)], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
        return x.requires_grad_() if grad else x

    return rnd(total, h, d), rnd(total, hk, d), rnd(total, hk, d), rnd(total, h, d).detach(), \
        lengths, cu


def heads_first(*xs):
    """[T, H, D] -> [1, H, T, D], contiguous, detached."""
    return [x.detach().transpose(0, 1)[None].contiguous() for x in xs]


def docs_alone_check(label, q, k, v, dout, lengths, cu, scale):
    """flash_attn_varlen_func over the packed causal documents (forward and
    autograd backward) against each document alone through causal B1 / B7
    (``flash_attention``), concatenated: rel-L2 of out, dq, dk, dv within
    PACKED_DOC_TOL. Returns the rel-L2s."""
    import torch
    from liteattention_torch import flash_attn_varlen_func
    from liteattention_torch.ops.flash_fwd import flash_attention

    out = flash_attn_varlen_func(q, k, v, cu, cu, softmax_scale=scale, causal=True)
    got = [out.detach(), *torch.autograd.grad(out, (q, k, v), dout)]
    want = [[], [], [], []]
    for a, n in zip(cu[:-1].tolist(), lengths):
        parts = [x.detach()[a : a + n].transpose(0, 1)[None].contiguous().requires_grad_()
                 for x in (q, k, v)]
        o = flash_attention(*parts, scale=scale, causal=True)
        grads = torch.autograd.grad(o, parts, dout[a : a + n].transpose(0, 1)[None])
        for i, x in enumerate((o, *grads)):
            want[i].append(x.detach()[0].transpose(0, 1))
    rels = {n: rel_l2(g_, torch.cat(w)) for n, g_, w in zip(("out", "dq", "dk", "dv"), got, want)}
    log(f"  {label}: the packed documents vs each alone (causal B1 / B7), rel-L2 "
        + ", ".join(f"{n} {r:.2e}" for n, r in rels.items()) + f" (limit {PACKED_DOC_TOL})")
    check(max(rels.values()) < PACKED_DOC_TOL, f"{label}: the packed documents differ from each "
          "document alone")
    return rels


def varlen_kernel_phase(dev):
    """Phase 13 (a): B1's and B7's segment channel against their plain
    versions at three shapes (each timed beside its bound, the plain
    version and SDPA with the block-diagonal mask), the routes it serves
    against the channel-free and bound kernels, dead rows, and the packed
    forms. Returns the kernels line's flash_fwd_segments and
    flash_bwd_segments entries and the phase's stats."""
    import torch
    from liteattention_torch import (
        flash_attn_varlen_func,
        flash_attn_varlen_kvpacked_func,
        flash_attn_varlen_qkvpacked_func,
    )
    from liteattention_torch.flash_attn_interface import varlen_segment_ids
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_masked
    from liteattention_torch.utils.padding import pad_input, unpad_input

    fwd, bwd, stats = {}, {}, {}
    # 1. BERT-large's padded batch (phase 10's lengths), unpadded: 16 heads
    # of 64, non-causal; unpad -> varlen -> pad against B1's and B7's bound
    # channel over the padded batch (phase 10's route).
    lens, mask, total, g = bert_padded_mask(dev)
    h, d = 16, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = (rnd(BERT_BATCH, BERT_SEQ, h, d).requires_grad_() for _ in range(3))
    dout = rnd(BERT_BATCH, BERT_SEQ, h, d) * mask[..., None, None]
    packed = [unpad_input(x, mask, max_tokens=total) for x in (q, k, v)]
    _, idx, cu, _ = packed[0]
    out = pad_input(flash_attn_varlen_func(packed[0][0], packed[1][0], packed[2][0], cu, cu),
                    idx, BERT_BATCH, BERT_SEQ)
    got = [out.detach(), *torch.autograd.grad(out, (q, k, v), dout)]
    ref = flash_attention_masked(*(x.transpose(1, 2) for x in (q, k, v)), kv_bound=lens)
    ref = ref.transpose(1, 2)
    want = [ref.detach(), *torch.autograd.grad(ref, (q, k, v), dout)]
    valid = mask.bool()
    err = ((got[0][valid].float() - want[0][valid].float()).abs()
           / want[0][valid].float().abs().clamp_min(1.0)).max().item()
    rels = {n: rel_l2(a, b_) for n, a, b_ in zip(("dq", "dk", "dv"), got[1:], want[1:])}
    log(f"  BERT-large batch ({BERT_BATCH} sequences, {total} valid tokens) unpadded through "
        f"flash_attn_varlen_func vs B1 / B7's bound channel over the padded batch: valid rows "
        f"max err {err:.3e} of max(1, |ref|) (limit {OUT_TOL}), gradient rel-L2 "
        + ", ".join(f"{n} {r:.2e}" for n, r in rels.items()) + f" (limit {BWD_TOL})")
    check(err < OUT_TOL and max(rels.values()) < BWD_TOL,
          "the varlen BERT batch differs from the bound-channel route")
    stats["bert_vs_bound"] = {"out_err": err, **rels, "valid_tokens": total}
    seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
    kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None])
    qh, kh, vh, dh = heads_first(packed[0][0], packed[1][0], packed[2][0],
                                 unpad_input(dout, mask, max_tokens=total)[0])
    label = f"segments 1x{h}x{total}x{d}, BERT-large's {BERT_BATCH} sequences"
    fwd["bert_large_unpadded"] = check_channels(label, qh, kh, vh, kw, time_it=True)
    bwd["bert_large_unpadded"] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    del q, k, v, dout, packed, out, got, ref, want, qh, kh, vh, dh
    torch.cuda.empty_cache()

    # 2. and 3. Llama-3-8B's and BTLM-3B-8K's attention over packed causal
    # documents: against each document alone, then the kernels against
    # their plain versions.
    for key, pack, scale in (("llama3_8b_docs", LLAMA_PACK, None),
                             ("btlm_3b_8k_docs", BTLM_PACK, 1.0 / BTLM_PACK[3])):
        total, h, hk, d = pack[:4]
        q, k, v, dout, lengths, cu = packed_docs(dev, pack)
        name = key.split("_docs")[0]
        stats[key] = {"documents": len(lengths), "lengths": lengths,
                      **docs_alone_check(f"{name} {len(lengths)} documents, {total} tokens",
                                         q, k, v, dout, lengths, cu, scale)}
        seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
        kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None], causal=True, scale=scale)
        qh, kh, vh, dh = heads_first(q, k, v, dout)
        label = f"segments causal 1x{h}/{hk}x{total}x{d}, {name}'s {len(lengths)} documents"
        fwd[key] = check_channels(label, qh, kh, vh, kw, time_it=True)
        bwd[key] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
        if pack is LLAMA_PACK:
            # Causal B1 over all the tokens as one sequence: the segment walk
            # must take much less (a full walk would take as long).
            full, _, timer = device_ms(lambda: flash_attention(qh, kh, vh, causal=True))
            ratio = fwd[key]["ms"] / full
            fwd[key].update(one_sequence_causal_ms=full, one_sequence_timer=timer,
                            over_one_sequence=ratio)
            log(f"  B1 {label}: {fwd[key]['ms']:.4f} ms against causal B1 over all {total} "
                f"tokens as one sequence {full:.4f} ms ({timer}): {ratio:.3f}x (limit "
                f"{SEG_TIME_LIMIT}x; the visible pairs are "
                f"{fwd[key]['visible_pairs'] / (h * total * (total + 1) / 2):.3f} of its)")
            check(ratio < SEG_TIME_LIMIT, "the segment walk takes as long as a full causal walk")
            # 4. Dead rows and keys (seqused_q / seqused_k) and attention_chunk.
            gl = torch.Generator().manual_seed(4)
            used_q = torch.tensor([n - int(torch.randint(0, n // 4 + 1, (1,), generator=gl))
                                   for n in lengths], dtype=torch.int32, device=dev)
            used_k = torch.tensor([n - int(torch.randint(0, n // 4 + 1, (1,), generator=gl))
                                   for n in lengths], dtype=torch.int32, device=dev)
            seg_q, seg_k = varlen_segment_ids(cu, cu, total, total, used_q, used_k, VARLEN_CHUNK)
            kw4 = dict(q_segments=seg_q[None], kv_segments=seg_k[None], causal=True)
            r = check_channels(f"segments causal 1x{h}/{hk}x{total}x{d}, seqused_q / seqused_k "
                               f"and attention_chunk {VARLEN_CHUNK}", qh, kh, vh, kw4)
            with torch.no_grad():
                vo, vl = flash_attn_varlen_func(q, k, v, cu, cu, seqused_q=used_q,
                                                seqused_k=used_k, causal=True,
                                                attention_chunk=VARLEN_CHUNK,
                                                return_softmax_lse=True)
                mo, ml = flash_attention_masked(qh, kh, vh, return_lse=True, **kw4)
            dead = seg_q < 0
            check(torch.equal(vo, mo[0].transpose(0, 1)) and torch.equal(vl, ml[0]),
                  "flash_attn_varlen_func with seqused and attention_chunk differs from its ids")
            check(bool(dead.any()) and bool(torch.isneginf(vl[:, dead]).all())
                  and vo[dead].abs().max().item() == 0.0,
                  "dead rows (seqused_q) do not give out 0 and lse -inf")
            log(f"  seqused / attention_chunk: {int(dead.sum())} dead rows give out 0 and lse "
                f"-inf; {int(torch.isneginf(vl).any(0).sum())} rows without a key in all")
            fwd[key + "_seqused_chunk"] = {"err": r["err"], "dead_rows": int(dead.sum())}
            # (b) The packed forms give the unpacked call's bits.
            with torch.no_grad():
                kv = torch.stack([k, v], 1)
                same_kv = torch.equal(flash_attn_varlen_kvpacked_func(q, kv, cu, cu, causal=True),
                                      flash_attn_varlen_func(q, k, v, cu, cu, causal=True))
                del kv
                ke, ve = k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)
                qkv = torch.stack([q, ke, ve], 1)
                same_qkv = torch.equal(flash_attn_varlen_qkvpacked_func(qkv, cu, causal=True),
                                       flash_attn_varlen_func(q, ke, ve, cu, cu, causal=True))
                del qkv, ke, ve
            log(f"  (b) flash_attn_varlen_kvpacked_func and _qkvpacked_func equal the unpacked "
                f"call bit for bit: {same_kv} / {same_qkv}")
            check(same_kv and same_qkv, "a packed varlen form differs from the unpacked call")
        del q, k, v, dout, qh, kh, vh, dh
        torch.cuda.empty_cache()
    return ({"flash_fwd_segments": _channel_entry(fwd, "llama3_8b_docs"),
             "flash_bwd_segments": _channel_entry(bwd, "llama3_8b_docs")}, stats)


def varlen_counted_run(dev):
    """Phase 13's counted run, the main path: the three shapes' varlen
    calls, forward and backward through autograd (BERT's through
    unpad_input and pad_input). Exactly one segment launch of B1 and of B7
    each, and no other B1 / B7 launch."""
    import torch
    from liteattention_torch import flash_attn_varlen_func
    from liteattention_torch.utils.padding import pad_input, unpad_input

    _, mask, total, g = bert_padded_mask(dev)
    x = torch.randn(BERT_BATCH, BERT_SEQ, 16, 64, generator=g, device=dev).to(torch.bfloat16)
    x.requires_grad_()
    inputs = [("bert", x, None)]
    for name, pack, scale in (("llama", LLAMA_PACK, None),
                              ("btlm", BTLM_PACK, 1.0 / BTLM_PACK[3])):
        inputs.append((name, packed_docs(dev, pack), scale))
    torch.cuda.synchronize()
    reset_counts()
    for name, data, scale in inputs:
        if name == "bert":
            p, idx, cu, _ = unpad_input(data, mask, max_tokens=total)
            out = pad_input(flash_attn_varlen_func(p, p, p, cu, cu), idx, BERT_BATCH, BERT_SEQ)
            out.float().square().sum().backward()
        else:
            q, k, v, dout, _, cu = data
            flash_attn_varlen_func(q, k, v, cu, cu, softmax_scale=scale, causal=True).backward(dout)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  counted run (BERT unpad -> varlen -> pad, Llama and BTLM documents; forward and "
        f"backward): {counts}")
    others = sum(n for name, n in counts.items()
                 if name.startswith(("flash_fwd", "flash_bwd")) and not name.endswith("segments"))
    check(counts["flash_fwd_segments"] == 3 and counts["flash_bwd_segments"] == 3 and others == 0,
          "phase 13's counted run: expected 3 segment launches of B1 and of B7 and no other")
    del inputs
    torch.cuda.empty_cache()
    return counts


def varlen_phase(dev):
    """Phase 13: B1's and B7's segment channel and the varlen functions at
    BERT-large's, Llama-3-8B's and BTLM-3B-8K's attention."""
    log("  (a) B1 and B7 with segment ids against their plain versions and the routes they "
        "serve")
    kres, stats = varlen_kernel_phase(dev)
    counts = varlen_counted_run(dev)
    return counts, kres, stats


# ---------------------------------------------------------------- phase 14

# GPT-J-6B (EleutherAI/gpt-j-6b config.json: n_embd 4096, n_layer 28, n_head
# 16, so head dim 256; rotary_dim 64 interleaved, vocab 50 400, n_inner null
# = 4 x 4096, gelu_new, untied embeddings, a biased lm_head): gptj_config()
# as it stands. Serving: requests x prompt tokens, greedy tokens, the cache;
# training: the first layers of its 28 (fp32 parameters, gradients and AdamW
# state of all 28 would take ~97 GB), batch x tokens, AdamW steps, rate. The
# decode kernel's native pool (B9b; not on GPT-J's path): tokens a page.
GPTJ_BATCH, GPTJ_PROMPT, GPTJ_NEW, GPTJ_CONTEXT = 8, 1024, 32, 2048
GPTJ_TRAIN_LAYERS, GPTJ_TRAIN_BATCH, GPTJ_TRAIN_SEQ, GPTJ_TRAIN_STEPS = 8, 2, 2048, 3
GPTJ_TRAIN_LR = 1e-4
GPTJ_PAGE = 64
# The recompute check's planted faults at GPT-J (recompute_fault_readings):
# every step this many positions late; the prompt's last rows zeroed (one of
# the D 256 decode kernel's 64-key tiles). The smallest sizes that read at
# least 1.5x the limit on both caches (gptj_fault_sweep.py).
GPTJ_FAULT_LATE, GPTJ_FAULT_ROWS = 64, 64


def gptj_kernel_phase(dev):
    """Phase 14 (a): B1, B7 and the decode kernel at head dim 256 against
    their plain versions at GPT-J-6B's shapes, each timed beside its bound,
    its plain version and one library call: causal B1 and B7 at training's
    2 x 16 x 2048; B1 with the bound and bound_causal at the serving prefill
    (8 x 16 x 1024 over the 2048-slot cache); the decode kernel over that
    cache, B8 bf16 (ragged and full lengths) and int8, and B9b over native
    pools of 64-token pages. Returns {name: result}."""
    import torch
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
    )
    from liteattention_torch.ops.flash_decode import kernel_tile_keys, tile_keys
    from liteattention_torch.ops.kv_quant import quantize_kv_cache
    from liteattention_torch.ops.paged_attention import (
        paged_attention_folded,
        paged_attention_folded_plain,
    )

    g = torch.Generator(device=dev).manual_seed(6256)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    h, d = 16, 256
    # The plain decode splits as the kernel does only with the kernel's tile.
    check(kernel_tile_keys(d) == tile_keys(d),
          f"the decode kernel's key tile at head dim {d} is not the plain version's")
    res = {}
    b, s = GPTJ_TRAIN_BATCH, GPTJ_TRAIN_SEQ
    q, k, v, dout = (rnd(b, h, s, d) for _ in range(4))
    label = f"causal {b}x{h}x{s}x{d} (GPT-J training, head dim 256)"
    res["fwd_causal"] = check_flash(q, k, v, label, causal=True, time_it=True, blocks=True)
    res["bwd_causal"] = check_bwd(q, k, v, dout, label, True, time_it=True)
    del q, k, v, dout
    torch.cuda.empty_cache()
    # MHA's prefill into the cache: causal off, bound_causal on, Sk the
    # cache's 2048 slots, the bound the prompt's 1024.
    b, cap = GPTJ_BATCH, GPTJ_CONTEXT
    kc, vc = rnd(b, h, cap, d), rnd(b, h, cap, d)
    prompt = torch.full((b,), GPTJ_PROMPT, dtype=torch.int32, device=dev)
    res["fwd_bound"] = check_channels(
        f"bound_causal prefill {b}x{h}x{GPTJ_PROMPT}x{d} over a {cap}-slot cache (GPT-J)",
        rnd(b, h, GPTJ_PROMPT, d), kc, vc, dict(kv_bound=prompt, bound_causal=True),
        time_it=True)
    # The decode steps: one q row a head against the head-major cache as
    # MHA passes it ([B, S, H, D] views), at ragged lengths (the first
    # full) and at full lengths.
    q = rnd(b, h, 1, d)
    kcs, vcs = kc.transpose(1, 2), vc.transpose(1, 2)
    lens = torch.randint(cap // 4, cap + 1, (b,), generator=g, device=dev).int()
    lens[0] = cap
    full = torch.full((b,), cap, dtype=torch.int32, device=dev)
    keys, out_bytes = int(lens.sum()), 2 * nbytes(q) + 4 * b * h

    def need(elsize, n_keys=keys, extra=0):
        """Bytes (K and V rows needed, q, out, lse) and FLOPs (QK and PV)."""
        return 2 * n_keys * h * d * elsize + out_bytes + extra, 4 * d * h * n_keys

    shape = f"{b}x{h} rows of {d}, cache {cap}, lengths {lens.min().item()}-{cap}"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r = res["decode"] = check_decode(
        f"B8 bf16 {shape}", flash_attention_decode, flash_attention_decode_plain,
        (q, kcs, vcs), dict(kv_bound=lens), need(2), time_it=True)
    pad = (torch.arange(cap, device=dev) < lens[:, None])[:, None, None]  # [B, 1, 1, S]
    backend, r["library_ms"], r["timer"]["library_ms"] = sdpa_backend_ms(
        "B8 D 256 ragged", lambda: sdpa(q, kc, vc, attn_mask=pad))
    r["library"] = f"torch SDPA, boolean key-padding mask ({backend} backend)"
    r["ms_full_lengths"], _, r["timer"]["ms_full_lengths"] = device_ms(
        lambda: flash_attention_decode(q, kcs, vcs, kv_bound=full))
    r["bound_ms_full_lengths"] = bound(need(2, b * cap)[1], need(2, b * cap)[0])[0]
    r["library_ms_full_lengths"], _, r["timer"]["library_ms_full_lengths"] = device_ms(
        lambda: sdpa(q, kc, vc))
    log(f"  decode B8 D 256 ragged: SDPA (key-padding mask, {backend}) {fmt_ms(r['library_ms'])}; "
        f"full lengths: device {r['ms_full_lengths']:.4f} ms, bound "
        f"{r['bound_ms_full_lengths']:.4f} ms; SDPA {r['library_ms_full_lengths']:.4f} ms")
    c8 = quantize_kv_cache(kcs, vcs)
    r["int8"] = check_decode(
        f"B8 int8 {shape}", flash_attention_decode, flash_attention_decode_plain,
        (q, c8.k, c8.v), dict(kv_bound=lens, k_scale=c8.k_scale, v_scale=c8.v_scale),
        need(1, extra=2 * nbytes(c8.k_scale)), time_it=True)
    r["int8"]["library_ms"] = None
    del c8
    n_pages = b * cap // GPTJ_PAGE
    kp, vp = (x.contiguous().reshape(n_pages, GPTJ_PAGE, h, d) for x in (kcs, vcs))
    table = torch.randperm(n_pages, generator=g, device=dev).reshape(b, -1).int()
    res["paged_folded"] = check_decode(
        f"B9b bf16 {shape}, native pool, pages of {GPTJ_PAGE}", paged_attention_folded,
        paged_attention_folded_plain, (q[:, :, 0], kp, vp, lens, table),
        dict(return_lse=True), need(2, extra=nbytes(table)), time_it=True)
    res["paged_folded"]["library_ms"] = None
    del kc, vc, kcs, vcs, kp, vp
    torch.cuda.empty_cache()
    return res


def small_gptj_check(dev):
    """A small GPT-J-shaped model (dim 512, 2 heads of 256, 2 layers, vocab
    1000, interleaved rotary over 64) on the card (bf16) against the CPU
    (fp32, the plain versions): the forward's logits, one training step's
    loss and gradients (causal B1 and B7 at D 256) and greedy decoding with
    a cache, teacher-forced on the CPU's tokens (B1's bound at the prefill,
    the decode kernel at every step)."""
    import torch
    from liteattention_torch.models.configs import gptj_config
    from liteattention_torch.models.gpt import GPTLMHeadModel, gpt_loss_fn
    from liteattention_torch.ops.flash_bwd import flash_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_decode
    from liteattention_torch.utils.generation import greedy_decode

    cfg = gptj_config(dim=512, num_layers=2, num_heads=2, vocab=1000, rotary_dim=64)
    label = "small GPT-J (dim 512, 2 layers, 2 heads of 256)"
    cpu = GPTLMHeadModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(61))
    gpu = GPTLMHeadModel(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 1000, (2, 300), generator=torch.Generator().manual_seed(62))
    with torch.no_grad():
        e_fwd = rel_l2(gpu(x.to(dev)).float().cpu(), cpu(x))
    log(f"  {label}, forward over 2 x 300, bf16 card vs fp32 CPU: logits rel-L2 {e_fwd:.2e}")
    check(e_fwd < SMALL_FWD_TOL, f"{label}: forward disagrees")
    worst = check_train_step(dev, f"{label} training step (2 x 300)", cpu, gpu,
                             lambda m, where: gpt_loss_fn(m, x.to(where), x.to(where)),
                             ((flash_attention, "launches"), (flash_bwd, "launches")),
                             [cfg.num_layers, cfg.num_layers])
    prompt, new = 100, 12
    ids = torch.randint(0, 1000, (2, prompt), generator=torch.Generator().manual_seed(63))
    with torch.no_grad():
        rec = StepTimer(cpu)
        toks = greedy_decode(rec, ids, new, 128)
    ref = rec.logits()
    n0, d0 = flash_attention.bound_launches, flash_attention_decode.launches
    got, _ = teacher_forced_logits(gpu, toks.to(dev), prompt, 128)
    torch.cuda.synchronize()
    n, nd = flash_attention.bound_launches - n0, flash_attention_decode.launches - d0
    check(n == cfg.num_layers and nd == cfg.num_layers * (new - 1),
          f"{label}: {n} bound B1 launches, {nd} decode-kernel launches")
    err = rel_l2(got.float().cpu(), ref)
    same = (got.argmax(-1).cpu() == ref.argmax(-1)).float().mean().item()
    log(f"  {label}, {new} tokens teacher-forced, bf16 card vs fp32 CPU: logits rel-L2 "
        f"{err:.2e}, argmax agreement {same:.3f}, {n} bound B1 and {nd} decode launches")
    check(err < SMALL_DECODE_TOL, f"{label}: decode disagrees")
    return {"forward_logits_rel_l2": e_fwd, "train_step_worst_rel": worst,
            "decode_logits_rel_l2": err}


def gptj_serve_phase(dev, card):
    """Phase 14 (c): GPT-J-6B serving at full width and depth (the counted
    path: greedy decoding of GPTJ_BATCH requests into a GPTJ_CONTEXT cache,
    bf16 and int8), then its checks and a profile of its decode steps."""
    import torch
    from liteattention_torch.models.configs import gptj_config
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import greedy_decode

    cfg = gptj_config()
    log(f"  GPT-J-6B: dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} heads x "
        f"{cfg.dim // cfg.num_heads}, interleaved rotary over {cfg.rotary_emb_dim}, tied-norm "
        f"parallel block, ffn {4 * cfg.dim}, vocab {cfg.vocab_size}, biased lm_head; fp32 "
        "master weights, bf16 compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(64))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(65)
    ids = torch.randint(0, cfg.vocab_size, (GPTJ_BATCH, GPTJ_PROMPT), generator=g, device=dev)
    log(f"  {n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.1f} GB fp32); {GPTJ_BATCH} "
        f"requests x {GPTJ_PROMPT} prompt tokens, {GPTJ_NEW} new tokens each, cache capacity "
        f"{GPTJ_CONTEXT}")
    greedy_decode(model, ids[:1, :16], 2, 32)  # warm-up, not counted

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timer = StepTimer(model)
    toks = greedy_decode(timer, ids, GPTJ_NEW, GPTJ_CONTEXT)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    timer8 = StepTimer(model)
    toks8 = greedy_decode(timer8, ids, GPTJ_NEW, GPTJ_CONTEXT, quantize_cache=True)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the GPT-J serving run (bf16 and int8 caches): {counts}")
    n_decode = len(timer.calls) - 1
    want_b1, want_b8 = 2 * cfg.num_layers, 2 * cfg.num_layers * n_decode
    check(counts["flash_fwd_bound"] == want_b1 and counts["flash_decode"] == want_b8,
          f"GPT-J serving: expected {want_b1} bound B1 launches (the prefills) and {want_b8} "
          "decode-kernel launches (one a layer a step)")
    prefill_ms, prefill8_ms = timer.calls[0][1], timer8.calls[0][1]
    step_ms = [ms for _, ms in timer.calls[1:]]
    step8_ms = [ms for _, ms in timer8.calls[1:]]
    dec_ms, dec8_ms = statistics.median(step_ms), statistics.median(step8_ms)
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": dec_ms,
           "prefill_ms_int8": prefill8_ms, "decode_ms_per_step_int8": dec8_ms,
           "decode_tokens_per_s": GPTJ_BATCH * 1e3 / dec_ms,
           "decode_tokens_per_s_int8": GPTJ_BATCH * 1e3 / dec8_ms,
           "end_to_end_tokens_per_s": GPTJ_BATCH * GPTJ_NEW * 1e3 / wall,
           "peak_gb": peak_gb, "decode_steps": n_decode, "parameters_b": n_params / 1e9,
           "layers": cfg.num_layers}
    log(f"  bf16 cache: prefill {prefill_ms:.1f} ms ({GPTJ_BATCH * GPTJ_PROMPT / prefill_ms * 1e3:.0f} "
        f"prompt tokens/s), decode {dec_ms:.2f} ms/step (median of {n_decode}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) = {out['decode_tokens_per_s']:.0f} tokens/s; "
        f"end to end {wall:.0f} ms; int8 cache: prefill {prefill8_ms:.1f} ms, decode "
        f"{dec8_ms:.2f} ms/step; peak memory {peak_gb:.2f} GB [{card}]")

    # Checks (their launches are not counted): each run's incremental
    # decode against a full recompute without a cache over its tokens, and
    # two planted faults in each cache.
    with torch.inference_mode():
        fulls = [torch.cat([model(tk[i : i + 1, :-1])[:, GPTJ_PROMPT - 1 :].clone()
                            for i in range(GPTJ_BATCH)]) for tk in (toks, toks8)]
    for name, tm, tk, full in (("bf16", timer, toks, fulls[0]), ("int8", timer8, toks8, fulls[1])):
        step_logits = tm.logits()
        check(tk.shape == (GPTJ_BATCH, GPTJ_PROMPT + GPTJ_NEW)
              and torch.isfinite(step_logits).all(), f"GPT-J serving ({name}): bad greedy output")
        e_full = rel_l2(step_logits, full)
        agree = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
        log(f"  {name} cache: incremental decode vs full recompute without a cache: logits "
            f"rel-L2 {e_full:.3e}, argmax agreement {agree:.3f}")
        check(e_full < SERVE_RECOMPUTE_TOL,
              f"GPT-J incremental decode ({name} cache) disagrees with the recompute")
        sfx = "" if name == "bf16" else "_int8"
        out[f"recompute_rel_l2{sfx}"], out[f"recompute_argmax_agreement{sfx}"] = e_full, agree
    # At GPT-J's geometry (rotary over 64 of 256 dims, random weights) one
    # row zeroed or one position late reads under the limit (7.0e-3 and
    # 8.8e-3 on an H100 beside 6.0e-3 sound): the attention is near uniform
    # over the prompt. So the faults here are larger (GPTJ_FAULT_LATE,
    # GPTJ_FAULT_ROWS), planted in both caches, and held above the limit.
    for i, (tm, tk) in enumerate(((timer, toks), (timer8, toks8))):
        res = recompute_fault_readings(model, tk, fulls[i], tm.logits(), prompt=GPTJ_PROMPT,
                                       capacity=GPTJ_CONTEXT, late_by=GPTJ_FAULT_LATE,
                                       rows=GPTJ_FAULT_ROWS, quantize=i == 1)
        out.update({f"{k}{'_int8' if i else ''}": x for k, x in res.items()})
    del fulls
    _, inf = teacher_forced_logits(model, toks[:, : GPTJ_PROMPT + 8], GPTJ_PROMPT, GPTJ_CONTEXT)
    out["profile"] = prof = profile_decode_steps(model, inf, 5, card)
    if prof is not None:
        check(prof["decode_kernel_launches"] == 5 * cfg.num_layers,
              "GPT-J serving: the decode step should launch the decode kernel once a layer")
        # The device's busy time a step against the unprofiled step (the
        # profiler itself slows the host), and the decode kernel's share of it.
        out["device_share_of_step"] = prof["busy_ms_per_step"] / dec_ms
        out["decode_kernel_share_of_busy"] = (prof["attention (decode kernel)_ms_per_step"]
                                              / prof["busy_ms_per_step"])
        log(f"  device busy {prof['busy_ms_per_step']:.2f} ms of the {dec_ms:.2f} ms step "
            f"({out['device_share_of_step']:.1%}); the decode kernel "
            f"{out['decode_kernel_share_of_busy']:.1%} of the busy time")
    del model, inf, timer, timer8
    torch.cuda.empty_cache()
    return counts, out


def gptj_train_phase(dev, card):
    """Phase 14 (d): GPT-J-6B at full width, its first GPTJ_TRAIN_LAYERS
    layers, trained on one repeated batch through training/trainer.py (fp32
    master weights, remat, AdamW; the counted path)."""
    from liteattention_torch.models.configs import gptj_config

    cfg = dataclasses.replace(gptj_config(num_layers=GPTJ_TRAIN_LAYERS), remat=True)
    counts, out = trainer_run(dev, card, cfg, "GPT-J-6B width (of 28 layers)", GPTJ_TRAIN_BATCH,
                              GPTJ_TRAIN_SEQ, GPTJ_TRAIN_STEPS, GPTJ_TRAIN_LR, (66, 67))
    # remat runs each block's forward again in the backward: two causal B1
    # launches a layer a step, one B7.
    n = cfg.num_layers * GPTJ_TRAIN_STEPS
    check(counts["flash_bwd_dq"] == n and counts["flash_fwd"] == 2 * n,
          f"GPT-J training: expected {cfg.num_layers} B7 and {2 * cfg.num_layers} B1 launches "
          "a step")
    return counts, out


def gptj_phase(dev, card):
    """Phase 14: B1, B7 and the decode kernel at head dim 256, then
    GPT-J-6B served at full width and depth and trained at full width."""
    t0 = time.perf_counter()
    log("  (a) B1, B7 and the decode kernel at head dim 256 against their plain versions")
    kres = gptj_kernel_phase(dev)
    secs = {"a": time.perf_counter() - t0}
    log(f"  (b) a small GPT-J-shaped model, card against CPU ((a) took {secs['a']:.1f} s)")
    stats = {"small_gptj": small_gptj_check(dev), "part_seconds": secs}
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    counts = {}
    log(f"  (c) GPT-J-6B serving ((b) took {secs['b']:.1f} s)")
    counts["gptj_serve"], stats["gptj_6b_serve"] = gptj_serve_phase(dev, card)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (d) GPT-J-6B training, full width ((c) took {secs['c']:.1f} s)")
    counts["gptj_train"], stats["gptj_6b_train"] = gptj_train_phase(dev, card)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (d) took {secs['d']:.1f} s")
    # The attention kernels' share of each step, from their times at the
    # same shapes in (a) (B1 twice a layer a step under remat, B7 once).
    serve, train = stats["gptj_6b_serve"], stats["gptj_6b_train"]
    serve["prefill_b1_share_by_kernel_times"] = (serve["layers"] * kres["fwd_bound"]["ms"]
                                                 / serve["prefill_ms"])
    train["attention_share_by_kernel_times"] = train["layers"] * (
        2 * kres["fwd_causal"]["ms"] + kres["bwd_causal"]["flash_bwd_dq"]["ms"]
    ) / train["median_ms_per_step"]
    log(f"  attention kernels' share by their times in (a): prefill "
        f"{serve['prefill_b1_share_by_kernel_times']:.1%}, training step "
        f"{train['attention_share_by_kernel_times']:.1%}")
    return counts, kres, stats


# ---------------------------------------------------------------- phase 15

# GPT-2 XL (openai-community/gpt2-xl config.json: n_embd 1600, n_layer 48,
# n_head 25, n_positions 1024, attn_pdrop = resid_pdrop = 0.1) through the
# JAX package's own gpt2_config(dim=1600, num_layers=48, num_heads=25).
GPT2_XL = dict(dim=1600, num_layers=48, num_heads=25)
GPT2_XL_DROPOUT = 0.1
# lr 5e-5: at 1e-4 (no warmup) the dropout run's fifth loss jumped back to
# 11.04 from 10.38 (first 11.33; H100 80GB HBM3, 700 W).
GPT2_XL_BATCH, GPT2_XL_SEQ, GPT2_XL_STEPS, GPT2_XL_LR = 8, 1024, 5, 5e-5
# B1 / B7 with dropout at Llama-3-8B's attention: b, h, hk, s, d (causal).
DROPOUT_LLAMA_SHAPE = (4, 32, 8, 2048, 128)
DROPOUT_SEED = -24680
# The integer-issue bound of the dropout hash: key_mask.cuh's ~11 32-bit
# integer instructions a score, at an H100 SXM's 132 SMs x 64 integer
# lanes a clock, at the card's largest SM clock (nvidia-smi).
DROPOUT_HASH_OPS, H100_SMS, INT_LANES_PER_SM = 11, 132, 64


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def int_bound_ms(scores: int) -> float:
    """Least time (ms) of the keep hash over ``scores`` scores on the
    card's integer lanes."""
    return DROPOUT_HASH_OPS * scores / (H100_SMS * INT_LANES_PER_SM * max_sm_clock_hz()) * 1e3


def dropout_readback(dev):
    """Phase 15 (a): B1's dropout read back through the kernel, bit for bit.
    q = k = 0, so P is uniform over the keys B1 sees; kv_low = c0 and
    kv_bound = c0 + 64 leave the 64 keys [c0, c0 + 64) visible and V is
    one-hot over them, so ``out[i, j] = keep[i, c0 + j] (1 / (1 - p)) /
    64`` with ``keep`` from ``dropout_keep_mask`` at (seed, b * H + h, row
    i, key c0 + j): every (b, h), rows 0-4159, c0 in {0, 128, 960}, p 0.1
    and 0.5, head dims 64 and 128. The dropped share over each p's scores
    must lie within 4 sigma of p. Returns {p: dropped share}."""
    import torch
    from liteattention_torch.ops.flash_fwd import dropout_keep_mask, flash_attention_masked

    b, h, sq, sk = 2, 3, 4160, 1024
    bounds = {c0: (torch.full((b,), c0, dtype=torch.int32, device=dev),
                   torch.full((b,), c0 + 64, dtype=torch.int32, device=dev))
              for c0 in (0, 128, 960)}
    kept = {0.1: [0, 0], 0.5: [0, 0]}
    for d in (64, 128):
        q = torch.zeros(b, h, sq, d, dtype=torch.bfloat16, device=dev)
        k = torch.zeros(b, h, sk, d, dtype=torch.bfloat16, device=dev)
        for c0, (low, bound) in bounds.items():
            v = torch.zeros_like(k)
            v[:, :, c0 : c0 + 64, :64] = torch.eye(64, dtype=torch.bfloat16, device=dev)
            for p in kept:
                out = flash_attention_masked(q, k, v, kv_low=low, kv_bound=bound, dropout_p=p,
                                             dropout_seed=DROPOUT_SEED)
                check(not out[..., 64:].any(), f"dropout read-back d {d}: columns past 64 not 0")
                for bi in range(b):
                    for hi in range(h):
                        keep = dropout_keep_mask(DROPOUT_SEED, bi * h + hi, 0, c0, (sq, 64), p,
                                                 device=dev)
                        want = (keep.float() * (1.0 / (1.0 - p)) / 64).bfloat16()
                        check(torch.equal(out[bi, hi, :, :64], want),
                              f"dropout read-back d {d} c0 {c0} p {p} (b {bi}, h {hi}): B1's "
                              "keep mask is not dropout_keep_mask's")
                        kept[p][0] += int(keep.sum())
                        kept[p][1] += keep.numel()
    shares = {}
    for p, (n_kept, n) in kept.items():
        shares[p] = 1.0 - n_kept / n
        sigma = (p * (1.0 - p) / n) ** 0.5
        log(f"  read-back: {n} scores at p {p} (D 64 and 128, c0 0 / 128 / 960, rows 0-{sq - 1}, "
            f"{b * h} (b, h)) equal to dropout_keep_mask bit for bit; dropped share "
            f"{shares[p]:.5f} ({(shares[p] - p) / sigma:+.2f} sigma)")
        check(abs(shares[p] - p) < 4 * sigma, f"dropped share {shares[p]} is not p {p} +- 4 sigma")
    return {str(p): v for p, v in shares.items()}


def check_dropout_kernels(dev, label, q, k, v, dout):
    """Phase 15 (b) at one shape: causal B1 and B7 with dropout
    (GPT2_XL_DROPOUT, seed on the card) against their plain versions: out
    (within OUT_TOL of max(1, |plain|), every 128-row block within
    B1_BLOCK_TOL), lse (LSE_TOL, and equal to B1's without dropout), dQ /
    dK / dV by ``verify_bwd`` (dK, dV bit-stable); timed beside their
    operation bound, their integer-issue bound, the plain versions, the
    same kernels without dropout and SDPA's flash forward / aten's flash
    backward with dropout (Philox: another mask, the same work; K and V
    expanded to the q heads for GQA). Returns the forward's and the
    backward's results."""
    import torch
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd, flash_bwd_plain
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device=dev)
    kw = dict(causal=True, dropout_p=GPT2_XL_DROPOUT, dropout_seed=seed)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ro, rl = flash_attention_plain(q, k, v, **kw)
    diff = (out.float() - ro.float()).abs()
    err_o = diff.max().item()
    err_chk = (diff / ro.float().abs().clamp_min(1.0)).max().item()
    err_l = (lse - rl).abs().max().item()
    _, lse0 = flash_attention(q, k, v, causal=True, return_lse=True)
    fwd = {"err": err_o}
    fwd["rel_l2"], fwd["worst_block_rel_l2"] = block_rel_l2(out, ro)
    del ro, rl
    log(f"  B1 dropout {label}: max|out| err {err_o:.3e}, max|lse| err {err_l:.3e}, rel-L2 "
        f"{fwd['rel_l2']:.3e}, worst (b, h, 128-row block) {fwd['worst_block_rel_l2']:.3e}; lse "
        f"equal to B1's without dropout: {torch.equal(lse, lse0)}")
    check(err_chk < OUT_TOL and err_l < LSE_TOL, f"B1 dropout {label} disagrees")
    check(fwd["worst_block_rel_l2"] < B1_BLOCK_TOL, f"B1 dropout {label}: a 128-row block disagrees")
    check(torch.equal(lse, lse0), f"B1 dropout {label}: lse is not dropout-free")
    args, ch, (dq, dk, dv), errs, rels = verify_bwd(f"dropout {label}", q, k, v, dout, kw)
    bwd = {"err": max(errs.values()), "rel_l2": max(t for t, _ in rels.values()),
           "worst_block_rel_l2": max(w for _, w in rels.values()),
           "errs": errs, "rel_l2_by_grad": {n: t for n, (t, _) in rels.items()}}
    # Timing.
    pairs = attn_pairs(sq, sk, True) * b * h
    call = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
    fwd["ms"] = cuda_ms(call, reps=20)
    fwd["device_ms"], _, fwd["timer"] = device_ms(call)
    fwd["ms_without_dropout"] = cuda_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
    fwd["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), reps=1)
    fwd["bound_ms"], fwd["bound_by"] = bound(4 * d * pairs, nbytes(q, k, v, out, lse))
    fwd["int_bound_ms"] = int_bound_ms(pairs)
    group = h // hk
    qe, ke, ve = q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd["library_ms"] = cuda_ms(
            lambda: sdpa(qe, ke, ve, is_causal=True, dropout_p=GPT2_XL_DROPOUT), reps=20)
    fwd["library"] = "SDPA flash, dropout_p 0.1 (Philox)" + (", K/V expanded" if group > 1 else "")
    bcall = lambda: flash_attention_bwd(*args, **ch)  # noqa: E731
    bwd["ms"] = cuda_ms(bcall, reps=20)
    bwd["device_ms"], bwd["main_kernel_ms"], bwd["timer"] = device_ms(
        bcall, names=("flash_bwd_dropout_kernel",))
    bwd["ms_without_dropout"] = cuda_ms(lambda: flash_attention_bwd(*args), reps=20)
    bwd["plain_ms"] = cuda_ms(lambda: flash_bwd_plain(*args, **ch), reps=1)
    bwd["bound_ms"], bwd["bound_by"] = bound(10 * d * pairs,
                                             nbytes(q, k, v, out, dout, lse, dq, dk, dv))
    bwd["int_bound_ms"] = int_bound_ms(pairs)
    lib_fn = sdpa_bwd(qe, ke, ve, dout, True, GPT2_XL_DROPOUT)
    bwd["library_ms"] = cuda_ms(lib_fn, reps=20)
    bwd["library"] = "aten flash backward, dropout_p 0.1 (Philox)" + (
        ", K/V expanded (dK/dV of the expanded heads)" if group > 1 else "")
    for r, name in ((fwd, "B1"), (bwd, "B7")):
        r["shape"] = f"{b}x{h}/{hk}x{sq}x{d} causal, p {GPT2_XL_DROPOUT}"
        log(f"  {name} dropout {label}: {r['ms']:.4f} ms (events), {fmt_ms(r['device_ms'])} "
            f"(device), without dropout {r['ms_without_dropout']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), integer-issue "
            f"bound {r['int_bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms ({r['library']})")
    del args, dq, dk, dv, out, lse, qe, ke, ve
    torch.cuda.empty_cache()
    return fwd, bwd


def dropout_kernel_phase(dev):
    """Phase 15 (b): ``check_dropout_kernels`` at GPT-2 XL's attention
    (GPT2_XL_BATCH x 25 x 1024 x 64, the training batch of (c)) and at
    Llama-3-8B's (DROPOUT_LLAMA_SHAPE, GQA). Returns the kernels-line
    results of B1 and B7 with dropout (GPT-2 XL's as the headline, the
    other under ``shapes``)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1515)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    h, d = GPT2_XL["num_heads"], GPT2_XL["dim"] // GPT2_XL["num_heads"]
    b, s = GPT2_XL_BATCH, GPT2_XL_SEQ
    fwd, bwd = check_dropout_kernels(dev, f"GPT-2 XL attention {b}x{h}x{s}x{d}",
                                     *(rnd(b, h, s, d) for _ in range(4)))
    b, h, hk, s, d = DROPOUT_LLAMA_SHAPE
    fwd2, bwd2 = check_dropout_kernels(dev, f"Llama-3-8B attention {b}x{h}/{hk}x{s}x{d}",
                                       rnd(b, h, s, d), rnd(b, hk, s, d), rnd(b, hk, s, d),
                                       rnd(b, h, s, d))
    fwd["shapes"], bwd["shapes"] = {"llama3_8b": fwd2}, {"llama3_8b": bwd2}
    for r, r2 in ((fwd, fwd2), (bwd, bwd2)):
        r["err"] = max(r["err"], r2["err"])
    return {"flash_fwd_dropout": fwd, "flash_bwd_dropout": bwd}


def gpt2_xl_phase(dev, card):
    """Phase 15 (c): GPT-2 XL at full width and depth (1.56 B fp32 master
    parameters, bf16 products, random weights from a seed) with dropout
    0.1, trained on one repeated batch of GPT2_XL_BATCH x 1024 tokens
    through training/trainer.py, AdamW, GPT2_XL_STEPS steps, each forward
    with ``deterministic=False`` and a seeded CUDA generator (the counted
    path: 48 launches a step of B1's and of B7's dropout instantiations,
    none without; the loss falls); first, one ``deterministic=True``
    forward whose logits equal a dropout-0 model's on the same weights.
    Then the same steps with dropout 0 (48 causal B1 and B7 launches a
    step), so that the cost of dropout is recorded. Returns the counts of
    both runs and their numbers."""
    import torch
    from liteattention_torch.losses.cross_entropy import cross_entropy_loss
    from liteattention_torch.models.configs import gpt2_config
    from liteattention_torch.models.gpt import GPTLMHeadModel

    cfg = dataclasses.replace(gpt2_config(**GPT2_XL), dropout=GPT2_XL_DROPOUT)
    gen = torch.Generator(device=dev).manual_seed(7171)

    def dropout_loss(model, x):
        logits = model(x, deterministic=False, generator=gen)
        return cross_entropy_loss(logits[:, :-1], x[:, 1:])

    same = {}

    def deterministic_check(model, x):
        plain = GPTLMHeadModel(dataclasses.replace(cfg, dropout=0.0), device=dev)
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            same["equal"] = torch.equal(model(x), plain(x))
        del plain
        torch.cuda.empty_cache()
        log(f"  deterministic=True logits equal a dropout-0 model's on the same weights: "
            f"{same['equal']}")
        check(same["equal"], "GPT-2 XL: deterministic=True logits differ from a dropout-0 model's")

    n = cfg.num_layers * GPT2_XL_STEPS
    args = (GPT2_XL_BATCH, GPT2_XL_SEQ, GPT2_XL_STEPS, GPT2_XL_LR, (91, 92))
    counts = {}
    counts["gpt2_xl_dropout_train"], drop = trainer_run(
        dev, card, cfg, "GPT-2 XL, dropout 0.1", *args, loss_fn=dropout_loss,
        before=deterministic_check)
    c = counts["gpt2_xl_dropout_train"]
    check(c["flash_fwd_dropout"] == n and c["flash_bwd_dropout"] == n and c["flash_fwd"] == 0
          and c["flash_bwd_dq"] == 0,
          f"GPT-2 XL with dropout: expected {cfg.num_layers} dropout launches of B1 and of B7 a "
          "step and no other")
    check(drop["losses"][-1] < drop["losses"][0], "GPT-2 XL with dropout: the loss does not fall")
    counts["gpt2_xl_train"], plain = trainer_run(
        dev, card, dataclasses.replace(cfg, dropout=0.0), "GPT-2 XL, dropout 0", *args)
    c = counts["gpt2_xl_train"]
    check(c["flash_fwd"] == n and c["flash_bwd_dq"] == n and c["flash_fwd_dropout"] == 0,
          f"GPT-2 XL without dropout: expected {cfg.num_layers} B1 and B7 launches a step")
    cost = drop["median_ms_per_step"] / plain["median_ms_per_step"] - 1.0
    log(f"  dropout 0.1 costs {cost:+.1%} of the dropout-0 step ({drop['median_ms_per_step']:.1f} "
        f"vs {plain['median_ms_per_step']:.1f} ms) [{card}]")
    return counts, {"dropout": drop, "no_dropout": plain, "dropout_step_cost": cost,
                    "deterministic_logits_equal": same["equal"],
                    "config": {**GPT2_XL, "dropout": GPT2_XL_DROPOUT, "seq": GPT2_XL_SEQ,
                               "batch": GPT2_XL_BATCH}}


def dropout_phase(dev, card):
    """Phase 15: attention dropout, B1's and B7's dropout instantiations,
    then GPT-2 XL trained with dropout 0.1."""
    t0 = time.perf_counter()
    log("  (a) B1's keep mask read back through the kernel")
    stats = {"dropped_share": dropout_readback(dev)}
    secs = {"a": time.perf_counter() - t0}
    log(f"  (b) B1 and B7 with dropout against their plain versions ((a) took {secs['a']:.1f} s)")
    kres = dropout_kernel_phase(dev)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (c) GPT-2 XL with dropout 0.1, full width and depth ((b) took {secs['b']:.1f} s)")
    counts, stats["gpt2_xl_train"] = gpt2_xl_phase(dev, card)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (c) took {secs['c']:.1f} s")
    stats["part_seconds"] = secs
    return counts, kres, stats


# Kernels whose ptxas registers and spills ab_times reports ("flash_bwd"
# names the one-pass backward kernel and the two kernels it replaced;
# "flash_fwd_kernel" B1's wgmma kernel and, walking a live-tile list or a
# coarse schedule, B3, B4 and B5; "attention_fwd_kernel" the mma.sync loop
# that B4 ran on before, kept for older checkouts; "mla_decode_kernel"
# B10; "flash_fwd_dropout_kernel" B1's dropout channel, whose B7 side
# "flash_bwd" names).
AB_KERNELS = ("flash_fwd_kernel", "attention_fwd_kernel", "flash_decode_kernel",
              "mla_fwd_kernel", "mla_decode_kernel", "flash_bwd", "kv_compact_kernel",
              "pack_schedule_kernel", "flash_fwd_dropout_kernel")


def digest_of_digests(*digests):
    """One digest for several (the first 16 hex digits of their SHA-1)."""
    return hashlib.sha1("".join(digests).encode()).hexdigest()[:16]


def ab_times(reps):
    """``--ab DIR``: one JSON line for the checkout at DIR (whose
    ``liteattention_torch`` is imported): the card, the registers and
    spills ptxas reported per kernel of ``AB_KERNELS``, the device time
    of B1, of B3 with and without votes and of B5 (``fold_h`` 8) at the
    Wan slice's shape (1 x 40 x 32 760 x 128 bf16, banded ~50 % mask), of
    B1 at the Wan cross-attention (Sk 512), causal at GPT-2 small (8 x 12 x
    1024 x 64) and at the serving prefill (8 x 32/8 x 1024 x 128; these
    three by device_ms), of the decode kernel (with its split merge, where
    a version has one) at the kvcache API's shape (device_ms) at full
    lengths, at ragged lengths as B8 bf16 and int8 and as B9b over pages
    of 256 keys, beside SDPA (enable_gqa) at full lengths, of B4 at the
    slice's shape (coarse at BlockSizes(256, 256) over a banded ~50 %
    coarse mask, and super-tile bits of the fine band), of B10 at phase
    7's shape (ragged lengths over permuted 64-token pages, and full
    lengths contiguous, with any merge kernel it launches; device_ms)
    beside SDPA enable_gqa at full lengths, of B1's MLA kernels at phase
    7's three causal shapes (the prefill at (192, 128) and the absorbed
    (576, 512) and (64, 512) + qv over one KV head), of B6 beside
    index_select at phase 6's shape (1 x 40 x 32 768 x 128 K and V, a
    random tile order), and of
    the whole backward ``flash_attention_bwd`` at the GPT-2 small shape
    (causal), at the Wan width (1 x 40 x 8192 x 128, non-causal) and at the
    Wan training step's self-attention (1 x 40 x 32 760 x 128), with a
    digest of its dK and dV at the three, of B2
    at the slice's mask and, with ``kv_map``, at its front half (device
    time by queued_ms, call time by events, beside an empty ctypes launch
    and one fill of as many bytes); and a
    digest of the bytes of B1's, B2's, B3's and B5's outputs at the Wan shape, so
    that two checkouts can be seen to compute the same bits; and, where
    the checkout has them, B1's and B7's bound and ALiBi instantiations at
    the BERT-large padded batch and Baichuan2-13B's training shape
    (``b1_bound_ms``, ``b7_bound_ms``, ``b1_alibi_ms``, ``b7_alibi_ms``,
    with B7's dK / dV digests); digests of causal B1's out and lse and
    B7's dK / dV at 2 x 16 x 1024 at head dim 64 and at 80, 96 and 256
    where the checkout builds them (``b1_d80_digest``, ``b7_d80_dkv_digest``,
    ...; with their times), and of the decode kernel's ragged B8 bf16 and
    int8 and B9b outputs (``b8_digest``). It calls only entry points every version
    of the port has since the decode kernel (the channels only where they
    exist), so checkouts can be timed in turns on one card (older, newer,
    newer, older)."""
    import re

    import torch
    from liteattention_torch.ops import _build
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_decode
    from liteattention_torch.ops.kv_compact import compact_kv
    from liteattention_torch.ops.kv_quant import quantize_kv_cache
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
    from liteattention_torch.ops.mask import compact_mask, compact_mask_fine
    from liteattention_torch.ops.mla import mla_decode
    from liteattention_torch.ops.paged_attention import paged_attention_folded
    from liteattention_torch.ops.schedule_pack import pack_schedule
    from liteattention_torch.ops.tile_sizes import BlockSizes

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
    # B2 at the slice's mask, and with kv_map at the same band with its
    # back half of keys dead (a union of half the tiles, as the engine's
    # pre-skipped run): device time (queued_ms), call time (CUDA events over
    # back-to-back calls), and an empty kernel launched through the same
    # ctypes path where the checkout has one.
    from liteattention_torch.ops import schedule_pack as b2_module
    from liteattention_torch.ops.kv_compact import kv_union_map

    mask_kv = mask & (torch.arange(kt, device=dev) < kt // 2)
    kv_map = kv_union_map(mask_kv, hk=h)[0]
    noop = getattr(b2_module, "noop_launch", None)
    b2 = dict(zip(("b2_ms", "b2_timer"), queued_ms(lambda: pack_schedule(mask), 50)))
    b2.update(zip(("b2_kv_map_ms", "b2_kv_map_timer"),
                  queued_ms(lambda: pack_schedule(mask_kv, kv_map), 50)))
    sinks = [torch.empty(sum(x.numel() for x in pack_schedule(mask_kv, kv_map)[:n]),
                         dtype=torch.int32, device=dev) for n in (2, 3)]
    b2.update({"b2_fill_ms": queued_ms(lambda: sinks[0].fill_(1), 50)[0],
               "b2_kv_map_fill_ms": queued_ms(lambda: sinks[1].fill_(1), 50)[0],
               "b2_call_ms": cuda_ms(lambda: pack_schedule(mask), 50),
               "b2_kv_map_call_ms": cuda_ms(lambda: pack_schedule(mask_kv, kv_map), 50),
               "noop_call_ms": None if noop is None else cuda_ms(lambda: noop(dev), 50),
               "noop_ms": None if noop is None else queued_ms(lambda: noop(dev), 50)[0]})
    dq = torch.randn(API_B, API_HQ, 1, API_D, generator=g, device=dev).bfloat16()
    dk, dv = (torch.randn(API_B, API_CACHE, API_HK, API_D, generator=g, device=dev).bfloat16()
              for _ in range(2))
    b8_ms, b8_kernel_ms, b8_timer = device_ms(lambda: flash_attention_decode(dq, dk, dv),
                                              names=DECODE_KERNELS)
    # The decode kernel at the main path's ragged lengths: B8 bf16 and int8,
    # B9b over native pools of 256-key pages (a shuffled table); and SDPA
    # (enable_gqa) at full lengths, whose spread this gives beside B8's.
    lens = torch.randint(API_CACHE // 4, API_CACHE, (API_B,), generator=g, device=dev).int()
    lens[0] = API_CACHE
    c8 = quantize_kv_cache(dk, dv)
    n_pages = API_B * API_CACHE // API_PAGE
    kp, vp = (x.reshape(n_pages, API_PAGE, API_HK, API_D) for x in (dk, dv))
    table = torch.randperm(n_pages, generator=g, device=dev).reshape(API_B, -1).int()
    q3 = dq[:, :, 0]
    decode = {
        "b8_ragged_ms": lambda: flash_attention_decode(dq, dk, dv, kv_bound=lens),
        "b8_int8_ragged_ms": lambda: flash_attention_decode(
            dq, c8.k, c8.v, kv_bound=lens, k_scale=c8.k_scale, v_scale=c8.v_scale),
        "b9b_ragged_ms": lambda: paged_attention_folded(q3, kp, vp, lens, table),
        "sdpa_gqa_full_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
            dq, dk.transpose(1, 2), dv.transpose(1, 2), enable_gqa=True),
    }
    decode_calls = [decode[k] for k in ("b8_ragged_ms", "b8_int8_ragged_ms", "b9b_ragged_ms")]
    decode = {k: device_ms(fn, reps)[0] for k, fn in decode.items()}

    def digest(*tensors):
        """The first 16 hex digits of the SHA-1 of the tensors' bytes."""
        sha = hashlib.sha1()
        for x in tensors:
            if x is not None:
                sha.update(x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return sha.hexdigest()[:16]

    def bwd_ms(shape, causal, n=reps):
        """The whole backward's ms, and the digest of its dK and dV (dQ is
        summed by atomics, so only they are the same bits run to run)."""
        bq, bk, bv, bdo = (torch.randn(*shape, generator=g, device=dev).bfloat16()
                           for _ in range(4))
        bo, blse = flash_attention(bq, bk, bv, causal=causal, return_lse=True)
        scale = shape[-1] ** -0.5
        call = lambda: flash_attention_bwd(bq, bk, bv, bo, blse, bdo, scale, causal)  # noqa: E731
        return cuda_ms(call, n), digest(*call()[1:])

    gpt2_bwd, wan_bwd = bwd_ms((GPT_BATCH, 12, GPT_SEQ, 64), True), bwd_ms(WAN_BWD_SHAPE, False)
    wan_train_bwd = bwd_ms((1, WAN_BWD_SHAPE[1], WAN_TRAIN_TOKENS, 128), False, n=max(2, reps // 4))
    bwd = {"bwd_gpt2_ms": gpt2_bwd[0], "bwd_wan_ms": wan_bwd[0],
           "bwd_wan_train_ms": wan_train_bwd[0],
           "b7_dkv_digest": digest_of_digests(gpt2_bwd[1], wan_bwd[1], wan_train_bwd[1])}

    # B1's and B7's bound and ALiBi instantiations (checkouts since they
    # exist): the BERT-large padded batch and Baichuan2-13B's training
    # shape, device time and B7's dK / dV digest.
    channels = {}
    if hasattr(flash_attention, "bound_launches"):
        from liteattention_torch.modules.mha import alibi_slopes
        from liteattention_torch.ops.flash_fwd import flash_attention_masked

        lens = torch.randint(BERT_MIN_LEN, BERT_SEQ + 1, (BERT_BATCH,), generator=g, device=dev)
        for name, shape, kw in (
                ("bound", (BERT_BATCH, 16, BERT_SEQ, 64), dict(kv_bound=lens)),
                ("alibi", BAICHUAN_TRAIN_SHAPE,
                 dict(alibi_slopes=alibi_slopes(BAICHUAN_TRAIN_SHAPE[1]).to(dev), causal=True))):
            cq, ck, cv, cdo = (torch.randn(*shape, generator=g, device=dev).bfloat16()
                               for _ in range(4))
            co, clse = flash_attention_masked(cq, ck, cv, return_lse=True, **kw)
            ch = {n: x for n, x in kw.items() if n != "causal"}

            def cbwd(cq=cq, ck=ck, cv=cv, co=co, clse=clse, cdo=cdo, ch=ch, kw=kw):
                return flash_attention_bwd(cq, ck, cv, co, clse, cdo, cq.shape[-1] ** -0.5,
                                           kw.get("causal", False), **ch)

            channels[f"b1_{name}_ms"] = device_ms(
                lambda: flash_attention_masked(cq, ck, cv, **kw), reps)[0]
            channels[f"b7_{name}_ms"] = device_ms(cbwd, reps)[0]
            channels[f"b7_{name}_dkv_digest"] = digest(*cbwd()[1:])
            del cq, ck, cv, cdo, co, clse

    def b1_device_ms(b, hq, hk, sq, sk, d, causal):
        bq = torch.randn(b, hq, sq, d, generator=g, device=dev).bfloat16()
        bk, bv = (torch.randn(b, hk, sk, d, generator=g, device=dev).bfloat16() for _ in range(2))
        return device_ms(lambda: flash_attention(bq, bk, bv, causal=causal), reps)[0]

    # B4 at the slice's shape: a banded coarse mask at (256, 256), and the
    # fine band's super-tile bits.
    bq, bk = ENGINE_TILE
    mask_c = banded_mask(1, h, math.ceil(s / bq), math.ceil(s / bk), 0.5, dev)
    idx_c, count_c = compact_mask(mask_c)
    idx_s, count_s, bits_s = compact_mask_fine(mask, bq // 128, bk // 128)
    tile = BlockSizes(bq, bk)
    b4 = {"b4_coarse_ms": cuda_ms(lambda: lite_flash_attention(
              q, k, v, idx_c, count_c, 0.0, block_sizes=tile, fine_schedule=False), reps),
          "b4_super_ms": cuda_ms(lambda: lite_flash_attention(
              q, k, v, idx_s, count_s, 0.0, kv_bits=bits_s, block_sizes=tile,
              fine_schedule=False), reps),
          "b4_coarse_sparsity": 1.0 - mask_c.float().mean().item()}
    # B10 at phase 7's shape: ragged lengths over permuted pages, and full
    # lengths contiguous beside SDPA on the same cache.
    x = mla_inputs(dev)
    mq, mlens = x["q"], x["lens"]
    pool, perm = x["forms"]["paged permuted"]
    cont = x["forms"]["contiguous"][0][:, :, 0]
    full = torch.full_like(mlens, MLA_MAX_LEN)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k4 = cont[:, None]
    b10 = {"b10_ragged_ms": device_ms(lambda: mla_decode(mq, pool, mlens, MLA_DV, page_table=perm),
                                      reps, MLA_KERNELS)[0],
           "b10_full_ms": device_ms(lambda: mla_decode(mq, cont, full, MLA_DV), reps,
                                    MLA_KERNELS)[0]}
    calls = {"enable_gqa": lambda: sdpa(mq.transpose(1, 2), k4, k4[..., :MLA_DV], enable_gqa=True),
             "heads as query rows": lambda: sdpa(mq, k4, k4[..., :MLA_DV])}
    for name, call in calls.items():  # the first that some backend takes, as phase 7
        backend, b10["sdpa_mla_full_ms"], _ = sdpa_backend_ms(name, call)
        b10["sdpa_mla_backend"] = f"{name} ({backend})"
        if backend is not None:
            break
    del x, pool, cont, k4
    torch.cuda.empty_cache()
    # B1's MLA kernels at phase 7's shapes.
    pq, pk, pv = (torch.randn(MLA_PREFILL_BATCH, MLA_HEADS, MLA_PREFILL_SEQ, w, generator=g,
                              device=dev).bfloat16() for w in (MLA_QK, MLA_QK, MLA_V))
    mla = {"b1mla_prefill_ms": cuda_ms(lambda: flash_attention(pq, pk, pv, causal=True), reps)}
    for key, x in zip(("b1mla_576_ms", "b1mla_qv_ms"), mla_abs_inputs(dev).values()):
        xh = [a.transpose(1, 2).contiguous() for a in x]
        mla[key] = cuda_ms(lambda: flash_attention(
            xh[0], xh[1], xh[2], causal=True, qv=xh[3] if len(xh) > 3 else None), reps)
    del pq, pk, pv, x, xh
    torch.cuda.empty_cache()
    # B6 at phase 6's shape, beside index_select over the tile view.
    kt6 = 32768 // 128
    ka, va = (torch.randn(1, h, kt6 * 128, d, generator=g, device=dev).bfloat16() for _ in range(2))
    inv = torch.stack([torch.randperm(kt6, generator=g, device=dev) for _ in range(h)])
    inv = inv.reshape(1, h, kt6).int()
    flat = (inv.long() + torch.arange(h, device=dev).reshape(1, h, 1) * kt6).reshape(-1)
    fk, fv = ka.reshape(-1, 128 * d), va.reshape(-1, 128 * d)
    kc, vc = torch.empty_like(ka), torch.empty_like(va)
    b6 = {"b6_ms": cuda_ms(lambda: compact_kv(ka, va, inv), reps),
          "b6_index_select_ms": cuda_ms(lambda: (torch.index_select(fk, 0, flat),
                                                 torch.index_select(fv, 0, flat)), reps),
          # The same bytes in order: a plain copy of K and V.
          "b6_copy_ms": cuda_ms(lambda: (kc.copy_(ka), vc.copy_(va)), reps)}
    del ka, va, fk, fv, kc, vc
    torch.cuda.empty_cache()

    digests = {
        "b2_digest": digest(*pack_schedule(mask), *pack_schedule(mask_kv, kv_map)),
        "b1_digest": digest(*flash_attention(q, k, v, return_lse=True)),
        "b3_digest": digest(*lite_flash_attention(q, k, v, fidx, count, -1.0, mask)),
        "b5_digest": digest(*lite_flash_attention(q, k, v, fidx, count, -1.0, mask, fold_h=FOLD_H)),
    }
    # Digests of B1 (out, lse) and B7 (dK, dV) at every head dim the
    # checkout builds besides the Wan shape's 128 (causal 2 x 16 x 1024;
    # 64, and 80, 96 and 256 where its HEAD_DIMS has them), with their
    # times; and of the decode kernel's outputs at the kvcache API's shape
    # (B8 bf16 and int8, B9b), so that two checkouts can be seen to compute
    # the same bits.
    from liteattention_torch.ops import flash_bwd as bwd_module

    outs = [fn() for fn in decode_calls]
    hd = {"b8_digest": digest(*(x for o in outs for x in (o if isinstance(o, tuple) else (o,))))}
    del outs
    for hd_d in [64] + [x for x in (80, 96, 256) if x in getattr(bwd_module, "HEAD_DIMS", ())]:
        hq_, hk_, hv_, hdo = (torch.randn(2, 16, 1024, hd_d, generator=g, device=dev).bfloat16()
                              for _ in range(4))
        ho, hlse = flash_attention(hq_, hk_, hv_, causal=True, return_lse=True)

        def hbwd(hq_=hq_, hk_=hk_, hv_=hv_, ho=ho, hlse=hlse, hdo=hdo, hd_d=hd_d):
            return flash_attention_bwd(hq_, hk_, hv_, ho, hlse, hdo, hd_d**-0.5, True)

        hd[f"b1_d{hd_d}_digest"] = digest(ho, hlse)
        hd[f"b7_d{hd_d}_dkv_digest"] = digest(*hbwd()[1:])
        hd[f"b1_d{hd_d}_ms"] = device_ms(
            lambda: flash_attention(hq_, hk_, hv_, causal=True), reps)[0]
        hd[f"b7_d{hd_d}_ms"] = cuda_ms(hbwd, reps)
        del hq_, hk_, hv_, hdo, ho, hlse
    b1 = {"b1_cross_device_ms": b1_device_ms(1, h, h, s, 512, d, False),
          "b1_gpt2_device_ms": b1_device_ms(GPT_BATCH, 12, 12, GPT_SEQ, GPT_SEQ, 64, True),
          "b1_prefill_device_ms": b1_device_ms(SERVE_BATCH, 32, 8, SERVE_PROMPT, SERVE_PROMPT,
                                               128, True)}
    print(json.dumps({
        "root": sys.path[0], "card": card, "registers": regs,
        "b1_ms": cuda_ms(lambda: flash_attention(q, k, v), reps),
        "b3_ms": cuda_ms(lambda: lite_flash_attention(q, k, v, fidx, count, -1.0, mask), reps),
        "b3_novote_ms": cuda_ms(lambda: lite_flash_attention(
            q, k, v, fidx, count, -1.0, mask, emit_votes=False), reps),
        "b5_fold8_ms": cuda_ms(lambda: lite_flash_attention(
            q, k, v, fidx, count, -1.0, mask, fold_h=FOLD_H), reps),
        "sparsity": 1.0 - mask.float().mean().item(),
        "b8_ms": b8_ms, "b8_kernel_ms": b8_kernel_ms, "b8_timer": b8_timer, **decode, **bwd,
        **b1, **channels, **b2, **b4, **b10, **mla, **b6, **digests, **hd,
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
    seconds, clock = {}, [None, time.perf_counter()]

    def phase(title=None):
        """Log the seconds the running phase took, then the next one's
        title (none after the last)."""
        now = time.perf_counter()
        if clock[0] is not None:
            seconds[clock[0]] = now - clock[1]
            log(f"  {clock[0]} took {seconds[clock[0]]:.1f} s")
        clock[:] = [title and title.split(":")[0], now]
        if title:
            log(title)

    try:
        card = nvidia_smi_line()
        phase(f"phase 1: device {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        build = _build.build_kernels()
        log(f"  kernels built in {build.seconds:.1f} s -> {build.path.relative_to(ROOT)}")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
        dev = torch.device("cuda", 0)
        cfg = WanConfig()
        frames, hh, ww = SLICE_GRID
        n_tok = frames * (hh // cfg.patch_size[1]) * (ww // cfg.patch_size[2])
        phase("phase 2: kernels against their plain versions (bf16)")
        kres = kernel_phase(dev, cfg, n_tok)
        kres.update(gpt_kernel_phase(dev))
        serve_err, serve_prefill = serve_flash_check(dev)
        kres["flash_fwd_causal"]["err"] = max(kres["flash_fwd_causal"]["err"], serve_err)
        kres.update(decode_kernel_phase(dev))
        phase("phase 3: Wan2.1-14B-width denoising slice")
        counts = {"wan_denoise": slice_phase(dev, card, cfg, SLICE_GRID)}
        counts["wan_i2v"], kres["flash_fwd_i2v"], i2v_stats = i2v_phase(dev, card, cfg, SLICE_GRID)
        counts["wan_two_expert"], two_expert_stats = two_expert_phase(dev, card, cfg, SLICE_GRID)
        phase("phase 4: GPT-2 small training slice")
        counts["gpt2_train"], train_stats = train_phase(dev, card)
        phase("phase 5: Llama-3-8B-width serving slice")
        counts["serve"], serve_stats = serve_phase(dev, card)
        phase("phase 6: the rest of the LiteAttention engine at Wan2.1-14B attention width")
        counts["engine"], eres, ext, engine_stats = engine_phase(dev, cfg, card)
        kres.update(eres)
        phase("phase 7: MLA at DeepSeek-V3 width")
        counts["mla"], mres = mla_phase(dev, card)
        kres.update(mres)
        phase("phase 8: Wan training and threshold calibration")
        p8_counts, p8_bwd, wan_train_stats = wan_train_phase(dev, card, cfg, SLICE_GRID)
        counts.update(p8_counts)
        phase("phase 10: ALiBi and padded-batch serving")
        p10_counts, p10_kres, p10_stats = channel_phase(dev, card)
        counts.update(p10_counts)
        kres.update(p10_kres)
        phase("phase 11: training through B1's and B7's channels")
        p11_counts, p11_kres, p11_stats = channel_train_phase(dev, card)
        counts.update(p11_counts)
        kres.update(p11_kres)
        phase("phase 12: head dims 80 and 96; BTLM-3B-8K served and trained")
        p12_counts, p12_kres, p12_stats = btlm_phase(dev, card)
        counts.update(p12_counts)
        phase("phase 13: packed documents through the varlen functions (B1's and B7's segment "
              "channel)")
        counts["varlen"], p13_kres, p13_stats = varlen_phase(dev)
        kres.update(p13_kres)
        phase("phase 14: head dim 256; GPT-J-6B served and trained")
        p14_counts, p14_kres, p14_stats = gptj_phase(dev, card)
        phase("phase 15: attention dropout; GPT-2 XL trained with dropout 0.1")
        p15_counts, p15_kres, p15_stats = dropout_phase(dev, card)
        counts.update(p15_counts)
        kres.update(p15_kres)
        phase()
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # flash_fwd's own numbers are the Wan shape's; the causal ones sit
    # under causal_gpt2 (times at GPT-2's shape; the error over both GPT
    # shapes and the serving path's prefill and verify shapes), the serving
    # prefill's and the Wan cross-attention's under their names.
    causal = kres["flash_fwd_causal"]
    timed_keys = ("ms", "device_ms", "timer", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library", "library_device_ms")
    kres["flash_fwd"]["causal_gpt2"] = {
        "max_abs_err": causal["err"], **{k: causal[k] for k in timed_keys if k in causal},
    }
    kres["flash_fwd"]["serving_prefill"] = serve_prefill
    cross = kres["flash_fwd_cross"]
    kres["flash_fwd"]["wan_cross"] = {
        "max_abs_err": cross["err"], **{k: cross[k] for k in timed_keys if k in cross},
    }
    image = kres["flash_fwd_i2v"]
    kres["flash_fwd"]["wan_i2v_image_cross"] = {
        "max_abs_err": image["err"], **{k: image[k] for k in timed_keys + (
            "rel_l2", "worst_block_rel_l2") if k in image},
    }
    kres["flash_fwd"]["err"] = max(kres["flash_fwd"]["err"], image["err"])
    kres["flash_bwd_dq"]["fwd_bwd"] = kres["fwd_bwd"]
    # B7 at the Wan training step's shapes (phase 8 (a)).
    bwd_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                "main_kernel_ms", "timer", "rel_l2", "worst_block_rel_l2")
    for key, (shape, r) in p8_bwd.items():
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            kres[name][key] = {"shape": shape, **{k: r[name][k] for k in bwd_keys},
                               "fwd_bwd": r["fwd_bwd"]}
            kres[name]["err"] = max(kres[name]["err"], r[name]["err"])
    # Phase 12's shapes (head dims 80 and 96) under the kernels they ran.
    for key, name in (("fwd_alibi_prefill", "flash_fwd_alibi"),
                      ("fwd_alibi_decode", "flash_fwd_alibi"),
                      ("fwd_alibi_train", "flash_fwd_alibi"),
                      ("bwd_alibi_train", "flash_bwd_alibi")):
        r = p12_kres[key]
        kres[name]["shapes"][f"btlm_{key}"] = r
        kres[name]["err"] = max(kres[name]["err"], r["err"])
    for d, tag in ((80, "btlm_causal_d80"), (96, "neox_causal_d96")):
        r = p12_kres[f"fwd_causal_d{d}"]
        kres["flash_fwd"][tag] = {"max_abs_err": r["err"], **{
            k: r[k] for k in timed_keys + ("rel_l2", "worst_block_rel_l2") if k in r}}
        kres["flash_fwd"]["err"] = max(kres["flash_fwd"]["err"], r["err"])
        for name, r in p12_kres[f"bwd_causal_d{d}"].items():
            if name in ("flash_bwd_dq", "flash_bwd_dkv"):
                kres[name][tag] = {"max_abs_err": r["err"], **{
                    k: r[k] for k in bwd_keys if k in r}}
                kres[name]["err"] = max(kres[name]["err"], r["err"])
    # The new channels of B2 (kv_map) and B3 (compacted K/V), at (a)'s mask.
    kres["schedule_pack"]["kv_map"] = {
        **{k: ext["pack_kv_map"][k] for k in ("ms", "timer", "call_ms", "bound_ms")},
        "ms_without": ext["pack"]["ms"], "call_ms_without": ext["pack"]["call_ms"],
        "shape": f"(a)'s mask, sparsity {ext['a_sparsity']:.4f}"}
    kres["lite_flash_fwd"]["compacted_kv"] = {
        "ms": ext["lite_ms_compacted"], "ms_same_mask_uncompacted": ext["lite_ms_uncompacted"],
        "kv_compact_ms": kres["kv_compact"]["ms"], "shape": "(a)'s inputs and final mask"}
    # Each path's counted run read every wrapper's count (reset just before).
    # Phase 14's paths run at head dim 256 only, so their counts go to the
    # D 256 rows below and the rows above count the other paths.
    by_path = {name: {path: c[name] for path, c in counts.items()}
               for name in kernel_wrappers()}
    # name -> (source, CUDA kernel, the TPU kernel it replaces)
    sources = {
        "flash_fwd": ("flash_fwd.cu", "flash_fwd_kernel", "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_fwd_bound": ("flash_fwd.cu", "flash_fwd_kernel",
                            "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_fwd_alibi": ("flash_fwd.cu", "flash_fwd_kernel",
                            "liteattention_tpu/ops/flash_fwd.py:84"),
        "schedule_pack": ("schedule_pack.cu", "pack_schedule_kernel",
                          "liteattention_tpu/ops/schedule_pack.py:52"),
        "lite_flash_fwd": ("flash_fwd.cu", "flash_fwd_kernel",
                           "liteattention_tpu/ops/lite_flash_fwd.py:376"),
        "lite_flash_fwd_coarse": ("flash_fwd.cu", "flash_fwd_kernel",
                                  "liteattention_tpu/ops/lite_flash_fwd.py:123"),
        "lite_flash_fwd_hfold": ("flash_fwd.cu", "flash_fwd_kernel",
                                 "liteattention_tpu/ops/lite_flash_fwd.py:885"),
        "kv_compact": ("kv_compact.cu", "kv_compact_kernel", "liteattention_tpu/ops/kv_compact.py:81"),
        "flash_bwd_dq": ("flash_bwd.cu", "flash_bwd_kernel", "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_bwd_dkv": ("flash_bwd.cu", "flash_bwd_kernel",
                          "liteattention_tpu/ops/flash_bwd.py:238"),
        "flash_bwd_bound": ("flash_bwd.cu", "flash_bwd_kernel",
                            "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_bwd_alibi": ("flash_bwd.cu", "flash_bwd_kernel",
                            "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_fwd_segments": ("flash_fwd_segments.cu", "flash_fwd_kernel",
                               "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_bwd_segments": ("flash_bwd_segments.cu", "flash_bwd_segments_kernel",
                               "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_decode": ("flash_decode.cu", "flash_decode_kernel",
                         "liteattention_tpu/ops/flash_fwd.py:843"),
        "paged_decode": ("flash_decode.cu", "flash_decode_kernel",
                         "liteattention_tpu/ops/paged_attention.py:40"),
        "paged_decode_folded": ("flash_decode.cu", "flash_decode_kernel",
                                "liteattention_tpu/ops/paged_attention.py:276"),
        "flash_fwd_mla": ("flash_fwd.cu", "flash_fwd_kernel", "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_fwd_mla_v512": ("mla_fwd.cu", "mla_fwd_kernel", "liteattention_tpu/ops/flash_fwd.py:84"),
        "mla_decode": ("mla_decode.cu", "mla_decode_kernel", "liteattention_tpu/ops/mla.py:52"),
        "flash_fwd_dropout": ("flash_fwd_dropout.cu", "flash_fwd_dropout_kernel",
                              "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_bwd_dropout": ("flash_bwd_dropout.cu", "flash_bwd_dropout_kernel",
                              "liteattention_tpu/ops/flash_bwd.py:55"),
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, src, kernel, replaces, r, paths):
        """A kernels-line row: the result ``r`` of its check and timing,
        its launches on each path's counted run (``paths``)."""
        row = {"name": name, "route": "cuda", "source": f"liteattention_torch/ops/csrc/{src}",
               "kernel": kernel, "replaces": replaces, "launches": sum(paths.values()),
               "max_abs_err": r["err"], **{k: r[k] for k in keys}, "launches_by_path": paths}
        row.update({k: v for k, v in r.items() if k not in keys and k != "err"})
        if name.startswith("flash_bwd") and name not in ("flash_bwd_dq", "flash_bwd_dkv"):
            # B7a's and B7b's channels, and B7 at 256: one kernel for both
            row["replaces_too"] = "liteattention_tpu/ops/flash_bwd.py:238"
        return row

    kernels = [entry(name, src, kernel, replaces, kres[name], by_path[name])
               for name, (src, kernel, replaces) in sources.items()]
    # Head dim 256 (phase 14): each row's instantiation source, its kernel,
    # the TPU kernel it replaces, the counter it shares with its row above,
    # and phase 14 (a)'s result. B9b at 256 runs on no phase-14 path.
    d256 = {
        "flash_fwd_d256": ("flash_fwd_d256.cu", "flash_fwd_kernel<256, 256, ...>",
                           "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd",
                           p14_kres["fwd_causal"]),
        "flash_fwd_bound_d256": ("flash_fwd_d256.cu", "flash_fwd_kernel<256, 256, ...>",
                                 "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd_bound",
                                 p14_kres["fwd_bound"]),
        "flash_bwd_d256": ("flash_bwd_d256.cu", "flash_bwd_d256_kernel",
                           "liteattention_tpu/ops/flash_bwd.py:55", "flash_bwd_dq",
                           p14_kres["bwd_causal"]["flash_bwd_dq"]),
        "flash_decode_d256": ("flash_decode_d256.cu", "flash_decode_kernel<256, ...>",
                              "liteattention_tpu/ops/flash_fwd.py:843", "flash_decode",
                              p14_kres["decode"]),
        "paged_decode_folded_d256": ("flash_decode_d256.cu", "flash_decode_kernel<256, ...>",
                                     "liteattention_tpu/ops/paged_attention.py:276",
                                     "paged_decode_folded", p14_kres["paged_folded"]),
    }
    for name, (src, kernel, replaces, counter, r) in d256.items():
        row = entry(name, src, kernel, replaces, r,
                    {path: c[counter] for path, c in p14_counts.items()})
        if name == "flash_bwd_d256":
            row.update(dkv=p14_kres["bwd_causal"]["flash_bwd_dkv"],
                       fwd_bwd=p14_kres["bwd_causal"]["fwd_bwd"])
        kernels.append(row)
    for n, st in ((10, p10_stats), (11, p11_stats), (12, p12_stats), (13, p13_stats),
                  (14, p14_stats), (15, p15_stats)):
        st["seconds"] = seconds[f"phase {n}"]
    log(f"phase seconds (phase 1: the build included): {json.dumps(seconds)}")
    log(f"training: {json.dumps(train_stats)}")
    log(f"serving: {json.dumps(serve_stats)}")
    log(f"engine: {json.dumps(engine_stats)}")
    log(f"wan i2v: {json.dumps(i2v_stats)}")
    log(f"wan two-expert: {json.dumps(two_expert_stats)}")
    log(f"wan training and calibration: {json.dumps(wan_train_stats)}")
    log(f"alibi and padded-batch serving: {json.dumps(p10_stats)}")
    log(f"alibi and padded-batch training: {json.dumps(p11_stats)}")
    log(f"btlm-3b-8k serving and training: {json.dumps(p12_stats)}")
    log(f"packed documents (varlen): {json.dumps(p13_stats)}")
    log(f"gpt-j-6b serving and training: {json.dumps(p14_stats)}")
    log(f"attention dropout, gpt-2 xl training: {json.dumps(p15_stats)}")
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
