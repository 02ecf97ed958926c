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
   function (aten's flash backward for B7; for B3 FlexAttention over the
   same live tiles, which casts no votes); B1 at the Wan self- and
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
   B4 and B5 (beside FlexAttention over their live tiles) and B6 (beside
   ``index_select``) timed, and B2 / B3 with their new channels.
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
16. (Runs after 15.) The window, attention_chunk and softcap channels,
   B1's and B7's window instantiations, at the attention settings of the
   models that use them: (a) Mistral-7B-v0.1's sliding window (4095, 0)
   at Llama-3-8B's attention width, 1 x 32/8 x 16 384 x 128 causal,
   forward and backward, the forward at most 0.6x causal B1 over the same
   tokens; (b) Gemma-2's logit cap 50 and window at Llama-3-8B's width
   (no published Gemma-2 shape), 4 x 32/8 x 2048 x 128 causal, scale
   1/sqrt(128), with and without the window, beside the kernels without
   the cap; (c) Llama-4-Scout's attention_chunk 8192, 1 x
   40/8 x 32 768 x 128 causal, forward only, at most 0.35x causal B1; (e)
   GPT-2 small's attention at head dim 64 with window (255, 0), softcap
   30 and both; each against its plain version (out, lse, dQ / dK / dV,
   every 128-row block; dK, dV bit-stable), timed beside its bound over
   the visible pairs (the tensor cores' or the MUFU's, the larger), its
   plain version and FlexAttention under torch.compile (the library call;
   SDPA with the boolean band mask beside it); (d) the counted run:
   ``flash_attn_with_kvcache`` at Llama-3-8B's attention over a
   contiguous 8192-slot cache, batch 8, a 1024-token step and 32
   single-token steps with window (4095, 0) and again with
   attention_chunk 2048 (each output against the plain version over the
   same cache), then ``flash_attn_func`` forward and backward with
   Gemma-2's cap and window: 67 launches of B1's window instantiations
   (every kvcache step, as in JAX), 1 of B7's, none of the decode kernel;
   a single-token step is timed after it on B1 and on the decode kernel
   over the same keys, and the API's window step and single-token window /
   chunk steps beside their bounds and SDPA with the band mask over the
   cache. The kernels line gains the window rows.
17. (Runs after 16.) The config-tree trainer: ``liteattention_torch.train.
   run`` with ``--config configs/config.yaml experiment=gpt2s-moe`` at GPT-2
   small's published width and depth (768 wide, 12 layers of 12 heads,
   vocab 50 257; 4 experts, top-2, capacity factor 1.25) on 8 x 1024 tokens,
   12 AdamW steps on one repeated synthetic batch: the composed tree, the
   loss (finite, falling), the aux loss and the share of (token, slot)
   pairs dropped, 12 causal B1 and 12 B7 launches a step (the counted run),
   ms/step and peak memory; then block 0's MoE layer on its input from the
   trained model, bf16 against fp32 (routing identical, the router in true
   fp32), and ``check_causal`` on the model's trunk at a capacity that drops
   no token.
18. (Runs after 17.) ViT-B/16 (``ViTConfig()``: 224 x 224, patch 16, 768 /
   12 / 12, ffn 3072, bf16): B1 and B7 at its attention, 64 x 12 x 197 x 64
   non-causal, against their plain versions and timed; 64 NHWC images, the
   logits and the first block's gradients of one AdamW step on random
   labels against the same weights with the plain attention in fp32 (the
   counted step: 12 B1 and 12 B7 launches); the forward timed by
   ``utils/benchmark.py:benchmark_forward``, the step by CUDA events.
19. (Runs after 18.) Falcon-7B (``falcon_config()``: 4544 wide, 32 layers,
   71 heads of 64 on one KV head, vocab 65 024): B1's bound_causal prefill
   and the decode kernel at its 71:1 group against their plain versions,
   timed beside SDPA; then an HF-named state dict built on the card in bf16
   from a seed (``query_key_value`` grouped (1, 71 + 2, 64)), remapped by
   ``remap_state_dict_hf_falcon`` and loaded, serving 8 requests of 512
   prompt tokens and 32 greedy tokens into a bf16 cache (the counted run:
   32 bound B1 launches for the prefill, 32 decode-kernel launches a step),
   the step logits against a full recompute, prefill ms, decode ms/step and
   peak memory.
20. (Runs after 19.) The kvcache API's rest, every call through
   ``flash_attn_with_kvcache`` (the counted run, ``kvcache_rest_run``):
   (a) a continuous batch at Llama-3-8B's attention (32 q heads on 8 KV
   heads of 128, bf16) over a pool of 16 slots of 8192 tokens, 8 live ones
   picked out of order by ``cache_batch_idx``, Llama-3's rotary (theta 500
   000, half-split, all 128 features): 8 causal steps each packing two
   prefill chunks of 512-2048 tokens and six single tokens by
   ``cu_seqlens_q`` / ``cu_seqlens_k_new`` (prior lengths 0-6000; B8 reads
   the slots in place), 4 single-token steps, one packed step with a
   window (B1's route, the live slots gathered) and one on a pool of
   256-token pages (B9b); rows against ``flash_attention_plain`` per
   sequence and against the sequences run alone, the unpicked slots byte
   for byte, a decode step's allocations (no copy of the pool), the
   padding's cost and the gather's; (b) DeepSeek-V3's MLA decode (128
   heads, rope 64, latent 512, batch 64, lengths 1024-8192) through ``qv``
   and through a 576 latent cache beside its 512 V (B1-MLA V 512 with the
   key range; the two must agree), and the non-absorbed (192, 128) step
   (1024 new rows over a 4096-slot head-major cache, prior 1500-3000; B1's
   prefill kernel with the key range); (c) ``int8_mma`` on the kvcache
   API shape's int8 cache and pages of 256, against its plain version and
   within rel-L2 8e-2 of the exact dequant path. Each new variant is timed
   beside its bound, its plain version and SDPA with a boolean mask where
   one call computes the same function.
21. (Runs after 20.) The GPT-NeoX family at head dims 80 and 96: (a) B1's
   bound_causal prefill at Pythia-2.8B's (8 x 32 x 1024 x 80) and
   GPT-NeoX-20B's (8 x 64 x 1024 x 96) shapes over their serving caches,
   the decode kernel (``flash_decode_hd.cu``) at their decode steps, bf16
   and int8 (ragged and full lengths, beside SDPA ``enable_gqa``), and at
   96 over a slot pool by ``cache_batch_idx``, a native page pool (B9b)
   and a head-major one (B9a); B1's and B7's segment walks at 96 over 16
   384 tokens of 8 packed causal documents (against each document alone)
   and ALiBi at 96, forward and backward; each against its plain version,
   timed beside its bound and a library call; the int8_mma decode kernel
   alone beside the dequant one at the kvcache API shape; (b) Pythia-2.8B
   (``gpt_neox_config(dim=2560, num_layers=32, num_heads=32, vocab=50304)``,
   full width and depth) from an HF-named bf16 state dict built on the card
   and remapped by ``remap_state_dict_hf_gpt_neox``, serving 8 requests of
   1024 prompt tokens and 64 greedy tokens with bf16 and then int8 caches;
   (c) GPT-NeoX-20B at full width, 12 of its 44 layers, 8 x (1024 + 32);
   each run counted (one bound B1 launch a layer a prefill, one decode
   launch a layer a step, nothing else), its step logits against a full
   recompute and two planted faults above the limit; (d) the counted run at
   GPT-NeoX-20B's attention: ``flash_attn_with_kvcache`` contiguous, by
   ``cache_batch_idx`` and over native pages, ``paged_attention`` over
   head-major pages, ``flash_attn_varlen_func`` and ALiBi ``flash_attn_func``
   forward and backward: one launch of each, held against the plain
   versions.
22. (Runs after 21.) ``parallel/`` on torch.distributed. The parent
   (whose phase 1 built every kernel) spawns two ranks that share card 0
   over gloo: (a) the phase-3 Wan2.1-14B slice (full width, 2 blocks, the
   same seeds) with ``sp_axis``, 32 760 tokens split over the ranks (16 380
   keys and their mask tiles each), CFG, 4 steps voting at phase 3 (c2)'s
   thresholds, through ``denoise`` one step at a time (the counted run:
   B1, B2 and B3 on each rank); step 1 (every tile live) against phase
   3's single-card model by rel-L2, each later step's first
   sequence-parallel attention call against the plain versions over each
   rank's own live tiles (the merged out, B2's schedule bit for bit, the
   new mask shard outside the vote margin), the whole masks' sparsity per
   step; (b) OPT-1.3B (facebook/opt-1.3b's config.json: hidden 2048, 24
   layers, 32 heads, ffn 8192, vocab 50 272; random weights from a seed)
   through ``gpt_tp_apply`` at tp 2, each rank holding only its shard:
   8 prompts of 512 tokens and 16 greedy tokens by recompute (the counted
   run: one causal B1 launch a layer a step), the prompt logits against
   the one-rank ``GPTLMHeadModel`` and the greedy tokens equal to its
   (a differing token only where its two best logits lie within
   GREEDY_TIE); (c) Ulysses at Llama-3-8B's attention (1 x 32/8 x 16 384 x
   128, causal), forward and backward against B1 / B7 over the whole
   sequence. Then one rank over NCCL runs every new entry point against
   its one-card form (bit for bit where the path runs the same kernels)
   and ring attention, forward and backward: gloo aborts a rank on CUDA
   point-to-point, so the ring runs across ranks only on the CPU. The ranks' times are printed as they are: two ranks share
   one card, so they are no measure of parallel speed. The kernels line's
   launches gain these paths (summed over the ranks).
23. (Runs after 22.) The training half of parallel/ at two ranks sharing
   the card over gloo: (a) ``train.py`` with ``run.data_parallel=true`` on
   phase 17's gpt2s-moe run (GPT-2 small's width and depth, 4 experts,
   8 x 1024 tokens a global batch), 4 steps of ZeRO-2 with the bfloat16
   wire, then 2 steps each of plain data parallelism and ZeRO-1, each
   against the one-rank run on the same batches (loss, grad norm, the
   gathered parameters, bit-equal on the ranks; each rank's AdamW state
   about half the one rank's under ZeRO); (b) OPT-1.3B at tp 2, one
   training forward and backward of 2 x 1024 tokens through
   ``GPTLMHeadModel(cfg, group=g)`` and ``parallel_cross_entropy_loss``,
   the loss and every gradient shard against the dense model; (c)
   ``pipeline_apply`` over GPT-2 XL's 48 blocks at pp 2, 4 x 1024 tokens
   in 4 microbatches, the output and each stage's gradients against the
   blocks run one after another; (d) ``moe_apply_sharded`` at ep 2 at
   GPT-2 small MoE's layer, 8 x 1024 tokens a rank, against
   ``moe_forward`` over each rank's tokens. B1's and B7's launches are
   counted on each rank in (a)-(c) and added to the kernels line.
24. (Runs after 23.) The varlen functions with the window, softcap and
   dropout channels over packed documents, on B1's and B7's segment
   instantiations of those channels (head dims 64 and 128): (a)
   Mistral-7B's attention (32/8 x 128, sliding window 4096) over 16 384
   tokens in four documents, two longer than the window, causal, against
   each document alone through the dense window walk; (b) Gemma-2-27B's
   (32/16 x 128, scale 144^-0.5, cap 50) over 8192 tokens, its local layer
   (cap and window 4096) and its global one (the cap alone); (c)
   BERT-large's unpadded batch (phase 13's, 16 x 64) with dropout 0.1, and
   the keep mask read back through B1's out and B7's dV bit for bit. Each
   kernel against its plain version (out, lse, dQ / dK / dV, every 128-row
   block), timed beside its bound over the visible pairs, its plain
   version and one PyTorch call (FlexAttention with the document and
   window BlockMask and the cap's score_mod; SDPA efficient with the
   block-diagonal mask and dropout 0.1); the counted run is the four
   calls, forward and backward, each exactly one launch of B1's and of
   B7's instantiation with no plain version; dropout with the window or
   the cap, and these channels at head dim 96, raise naming their ROADMAP
   item before any launch.
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
    128), the split-O MLA kernel at V 512, B1 with dropout and B1 with the
    window / chunk / softcap channels; flash_bwd B7, B7 with the bound /
    low channels, B7 with ALiBi, B7 with dropout and B7 with the window /
    softcap channels; the segment walks of B1 and B7 with the window /
    chunk / softcap channels and with dropout; the MLA kernels with B1's
    key range, the decode kernel reading a slot pool by
    ``cache_batch_idx``, and its int8_mma instantiation, contiguous and
    paged)."""
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
            "flash_fwd_window": (flash_attention, "window_launches"),
            "flash_bwd_window": (flash_bwd, "window_launches"),
            "flash_fwd_segments_window": (flash_attention, "segment_window_launches"),
            "flash_bwd_segments_window": (flash_bwd, "segment_window_launches"),
            "flash_fwd_segments_dropout": (flash_attention, "segment_dropout_launches"),
            "flash_bwd_segments_dropout": (flash_bwd, "segment_dropout_launches"),
            "flash_decode": (flash_attention_decode, "launches"),
            "paged_decode": (paged_attention, "launches"),
            "paged_decode_folded": (paged_attention_folded, "launches"),
            "mla_decode": (mla_decode, "launches"),
            "flash_fwd_mla_bound": (flash_attention, "mla_bound_launches"),
            "flash_fwd_mla_v512_bound": (flash_attention, "mla_v512_bound_launches"),
            "flash_decode_batch_idx": (flash_attention_decode, "batch_idx_launches"),
            "flash_decode_int8_mma": (flash_attention_decode, "int8_mma_launches"),
            "paged_decode_folded_int8_mma": (paged_attention_folded, "int8_mma_launches")}


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
    segments, dropout_p, dropout_seed, window and softcap; the inputs the
    training path gives it): dq against B7a's plain
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
                             "kv_segments", "dropout_p", "dropout_seed", "window", "softcap")
          if n in kw}
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
    if ch.get("window") is not None:  # keys outside every row's window
        hidden |= ~visible_keys(b, q.shape[2], sk, q.device, causal, ch.get("kv_bound"),
                                ch.get("kv_low"), ch.get("bound_causal", False),
                                window=ch["window"]).any(2)[:, 0]
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
        res["library_ms"], res["library"], res["library_rel_l2"] = flex_tiles_ms(
            f"B3 {label}", q, k, v, m, ro)
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
    # The paged rows' library call: SDPA (enable_gqa) over the same keys as a
    # dense cache (the pages gathered by the table), with the key-padding
    # mask; held to the kernel's output first, so that it computes the same
    # function.
    kd, vd = (pg[x["table"].long()].reshape(b, s, hk, d).transpose(1, 2)
              for pg in (x["kp"], x["vp"]))

    def paged_library():
        return sdpa(q4, kd, vd, attn_mask=pad, enable_gqa=True)

    lib_err = rel_l2(paged_library().transpose(1, 2),
                     paged_attention_folded(x["q"], x["kp"], x["vp"], lens, x["table"]))
    check(lib_err < LIBRARY_TOL, f"SDPA over the gathered pages is {lib_err:.3e} off B9b")
    paged_lib_text = ("SDPA enable_gqa over the dense cache (the pages gathered), boolean "
                      f"key-padding mask (SDPA's own backend choice; rel-L2 {lib_err:.2e} to B9b)")
    res["paged_decode_folded"] = check_decode(
        f"B9b paged bf16 {shape}, pages {API_PAGE}", paged_attention_folded,
        paged_attention_folded_plain, (x["q"], x["kp"], x["vp"], lens, x["table"]),
        dict(return_lse=True), need(2, extra=tbl_bytes), time_it=True, library=paged_library,
    )
    res["paged_decode_folded"]["library"] = paged_lib_text
    res["paged_decode_folded"]["int8"] = check_decode(
        f"B9b paged int8 {shape}", paged_attention_folded, paged_attention_folded_plain,
        (x["q"], x["kp8"], x["vp8"], lens, x["table"]),
        dict(return_lse=True, k_scale=x["kps"], v_scale=x["vps"]),
        need(1, extra=tbl_bytes + 2 * nbytes(x["kps"])), time_it=True,
    )
    res["paged_decode_folded"]["int8"]["library"] = (
        "none: no one PyTorch call attends over an int8 cache with its scales")
    res["paged_decode"] = check_decode(
        f"B9a paged head-major bf16 {shape}", paged_attention, paged_attention_plain,
        (x["q"][:, 0], x["kh"], x["vh"], lens, x["table"]), dict(return_lse=True),
        need(2, extra=tbl_bytes), time_it=True, library=paged_library,
    )
    res["paged_decode"]["library"] = paged_lib_text
    del kd, vd
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
    """Device time of ``steps`` decode steps by kernel class, and the decode
    wrapper's own launch count over them (``decode_wrapper_launches``).
    torch.profiler sometimes drops events (ROADMAP C2; one decode launch of
    160 in one run): where it recorded fewer decode-kernel launches than
    the wrapper counted, the next ``steps`` steps are profiled again, at
    most three windows in all."""
    from liteattention_torch.ops.flash_fwd import flash_attention_decode

    for _ in range(3):
        n0 = flash_attention_decode.launches
        res = _profile_decode_window(model, inf, steps, card)
        if res is None:
            return None
        res["decode_wrapper_launches"] = flash_attention_decode.launches - n0
        if res["decode_kernel_launches"] >= res["decode_wrapper_launches"]:
            break
        log(f"  torch.profiler recorded {res['decode_kernel_launches']} decode-kernel launches of "
            f"the {res['decode_wrapper_launches']} the wrapper counted: profiling the next "
            f"{steps} steps")
    return res


def _profile_decode_window(model, inf, steps, card):
    """One profiled window of ``steps`` decode steps (profile_decode_steps)."""
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
              and prof["decode_wrapper_launches"] == 5 * cfg.num_layers
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
    coarse = {"err": max(err_c[0], err_s[0])}
    fine_c = mask_c.repeat_interleave(bq // 128, -2).repeat_interleave(bk // 128, -1)
    coarse["library_ms"], coarse["library"], _ = flex_tiles_ms(
        "(c) coarse B4", qh, kh, vh, fine_c[..., :kt, :kt].contiguous(), ro_c)
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
    hf = {"err": err_f[0], "plain_ms": plain_f_ms, "ms_unfolded_b3": unfolded}
    hf["library_ms"], hf["library"], _ = flex_tiles_ms("(d) B5", qh, kh, vh, band, ro_f)
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
# 16 frames of 32 x 32 latents -> 4096 tokens), trained for 1500 of its 3000
# steps: the steps are host-bound, and at 3000 the whole smoke ran ~1090 s of
# its 1200 s limit on the H100's host (its checks are the same at either).
PROXY_ARGS = ["--train-steps", "1500", "--eval-steps", "24", "--entropy-reg", "0.05",
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
                 q_segments=None, kv_segments=None, window=None, attention_chunk=0):
    """Bool ``[B, 1, Sq, Sk]``: the keys each q row of B1 with these
    channels sees (the plain version's rule; segments: the keys of the
    row's id; the window and the chunk: ``window_hidden``'s)."""
    import torch
    from liteattention_torch.ops.flash_bwd import window_arg, window_hidden

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
    window = window_arg(window)
    if window is not None or attention_chunk:
        off = sk - sq if kv_bound is None else kv_bound.reshape(-1, 1, 1, 1) - sq
        vis &= ~window_hidden(row, col, off, window, attention_chunk)
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
    computed in the call), with the window / chunk / softcap or dropout
    channels of ``kw`` (the seed a tensor on the card: no copy in the
    call)."""
    from liteattention_torch.ops import flash_fwd
    from liteattention_torch.ops.flash_bwd import window_arg
    from liteattention_torch.ops.segments import segment_walk

    walk = segment_walk(kw["q_segments"], kw["kv_segments"])
    ch = {n: kw[n] for n in ("dropout_p", "dropout_seed", "attention_chunk", "softcap")
          if kw.get(n) is not None}
    ch["window"] = window_arg(kw.get("window"))
    return lambda: flash_fwd._launch(q, k, v, scale, kw.get("causal", False), walk=walk,
                                     q_segments=kw["q_segments"], kv_segments=kw["kv_segments"],
                                     **ch)


# Phase 16's channels, whose rows take the MUFU bound and FlexAttention.
WINDOW_CHANNELS = ("window", "attention_chunk", "softcap")
# MUFU (the special-function unit) results an H100 SM issues a clock for
# ex2 and rcp (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0). B1 and B7 take one ex2 a score for
# the softmax, and with the cap an ex2 and an rcp more (key_mask.cuh's
# softcap_tanh).
MUFU_PER_SM_CLOCK = 16
# rel-L2 of FlexAttention's out and gradients against B1's plain version
# and B7's: the library call must compute the same function to be timed.
LIBRARY_TOL = 2e-2


def mufu_bound(res, kw, pairs):
    """Set ``res``'s MUFU-issue bound over ``pairs`` visible scores beside
    the tensor-core / bytes bound already in it, keep the larger as
    ``bound_ms`` (MUFU work counts as operations) and the kernel's share of
    it."""
    ops = 3 if kw.get("softcap") else 1
    res["mufu_ops_per_score"] = ops
    res["mufu_bound_ms"] = ops * pairs / (MUFU_PER_SM_CLOCK * H100_SMS * max_sm_clock_hz()) * 1e3
    res["tensor_bound_ms"], res["tensor_bound_by"] = res["bound_ms"], res["bound_by"]
    if res["mufu_bound_ms"] > res["bound_ms"]:
        res["bound_ms"], res["bound_by"] = res["mufu_bound_ms"], "operations"
    res["bound_share"] = res["bound_ms"] / res["ms"]


def bound_shares(res):
    """The two bounds and the kernel's share of the larger, for the log."""
    return (f"tensor-core / bytes {res['tensor_bound_ms']:.4f} ms, MUFU "
            f"{res['mufu_bound_ms']:.4f} ms ({res['mufu_ops_per_score']} a score): the kernel at "
            f"{res['bound_share']:.3f} of the larger")


_FLEX = {}


def flex_attention_call(q, k, kw):
    """PyTorch's FlexAttention under torch.compile (its Triton kernels)
    with phase 16's channels (``kw``: causal, window, attention_chunk,
    softcap, scale), phase 24's segment ids (batch 1: a key is seen by the
    rows of its id, the document mask read from the ids on the card) and
    B1's key range (kv_bound, kv_low, bound_causal: the mask reads each
    batch's bound from the tensor, and the window's position is taken from
    the bound, as the plain version's): a function of (q, k, v) and what it
    is.
    The window's and the chunk's BlockMask let it skip the tiles they hide,
    as B1's walk does; the cap is its score_mod. The library call of the
    window / chunk / softcap rows, used nowhere in the port. The mods hold
    the channels as constants (read from tensors they cost FlexAttention
    up to 3x at these shapes), a side of the window that hides no key is
    dropped, and each channel set keeps its mods and BlockMask, so the
    forward and the backward share them. The BlockMask is counted here, 128
    x 128 tiles, by evaluating the mask in row chunks (no compile, no [Sq,
    Sk] tensor). Compiled in this process (no compile workers), its caches
    under the checkout's build directory."""
    import os

    import torch
    import torch._dynamo.config
    import torch._inductor.config
    from liteattention_torch.ops._build import BUILD_ROOT
    from liteattention_torch.ops.flash_bwd import window_arg
    from torch.nn.attention.flex_attention import BlockMask, flex_attention

    dev = q.device
    if "fn" not in _FLEX:
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BUILD_ROOT / "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_ROOT / "triton"))
        torch._inductor.config.compile_threads = 1
        # One compile per shape, channel set and grad mode (about a dozen):
        # past the limit dynamo would fall back to the eager, unfused call,
        # so it raises instead.
        torch._dynamo.config.recompile_limit = 64
        torch._dynamo.config.fail_on_recompile_limit_hit = True
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    sq, sk = q.shape[2], k.shape[2]
    off, causal = sk - sq, kw.get("causal", False)
    given = window_arg(kw.get("window"))
    left, right = given or (-1, -1)
    bound_t, low_t = kw.get("kv_bound"), kw.get("kv_low")
    ranged = bound_t is not None or low_t is not None
    bound_causal = bound_t is not None and kw.get("bound_causal", False)
    if not ranged:  # (with a key range each side stays: the bound moves the rows)
        if left >= sq - 1 + off:  # the last row's window reaches key 0
            left = -1
        if right >= (0 if causal else sk - 1 - off):  # the first row's reaches the last key
            right = -1
    chunk, cap = kw.get("attention_chunk", 0), kw.get("softcap") or 0.0
    scale = kw.get("scale") or q.shape[-1] ** -0.5
    tile = 128
    qb, kb = -(-sq // tile), -(-sk // tile)
    docs = None
    if kw.get("q_segments") is not None:
        # The ids padded to whole tiles with ids no row and key share; the
        # cache keeps one BlockMask per ids (their sums as its key).
        qs = torch.nn.functional.pad(kw["q_segments"].reshape(-1).int(), (0, qb * tile - sq),
                                     value=-3)
        ks = torch.nn.functional.pad(kw["kv_segments"].reshape(-1).int(), (0, kb * tile - sk),
                                     value=-4)
        pos_w = torch.arange(1, qs.numel() + 1, device=dev, dtype=torch.int64)
        docs = (qs, ks, int((qs.long() * pos_w).sum()),
                int((ks.long() * torch.arange(1, ks.numel() + 1, device=dev)).sum()))
    nb = q.shape[0] if ranged else 1
    rng = None
    if ranged:
        # Each batch's [low, bound) (unset: [0, Sk)); the cache keeps one
        # BlockMask per range, keyed by its values.
        lim = (torch.full((nb,), sk, device=dev) if bound_t is None
               else bound_t.reshape(-1).to(dev).long())
        first = (torch.zeros(nb, dtype=torch.long, device=dev) if low_t is None
                 else low_t.reshape(-1).to(dev).long())
        rng = (lim, first, tuple(lim.tolist()), tuple(first.tolist()))
    key = (tuple(q.shape), tuple(k.shape), causal, left, right, chunk, cap, scale,
           docs and docs[2:], rng and (rng[2:], bound_causal))
    if key not in _FLEX:

        def mask_mod(b, h, qi, ki):
            keep = ki <= qi + off if causal else ki >= 0
            pos = qi + off
            if rng is not None:
                lim_b = rng[0][b]
                keep = keep & (ki >= rng[1][b])
                keep = keep & (ki < (lim_b - sq + qi + 1 if bound_causal else lim_b))
                if bound_t is not None:  # the window's rows sit against the bound
                    pos = qi + lim_b - sq
            if left >= 0:
                keep = keep & (ki >= pos - left)
            if right >= 0:
                keep = keep & (ki <= pos + right)
            if chunk:  # pos >= 0 here, so // floors
                keep = keep & (ki // chunk == pos // chunk)
            if docs is not None:
                keep = keep & (docs[0][qi] == docs[1][ki])
            return keep

        ki = torch.arange(kb * tile, device=dev)
        seen = torch.empty(nb, qb, kb, dtype=torch.int64, device=dev)
        for bi in range(nb):
            b_t = torch.tensor(bi, device=dev)
            for i in range(0, qb, 8):
                qi = torch.arange(i * tile, min(i + 8, qb) * tile, device=dev)[:, None]
                vis = mask_mod(b_t, None, qi, ki[None]) & (qi < sq) & (ki[None] < sk)
                seen[bi, i : i + 8] = vis.reshape(-1, tile, kb, tile).sum((1, 3))
        full, part = seen == tile * tile, (seen > 0) & (seen < tile * tile)

        def ordered(blocks):
            return (blocks.sum(-1).int()[:, None],
                    torch.argsort(blocks.int(), dim=-1, descending=True, stable=True).int()[
                        :, None])

        block = BlockMask.from_kv_blocks(*ordered(part), *ordered(full), BLOCK_SIZE=tile,
                                         mask_mod=mask_mod, seq_lengths=(sq, sk))
        score_mod = (lambda x, b, h, qi, ki: cap * torch.tanh(x / cap)) if cap else None
        gqa, fn = k.shape[1] != q.shape[1], _FLEX["fn"]
        _FLEX[key] = lambda q_, k_, v_: fn(q_, k_, v_, score_mod=score_mod, block_mask=block,
                                           scale=scale, enable_gqa=gqa)
    kept = given is not None and (left, right) != (-1, -1)
    what = " and ".join(n for n, on in (("document", docs is not None), ("causal", causal),
                                         ("per-batch key range", ranged),
                                         (f"window {given}", kept), (f"chunk {chunk}", chunk))
                        if on)
    what = (f"FlexAttention (torch.compile, Triton) with a {what or 'full'} BlockMask"
            + (f" and a cap {cap} tanh score_mod" if cap else "")
            + (f" (the window {given} hides no key at this shape)"
               if given is not None and not kept else ""))
    return _FLEX[key], what


def flex_tiles_ms(label, q, k, v, live, ro):
    """FlexAttention (torch.compile) over the 128 x 128 tiles ``live``
    ``[B, H, Qt, Kt]`` marks, the library call of the lite rows (B3, B4,
    B5: the same attention over the same live tiles; FlexAttention casts
    no votes): its out against the plain version's ``ro`` (rel-L2 within
    LIBRARY_TOL), its device time and what it is. The BlockMask lists the
    live tiles; those a ragged last q- or key tile cuts are partial."""
    import os

    import torch
    import torch._dynamo.config
    import torch._inductor.config
    from liteattention_torch.ops._build import BUILD_ROOT
    from torch.nn.attention.flex_attention import BlockMask, flex_attention

    if "fn" not in _FLEX:
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BUILD_ROOT / "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_ROOT / "triton"))
        torch._inductor.config.compile_threads = 1
        torch._dynamo.config.recompile_limit = 64
        torch._dynamo.config.fail_on_recompile_limit_hit = True
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    sq, sk, tile = q.shape[2], k.shape[2], 128
    qt, kt = live.shape[-2:]
    whole = torch.ones(qt, kt, dtype=torch.bool, device=live.device)
    if sq % tile:
        whole[-1] = False
    if sk % tile:
        whole[:, -1] = False
    full, part = live & whole, live & ~whole

    def ordered(blocks):
        return (blocks.sum(-1).int(),
                torch.argsort(blocks.int(), dim=-1, descending=True, stable=True).int())

    block = BlockMask.from_kv_blocks(*ordered(part), *ordered(full), BLOCK_SIZE=tile,
                                     mask_mod=lambda b, h, qi, ki: ki >= 0, seq_lengths=(sq, sk))
    fn = _FLEX["fn"]
    t0 = time.perf_counter()
    out = fn(q, k, v, block_mask=block)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    err = rel_l2(out, ro)
    check(err < LIBRARY_TOL, f"{label}: FlexAttention's out is {err:.3e} off the plain version")
    del out
    ms, _, timer = device_ms(lambda: fn(q, k, v, block_mask=block))
    what = (f"FlexAttention (torch.compile, Triton) over the live 128 x 128 tiles as its "
            f"BlockMask (no votes; {timer})")
    log(f"  {label}: {what}: {ms:.4f} ms (compiled in {compile_s:.1f} s), rel-L2 {err:.3e} "
        "against the plain version")
    return ms, what, err


def flex_fwd_ms(label, q, k, v, kw, ro):
    """FlexAttention's forward with ``kw``'s channels, on inputs that
    require grad (its training graph, lse kept as B1 keeps it; the
    backward then reuses the compile): its out against the plain version's
    ``ro`` (rel-L2 within LIBRARY_TOL), its device time, its description
    and the rel-L2."""
    import torch

    fn, what = flex_attention_call(q, k, kw)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    t0 = time.perf_counter()
    out = fn(qg, kg, vg).detach()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    err = rel_l2(out, ro)
    check(err < LIBRARY_TOL, f"{label}: FlexAttention's out is {err:.3e} off the plain version")
    del out
    ms, _, timer = device_ms(lambda: fn(qg, kg, vg))
    log(f"  {label}: {what}: {ms:.4f} ms ({timer}; compiled in {compile_s:.1f} s), rel-L2 "
        f"{err:.3e} against the plain version")
    return ms, f"{what}, its training forward ({timer})", err


def flex_bwd_ms(label, q, k, v, dout, kw, grads):
    """FlexAttention's backward with ``kw``'s channels: its dQ / dK / dV
    against B7's ``grads`` (rel-L2 within LIBRARY_TOL), its device time (the
    forward and backward less the training forward, each by device_ms), its
    description and the largest rel-L2."""
    import torch

    fn, what = flex_attention_call(q, k, kw)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def step():
        return torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg), dout)

    t0 = time.perf_counter()
    got = step()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    err = max(rel_l2(a, b) for a, b in zip(got, grads))
    check(err < LIBRARY_TOL, f"{label}: FlexAttention's gradients are {err:.3e} off B7's")
    del got
    both, _, timer = device_ms(step)
    fwd = device_ms(lambda: fn(qg, kg, vg))[0]
    log(f"  {label}: {what} backward: {both - fwd:.4f} ms (forward and backward {both:.4f} less "
        f"the forward {fwd:.4f}, {timer}; compiled in {compile_s:.1f} s), rel-L2 {err:.3e} "
        "against B7")
    return both - fwd, f"{what}, backward (forward + backward less forward, {timer})", err


def check_channels(label, q, k, v, kw, time_it=False):
    """B1 with its per-batch channels (``kw``: kv_bound, kv_low,
    bound_causal, alibi_slopes, segments, window, attention_chunk, softcap,
    causal, scale) against its plain version
    on the same inputs: out within OUT_TOL of max(1, |plain|), lse within
    LSE_TOL, every (b, h, 128-row block) within B1_BLOCK_TOL. With
    ``time_it`` also its device time beside its bound (only the visible
    key pairs and the key rows inside each batch's range), the plain
    version's time and SDPA's with the equivalent mask (a boolean mask; an
    additive bias for ALiBi; none with softcap, which no PyTorch call
    takes), the backend named. Where the channels are the
    same over the batch the mask is one [1, H, Sq, Sk] that SDPA broadcasts
    (BTLM's prefill would not fit a [B, H, Sq, Sk] bias beside the plain
    version). With a key range (``kv_bound`` / ``kv_low``) the window / chunk
    rows' library call is SDPA with the band as a boolean mask, and with the
    cap FlexAttention with the range in its mask."""
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
                       kw.get("bound_causal", False), kw.get("q_segments"), kw.get("kv_segments"),
                       kw.get("window"), kw.get("attention_chunk", 0))
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
    windowed = any(kw.get(n) for n in WINDOW_CHANNELS)
    if windowed:
        mufu_bound(res, kw, pairs)
    ranged = kw.get("kv_bound") is not None or kw.get("kv_low") is not None
    flex = windowed and (kw.get("softcap") or not ranged)
    if flex:
        # The window / chunk / cap: the MUFU bound beside the tensor cores',
        # and FlexAttention as the library call (SDPA with the band as a
        # boolean mask beside it, for the window and the chunk).
        res["library_ms"], res["library"], res["library_rel_l2"] = flex_fwd_ms(
            f"B1 {label}", q, k, v, kw, ro)
        lib = f"{res['library_ms']:.4f} ms {res['library']}"
    if kw.get("softcap"):
        log(f"  B1 {label}: kernel {res['ms']:.4f} ms ({res['timer']}), plain "
            f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{pairs} visible pairs; {bound_shares(res)}), library {lib}")
        return res
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
    if "q_segments" in kw or "window" in kw or "attention_chunk" in kw:
        # the efficient backend, as the backward's: K/V expanded
        kl, vl, gqa = k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1), False
    sdpa_key = "sdpa" if flex else "library"
    drop = kw.get("dropout_p", 0.0)
    if drop:
        kind += f" and dropout_p {drop} (Philox: another mask, the same work)"
    backend, res[sdpa_key + "_ms"], t_lib = sdpa_backend_ms(
        f"B1 {label}", lambda: sdpa(q, kl, vl, attn_mask=mask, scale=scale, enable_gqa=gqa,
                                    dropout_p=drop))
    res[sdpa_key] = None if backend is None else f"SDPA {backend} with {kind} ({t_lib})"
    del mask, kl, vl
    sdpa_lib = "n/a" if backend is None else f"{res[sdpa_key + '_ms']:.4f} ms {res[sdpa_key]}"
    if "call_ms" in res:
        log(f"  B1 {label}: the whole call (ranges and kernel) {res['call_ms']:.4f} ms "
            f"({res['call_timer']})")
    log(f"  B1 {label}: kernel {res['ms']:.4f} ms ({res['timer']}), plain {res['plain_ms']:.3f} "
        f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; {pairs} visible pairs"
        + (f"; {bound_shares(res)}), library {lib}, SDPA {sdpa_lib}" if flex
           else f"{'; ' + bound_shares(res) if windowed else ''}), library {sdpa_lib}"))
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


def sdpa_bwd_backend_ms(label, q, k, v, dout, mask, scale, dropout_p=0.0):
    """One PyTorch call of the same backward: SDPA's backward (the
    memory-efficient backend first, then cuDNN and math) with ``mask``
    (boolean or additive) and ``dropout_p``, K/V expanded to the q heads,
    through torch.autograd.grad of its forward; (backend, device ms of the
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
                out = sdpa(qg, kg, vg, attn_mask=mask, scale=scale, dropout_p=dropout_p)

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
    bound_causal, alibi_slopes, segments, window, softcap, causal, scale),
    checked by ``verify_bwd`` with the subnormal floor. With ``time_it``
    also the whole backward's device time beside its bound (the visible key
    pairs and the key rows inside each batch's range), the plain version's
    time and SDPA's backward with the equivalent mask or bias (none with
    softcap). ``keep``: also return (dq, dk, dv)."""
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
                           ch.get("kv_segments"), ch.get("window"))
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
        flex = any(ch.get(n) for n in WINDOW_CHANNELS)
        if flex:  # as in check_channels
            mufu_bound(res, ch, pairs)
            res["library_ms"], res["library"], res["library_rel_l2"] = flex_bwd_ms(
                f"B7 {label}", q, k, v, dout, dict(ch, causal=causal, scale=scale), (dq, dk, dv))
            lib = f"{res['library_ms']:.4f} ms {res['library']}"
        if ch.get("softcap"):
            log(f"  B7 {label}: backward {res['ms']:.4f} ms ({res['timer']}), plain "
                f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
                f"{pairs} visible pairs; {bound_shares(res)}), library {lib}")
            return (res, (dq, dk, dv)) if keep else res
        if slopes is None:
            mask, kind = vis, "a boolean mask"
        else:
            slopes = slopes.float().reshape(-1, h).expand(b, h)[:, :, None, None]
            dist = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                    - torch.arange(sk, device=q.device)[None, :]).float()
            dist = dist if causal else dist.abs()
            mask = (-slopes * dist).masked_fill(~vis, -torch.inf).to(q.dtype)
            kind = "an additive ALiBi bias"
        sdpa_key = "sdpa" if flex else "library"
        drop = ch.get("dropout_p", 0.0)
        if drop:
            kind += f" and dropout_p {drop} (Philox: another mask, the same work)"
        backend, res[sdpa_key + "_ms"], t_lib = sdpa_bwd_backend_ms(
            f"B7 {label}", q, k, v, dout, mask, scale, drop)
        res[sdpa_key] = (None if backend is None
                         else f"SDPA {backend} backward with {kind} ({t_lib})")
        del mask
        torch.cuda.empty_cache()
        sdpa_lib = "n/a" if backend is None else f"{res[sdpa_key + '_ms']:.4f} ms {res[sdpa_key]}"
        if "call_ms" in res:
            log(f"  B7 {label}: the whole call (ranges and kernels) {res['call_ms']:.4f} ms "
                f"({res['call_timer']})")
        log(f"  B7 {label}: backward {res['ms']:.4f} ms ({res['timer']}), plain "
            f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{pairs} visible pairs"
            + (f"; {bound_shares(res)}), library {lib}, SDPA {sdpa_lib}" if flex
               else f"), library {sdpa_lib}"))
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


def docs_alone_check(label, q, k, v, dout, lengths, cu, scale, window=None, softcap=0.0):
    """flash_attn_varlen_func over the packed causal documents (forward and
    autograd backward) against each document alone through causal B1 / B7
    (``flash_attention``; with ``window`` or ``softcap`` the dense window
    walk, ``flash_attention_masked``), concatenated: rel-L2 of out, dq, dk,
    dv within PACKED_DOC_TOL. Returns the rel-L2s."""
    import torch
    from liteattention_torch import flash_attn_varlen_func
    from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_masked

    out = flash_attn_varlen_func(q, k, v, cu, cu, softmax_scale=scale, causal=True,
                                 window_size=window or (-1, -1), softcap=softcap)
    got = [out.detach(), *torch.autograd.grad(out, (q, k, v), dout)]
    want = [[], [], [], []]
    for a, n in zip(cu[:-1].tolist(), lengths):
        parts = [x.detach()[a : a + n].transpose(0, 1)[None].contiguous().requires_grad_()
                 for x in (q, k, v)]
        o = (flash_attention(*parts, scale=scale, causal=True) if window is None and not softcap
             else flash_attention_masked(*parts, scale=scale, causal=True, window=window,
                                         softcap=softcap))
        grads = torch.autograd.grad(o, parts, dout[a : a + n].transpose(0, 1)[None])
        for i, x in enumerate((o, *grads)):
            want[i].append(x.detach()[0].transpose(0, 1))
    rels = {n: rel_l2(g_, torch.cat(w)) for n, g_, w in zip(("out", "dq", "dk", "dv"), got, want)}
    log(f"  {label}: the packed documents vs each alone (causal B1 / B7"
        + (f", window {window}" if window else "") + (f", cap {softcap}" if softcap else "")
        + "), rel-L2 "
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
    # Its library call: SDPA over the dense cache the pages were cut from
    # (the same keys), with the key-padding mask, as the B8 row's.
    res["paged_folded"] = check_decode(
        f"B9b bf16 {shape}, native pool, pages of {GPTJ_PAGE}", paged_attention_folded,
        paged_attention_folded_plain, (q[:, :, 0], kp, vp, lens, table),
        dict(return_lse=True), need(2, extra=nbytes(table)), time_it=True,
        library=lambda: sdpa(q, kc, vc, attn_mask=pad))
    res["paged_folded"]["library"] = ("torch SDPA over the dense cache, boolean key-padding "
                                      "mask (SDPA's own backend choice)")
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
        check(prof["decode_kernel_launches"] == 5 * cfg.num_layers
              and prof["decode_wrapper_launches"] == 5 * cfg.num_layers,
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


# ---------------------------------------------------------------- phase 16

# The window, attention_chunk and softcap channels at the attention settings
# of the models that use them, at Llama-3-8B's attention width (32 q heads on
# 8 KV heads of 128; Mistral-7B-v0.1's is the same). (a) Mistral-7B-v0.1
# (config.json sliding_window 4096: a row sees itself and the 4095 keys
# before it): b, h, hk, tokens, d; (b) Gemma-2's cap and window
# (attn_logit_softcapping 50.0, sliding_window 4096) at that width, scale 1 /
# sqrt(128): no published Gemma-2 shape (Gemma-2-27B has 32 q heads on 16
# of 128 at scale 1/12, its 2B and 9B head dim 256); (c)
# Llama-4-Scout-17B-16E (attention_chunk_size 8192) at its 40 q heads on 8;
# (d) the kvcache API at Llama-3-8B's attention over a contiguous 8192-slot
# cache: batch, prompt step, single-token steps, the caches' prior lengths
# (seeded), the chunk whose boundaries fall inside the cache; (e) GPT-2
# small's attention at head dim 64 (8 x 12 x 1024, causal).
MISTRAL_WINDOW_SHAPE, MISTRAL_WINDOW = (1, 32, 8, 16384, 128), (4095, 0)
GEMMA2_SHAPE, GEMMA2_SOFTCAP, GEMMA2_WINDOW = (4, 32, 8, 2048, 128), 50.0, (4095, 0)
LLAMA4_CHUNK_SHAPE, LLAMA4_CHUNK = (1, 40, 8, 32768, 128), 8192
WINDOW_KV = dict(batch=8, heads=32, kv_heads=8, d=128, capacity=8192, prompt=1024, steps=32,
                 prior=(1200, 4000), chunk=2048)
GPT2_WINDOW_SHAPE, GPT2_WINDOW, GPT2_SOFTCAP = (8, 12, 1024, 64), (255, 0), 30.0
# The window forward over causal B1 over the same tokens at (a), and the
# chunk forward's at (c): the tiles they visit are ~0.45 and ~0.25 of its.
WINDOW_TIME_LIMIT, CHUNK_TIME_LIMIT = 0.6, 0.35


def walk_share(n_tok, window=None, chunk=0, tile=128):
    """The share of causal B1's (q-tile, k-tile) visits over ``n_tok``
    tokens that the window walk makes (B1's window_range on 128-row
    q-tiles and 128-key tiles; Sq = Sk, no bound)."""
    full = visits = 0
    for qt in range(-(-n_tok // tile)):
        q0, last = qt * tile, min(qt * tile + tile, n_tok) - 1
        lo = 0
        if window is not None and window[0] >= 0:
            lo = max(lo, q0 - window[0])
        if chunk:
            lo = max(lo, q0 // chunk * chunk)
        full += last // tile + 1
        visits += last // tile - lo // tile + 1
    return visits / full


def window_kernel_phase(dev):
    """Phase 16 (a), (b), (c) and (e): B1's window / chunk / softcap
    instantiations and B7's window / softcap ones against their plain
    versions (out, lse, dQ / dK / dV and every 128-row block; dK, dV
    bit-stable), each shape timed beside its bound over the visible pairs,
    its plain version and SDPA with a boolean band mask (softcap: none);
    the window forward at (a) and the chunk forward at (c) against causal
    B1 over the same tokens (WINDOW_TIME_LIMIT, CHUNK_TIME_LIMIT), the
    softcap forms against the same kernels without the cap. Returns the
    kernels line's flash_fwd_window and flash_bwd_window entries and the
    phase's stats."""
    import torch
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention

    g = torch.Generator(device=dev).manual_seed(1616)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def causal_times(q, k, v, dout, scale=None):
        """Channel-free causal B1's and B7's device times on the same
        inputs (the yardsticks of the walks and of the cap)."""
        fwd_ms, _, timer = device_ms(lambda: flash_attention(q, k, v, scale=scale, causal=True))
        out, lse = flash_attention(q, k, v, scale=scale, causal=True, return_lse=True)
        d = q.shape[-1]
        bwd_ms = device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout,
                                                       scale or d**-0.5, True))[0]
        return fwd_ms, bwd_ms, timer

    fwd, bwd, stats = {}, {}, {}
    # (a) Mistral-7B's sliding window at Llama-3-8B's attention width.
    b, h, hk, n, d = MISTRAL_WINDOW_SHAPE
    q, k, v, dout = rnd(b, h, n, d), rnd(b, hk, n, d), rnd(b, hk, n, d), rnd(b, h, n, d)
    kw = dict(causal=True, window=MISTRAL_WINDOW)
    label = f"window {MISTRAL_WINDOW} causal {b}x{h}/{hk}x{n}x{d} (Mistral-7B)"
    fwd["mistral_window"] = check_channels(label, q, k, v, kw, time_it=True)
    bwd["mistral_window"] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
    full_fwd, full_bwd, timer = causal_times(q, k, v, dout)
    share = walk_share(n, MISTRAL_WINDOW)
    ratio = fwd["mistral_window"]["ms"] / full_fwd
    fwd["mistral_window"].update(causal_ms=full_fwd, over_causal=ratio, tile_share=share)
    bwd["mistral_window"].update(causal_ms=full_bwd,
                                 over_causal=bwd["mistral_window"]["ms"] / full_bwd)
    log(f"  B1 {label}: {fwd['mistral_window']['ms']:.4f} ms against causal B1 over the same "
        f"tokens {full_fwd:.4f} ms ({timer}): {ratio:.3f}x (limit {WINDOW_TIME_LIMIT}x; the walk "
        f"visits {share:.3f} of its tiles); B7 {bwd['mistral_window']['ms']:.4f} ms against "
        f"causal B7 {full_bwd:.4f} ms: {bwd['mistral_window']['over_causal']:.3f}x")
    check(ratio <= WINDOW_TIME_LIMIT, f"the window forward takes {ratio:.3f}x causal B1")
    del q, k, v, dout
    torch.cuda.empty_cache()

    # (b) Gemma-2's cap and window at Llama-3-8B's width: the cap with and
    # without the window, beside the kernels without the cap.
    b, h, hk, n, d = GEMMA2_SHAPE
    scale = d**-0.5
    q, k, v, dout = rnd(b, h, n, d), rnd(b, hk, n, d), rnd(b, hk, n, d), rnd(b, h, n, d)
    full_fwd, full_bwd, timer = causal_times(q, k, v, dout, scale)
    for key, extra in (("gemma2_softcap", {}),
                       ("gemma2_softcap_window", dict(window=GEMMA2_WINDOW))):
        kw = dict(causal=True, softcap=GEMMA2_SOFTCAP, scale=scale, **extra)
        label = (f"softcap {GEMMA2_SOFTCAP}{' window ' + str(GEMMA2_WINDOW) if extra else ''} "
                 f"causal {b}x{h}/{hk}x{n}x{d} (Gemma-2's cap and window at Llama-3-8B's "
                 "width)")
        fwd[key] = check_channels(label, q, k, v, kw, time_it=True)
        bwd[key] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
        for r, base in ((fwd[key], full_fwd), (bwd[key], full_bwd)):
            r.update(without_softcap_ms=base, softcap_cost=r["ms"] / base)
        log(f"  {label}: the cap costs B1 {fwd[key]['softcap_cost']:.3f}x and B7 "
            f"{bwd[key]['softcap_cost']:.3f}x of causal B1 / B7 without it ({full_fwd:.4f} / "
            f"{full_bwd:.4f} ms, {timer})")
    del q, k, v, dout
    torch.cuda.empty_cache()

    # (c) Llama-4-Scout's chunked attention, forward only.
    b, h, hk, n, d = LLAMA4_CHUNK_SHAPE
    q, k, v = rnd(b, h, n, d), rnd(b, hk, n, d), rnd(b, hk, n, d)
    kw = dict(causal=True, attention_chunk=LLAMA4_CHUNK)
    label = f"attention_chunk {LLAMA4_CHUNK} causal {b}x{h}/{hk}x{n}x{d} (Llama-4-Scout)"
    fwd["llama4_chunk"] = check_channels(label, q, k, v, kw, time_it=True)
    full_fwd, _, timer = device_ms(lambda: flash_attention(q, k, v, causal=True))
    share = walk_share(n, chunk=LLAMA4_CHUNK)
    ratio = fwd["llama4_chunk"]["ms"] / full_fwd
    fwd["llama4_chunk"].update(causal_ms=full_fwd, over_causal=ratio, tile_share=share)
    log(f"  B1 {label}: {fwd['llama4_chunk']['ms']:.4f} ms against causal B1 over the same "
        f"tokens {full_fwd:.4f} ms ({timer}): {ratio:.3f}x (limit {CHUNK_TIME_LIMIT}x; the walk "
        f"visits {share:.3f} of its tiles)")
    check(ratio <= CHUNK_TIME_LIMIT, f"the chunk forward takes {ratio:.3f}x causal B1")
    del q, k, v
    torch.cuda.empty_cache()

    # (e) The D 64 forms at GPT-2 small's attention.
    b, h, n, d = GPT2_WINDOW_SHAPE
    q, k, v, dout = (rnd(b, h, n, d) for _ in range(4))
    full_fwd, full_bwd, timer = causal_times(q, k, v, dout)
    stats["gpt2_causal_ms"] = {"fwd": full_fwd, "bwd": full_bwd, "timer": timer}
    for key, extra in (("gpt2_window", dict(window=GPT2_WINDOW)),
                       ("gpt2_softcap", dict(softcap=GPT2_SOFTCAP)),
                       ("gpt2_window_softcap", dict(window=GPT2_WINDOW, softcap=GPT2_SOFTCAP))):
        kw = dict(causal=True, **extra)
        label = f"{key.split('_', 1)[1]} causal {b}x{h}x{n}x{d} (GPT-2 small, D 64)"
        fwd[key] = check_channels(label, q, k, v, kw, time_it=True)
        bwd[key] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
        fwd[key]["over_causal"] = fwd[key]["ms"] / full_fwd
        bwd[key]["over_causal"] = bwd[key]["ms"] / full_bwd
    log("  GPT-2 small, over causal B1 / B7 without the channels (" + f"{full_fwd:.4f} / "
        f"{full_bwd:.4f} ms): " + ", ".join(f"{key} {fwd[key]['over_causal']:.3f}x / "
                                           f"{bwd[key]['over_causal']:.3f}x"
                                           for key in fwd if key.startswith("gpt2")))
    del q, k, v, dout
    torch.cuda.empty_cache()
    return ({"flash_fwd_window": _channel_entry(fwd, "mistral_window"),
             "flash_bwd_window": _channel_entry(bwd, "mistral_window")}, stats)


def window_serve_run(dev):
    """Phase 16 (d) and its counted run, the main path: the kvcache API at
    Llama-3-8B's attention over a contiguous 8192-slot bf16 cache
    (head-major), batch 8 with seeded prior lengths, a 1024-token step then
    32 single-token steps, with window (4095, 0) and then with
    attention_chunk 2048 (its boundaries fall inside the cache), every step
    on B1's window instantiation (as in JAX); every output against
    ``flash_attention_plain`` over the same cache. Then one forward and
    backward through ``flash_attn_func`` with Gemma-2's cap and window
    (causal, window (4095, 0), softcap 50) on phase (b)'s shape. The counts
    are set to 0 just before and read just after: 67 launches of B1's
    window instantiations, 1 of B7's and no other B1 / B7 or decode-kernel
    launch. Then the steps are timed, a single-token step also on the
    decode kernel over the same keys. Returns the counts and the stats."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_func, flash_attn_with_kvcache
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_masked,
        flash_attention_plain,
    )

    cfg = WINDOW_KV
    b, h, hk, d, cap = cfg["batch"], cfg["heads"], cfg["kv_heads"], cfg["d"], cfg["capacity"]
    prompt, steps = cfg["prompt"], cfg["steps"]
    g = torch.Generator(device=dev).manual_seed(1617)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    gl = torch.Generator().manual_seed(16)
    prior = torch.randint(cfg["prior"][0], cfg["prior"][1] + 1, (b,), generator=gl,
                          dtype=torch.int32).to(dev)
    forms = (("window", dict(window_size=MISTRAL_WINDOW)),
             ("chunk", dict(attention_chunk=cfg["chunk"])))
    data = {}
    for name, _ in forms:
        data[name] = dict(kc=rnd(b, hk, cap, d), vc=rnd(b, hk, cap, d),
                          prefill=(rnd(b, prompt, h, d), rnd(b, prompt, hk, d),
                                   rnd(b, prompt, hk, d)),
                          steps=[(rnd(b, 1, h, d), rnd(b, 1, hk, d), rnd(b, 1, hk, d))
                                 for _ in range(steps)])
    gb, gh, ghk, gn, gd = GEMMA2_SHAPE
    train = [rnd(gb, gn, x, gd).requires_grad_() for x in (gh, ghk, ghk)] + [rnd(gb, gn, gh, gd)]
    errs = {}

    def held(name, out, lse, q, kc, vc, bound, kw):
        ro, rl = flash_attention_plain(q.transpose(1, 2), kc, vc, kv_bound=bound,
                                       bound_causal=True, window=kw.get("window_size"),
                                       attention_chunk=kw.get("attention_chunk", 0))
        err = ((out.transpose(1, 2).float() - ro.float()).abs()
               / ro.float().abs().clamp_min(1.0)).max().item()
        err_l = (lse - rl).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        errs[name + "_lse"] = max(errs.get(name + "_lse", 0.0), err_l)
        check(err < OUT_TOL and err_l < LSE_TOL, f"kvcache {name}: {err:.3e} / lse {err_l:.3e}")

    torch.cuda.synchronize()
    reset_counts()
    for name, kw in forms:
        x = data[name]
        lens = prior.clone()
        q, kn, vn = x["prefill"]
        out, lse, _ = flash_attn_with_kvcache(q, x["kc"], x["vc"], kn, vn, cache_seqlens=lens,
                                              causal=True, return_softmax_lse=True,
                                              kv_cache_layout="bhsd", **kw)
        held(f"{name}_prefill", out, lse, q, x["kc"], x["vc"], lens + prompt, kw)
        lens = lens + prompt
        for q1, k1, v1 in x["steps"]:
            out, lse, _ = flash_attn_with_kvcache(q1, x["kc"], x["vc"], k1, v1, cache_seqlens=lens,
                                                  causal=True, return_softmax_lse=True,
                                                  kv_cache_layout="bhsd", **kw)
            held(f"{name}_steps", out, lse, q1, x["kc"], x["vc"], lens + 1, kw)
            lens = lens + 1
    tq, tk, tv, tdo = train
    out = flash_attn_func(tq, tk, tv, causal=True, window_size=GEMMA2_WINDOW,
                          softcap=GEMMA2_SOFTCAP, softmax_scale=gd**-0.5)
    out.backward(tdo)
    torch.cuda.synchronize()
    counts = read_counts()
    finite = all(bool(torch.isfinite(x.grad).all()) for x in (tq, tk, tv))
    log(f"  counted run (kvcache window and chunk: a {prompt}-token step and {steps} single-token "
        f"steps each; flash_attn_func forward + backward with Gemma-2's cap and window): "
        f"{counts}")
    log("  kvcache outputs against flash_attention_plain over the same cache: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f"; the capped gradients finite: "
        f"{finite}")
    check(finite, "flash_attn_func with Gemma-2's cap and window: a gradient is not finite")
    others = sum(n for name, n in counts.items()
                 if name.startswith(("flash_fwd", "flash_bwd")) and not name.endswith("window"))
    check(counts["flash_fwd_window"] == 3 + 2 * steps and counts["flash_bwd_window"] == 1
          and counts["flash_decode"] == 0 and others == 0,
          f"phase 16's counted run: expected {3 + 2 * steps} window launches of B1, 1 of B7 and "
          "no other B1 / B7 or decode-kernel launch")
    # Times: the prefill step (B1 with the window, the cache written in
    # place at the same positions each call) and a single-token step
    # without a window (all of each request's keys, on the decode kernel).
    x = data["window"]
    q, kn, vn = x["prefill"]
    stats = {"prior_lengths": prior.tolist(), "errors": errs}
    call = lambda: flash_attn_with_kvcache(q, x["kc"], x["vc"], kn, vn,  # noqa: E731
                                           cache_seqlens=prior, causal=True,
                                           kv_cache_layout="bhsd", window_size=MISTRAL_WINDOW)
    stats["prefill_ms"], _, stats["prefill_timer"] = device_ms(call)
    # B1's window instantiation alone on the step (the call also writes the
    # new keys into the cache and lays q out head-major).
    stats["prefill_kernel_ms"] = device_ms(lambda: flash_attention_masked(
        q.transpose(1, 2), x["kc"], x["vc"], kv_bound=prior + prompt, bound_causal=True,
        window=MISTRAL_WINDOW))[0]
    last = prior + prompt + steps - 1
    q1 = x["steps"][-1][0]
    stats["step_full_ms"], _, stats["step_timer"] = device_ms(
        lambda: flash_attn_with_kvcache(q1, x["kc"], x["vc"], cache_seqlens=last + 1,
                                        causal=True, kv_cache_layout="bhsd"))
    log(f"  kvcache at {b}x{h}/{hk}x{d} over a {cap}-slot cache (prior lengths "
        f"{prior.tolist()}): the {prompt}-token window step {stats['prefill_ms']:.4f} ms "
        f"({stats['prefill_timer']}; B1's kernel alone {stats['prefill_kernel_ms']:.4f} ms); a "
        f"single-token step without a window {stats['step_full_ms']:.4f} ms (the decode kernel)")
    # The single-token step with the window or the chunk: the API's route
    # (B1's window instantiation, as in JAX) beside the decode kernel over
    # the same keys, its first key the window's or the chunk's left edge
    # (``fold``: a pure left bound at position bound - 1), by device time and
    # by events over back-to-back calls (the host's share included),
    # alternated twice; the decode route's call with the fold's ops too.
    stats["single_token_routes"] = {}
    bound_t = last + 1
    for name, kw in forms:
        window, chunk = kw.get("window_size"), kw.get("attention_chunk", 0)

        def fold(window=window, chunk=chunk):
            if window is not None:
                return (bound_t - 1 - window[0]).clamp_min(0)
            return torch.div(bound_t - 1, chunk, rounding_mode="floor") * chunk

        api = lambda kw=kw: flash_attn_with_kvcache(  # noqa: E731
            q1, x["kc"], x["vc"], cache_seqlens=bound_t, causal=True, kv_cache_layout="bhsd",
            **kw)
        on_b8 = lambda lo=fold(): flash_attention_decode(  # noqa: E731
            q1.transpose(1, 2), x["kc"].transpose(1, 2), x["vc"].transpose(1, 2),
            kv_bound=bound_t, kv_low=lo, causal=True, num_splits=1)
        folded = lambda: on_b8(fold())  # noqa: E731
        err = (api().transpose(1, 2).float() - on_b8()[0].float()).abs().max().item()
        check(err < OUT_TOL, f"single-token {name} step: the two routes differ by {err:.3e}")
        r = {"b1_ms": device_ms(api)[0], "b8_ms": device_ms(on_b8)[0], "routes_err": err,
             "b1_call_ms": [], "b8_call_ms": [], "b8_with_fold_call_ms": []}
        for _ in range(2):
            r["b1_call_ms"].append(cuda_ms(api, reps=200))
            r["b8_call_ms"].append(cuda_ms(on_b8, reps=200))
            r["b8_with_fold_call_ms"].append(cuda_ms(folded, reps=200))
        stats["single_token_routes"][name] = r
        log(f"  single-token {name} step: the API on B1 {r['b1_ms']:.4f} ms device, "
            f"{r['b1_call_ms']} ms a call; the decode kernel over the same keys "
            f"{r['b8_ms']:.4f} ms device, {r['b8_call_ms']} ms a call "
            f"({r['b8_with_fold_call_ms']} with the fold's ops); outputs within {err:.3e}")
    # The kernel table's two kvcache rows: B1's window instantiation on the
    # API's steps (the 1024-token window step, and single-token steps with
    # the window and with the chunk) against its plain version, timed beside
    # its bound over the visible pairs and one PyTorch call of the same
    # function: SDPA with the band as a boolean mask over the cache
    # (FlexAttention takes no per-batch key bound).
    rows = stats["kvcache_rows"] = {}
    rows["window_step"] = check_channels(
        f"kvcache {prompt}-token window step {MISTRAL_WINDOW}, {b}x{h}/{hk}x{d} over {cap} slots",
        q.transpose(1, 2), x["kc"], x["vc"],
        dict(kv_bound=prior + prompt, bound_causal=True, window=MISTRAL_WINDOW), time_it=True)
    for name, kw in forms:
        xs = data[name]
        rows[f"single_token_{name}"] = check_channels(
            f"kvcache single-token {name} step, {b}x{h}/{hk}x{d} over {cap} slots",
            q1.transpose(1, 2), xs["kc"], xs["vc"],
            dict(kv_bound=bound_t, bound_causal=True, window=kw.get("window_size"),
                 attention_chunk=kw.get("attention_chunk", 0)), time_it=True)
    del data, train
    torch.cuda.empty_cache()
    return counts, stats


def window_phase(dev, card):
    """Phase 16: B1's window, attention_chunk and softcap channels and B7's
    window and softcap channels at Mistral-7B's, Gemma-2's (cap and window) and
    Llama-4-Scout's attention settings, the kvcache API with them, and the
    D 64 forms at GPT-2 small's attention."""
    t0 = time.perf_counter()
    log(f"  (a)-(c), (e) the window / chunk / softcap kernels against their plain versions "
        f"[{card}]")
    kres, stats = window_kernel_phase(dev)
    secs = {"kernels": time.perf_counter() - t0}
    log(f"  (d) the kvcache API with window and chunk, and the counted run ((a)-(e) took "
        f"{secs['kernels']:.1f} s)")
    counts, stats["kvcache"] = window_serve_run(dev)
    shapes = kres["flash_fwd_window"]["shapes"]
    shapes.update({f"kvcache_{n}": r for n, r in stats["kvcache"]["kvcache_rows"].items()})
    kres["flash_fwd_window"]["err"] = max(r["err"] for r in shapes.values())
    secs["kvcache"] = time.perf_counter() - t0 - secs["kernels"]
    stats["part_seconds"] = secs
    return counts, kres, stats


# ---------------------------------------------------------------- phase 17

# configs/experiment/gpt2s-moe.yaml at GPT-2 small's published width and
# depth (openai-community/gpt2 config.json: n_embd 768, n_layer 12, n_head
# 12, vocab 50 257, n_positions 1024): 4 experts, top-2, capacity factor
# 1.25, 8 x 1024 = 8192 tokens a layer.
MOE_OVERRIDES = ["experiment=gpt2s-moe", "model.dim=768", "model.num_layers=12",
                 "model.num_heads=12", "model.vocab=50257", "run.seqlen=1024", "run.batch_size=8",
                 "run.steps=12", "optimizer.warmup_steps=2"]
MOE_LAYER_TOL = 2e-2  # rel-L2 of a bf16 MoE layer (fp32 router) against the layer in fp32
ROUTER_FP32_TOL = 1e-5  # rel-L2 of the router's fp32 probabilities against fp64 (TF32: ~1e-3)


def moe_layer_check(layer, x):
    """One MoE layer on the card as the model runs it (bf16 activations and
    experts, the fp32 router) against the same layer in fp32 on the same
    input: the routing (experts, gates, positions, drops) identical, the
    router's probabilities within ROUTER_FP32_TOL of fp64 (true fp32, no
    TF32), the output within MOE_LAYER_TOL."""
    import torch
    from liteattention_torch.modules.moe import _route_indices, capacity_for, moe_forward

    params = {k: v.detach() for k, v in layer.moe.items()}
    p32 = {k: v.float() for k, v in params.items()}
    e = params["router"].shape[1]
    cap = capacity_for(x.shape[0], e, layer.top_k, layer.capacity_factor)
    with torch.no_grad():
        y16, _ = moe_forward(params, x, layer.top_k, capacity=cap)
        y32, _ = moe_forward(p32, x.float(), layer.top_k, capacity=cap)
        r16 = _route_indices(x, params["router"], layer.top_k, cap)
        r32 = _route_indices(x.float(), p32["router"], layer.top_k, cap)
        p64 = torch.softmax(x.double() @ params["router"].double(), dim=-1)
    same = all(torch.equal(a, b) for a, b in zip(r16[1:5], r32[1:5]))
    e_router = rel_l2(r16[0], p64)
    e_out = rel_l2(y16.float(), y32)
    dropped = 1.0 - r16[4].float().mean().item()
    log(f"  one MoE layer (block 0's, its input from the trained model: {tuple(x.shape)} bf16, "
        f"capacity {cap}): bf16 experts vs fp32 on the same input: routing identical {same}, "
        f"router probabilities vs fp64 rel-L2 {e_router:.2e} (limit {ROUTER_FP32_TOL}), output "
        f"rel-L2 {e_out:.2e} (limit {MOE_LAYER_TOL}), (token, slot) pairs dropped {dropped:.4f}")
    check(same, "MoE layer: bf16 and fp32 route differently")
    check(e_router < ROUTER_FP32_TOL, "MoE layer: the router does not run in true fp32")
    check(e_out < MOE_LAYER_TOL, "MoE layer: the bf16 layer disagrees with fp32")
    return {"routing_identical": same, "router_rel_l2_vs_fp64": e_router,
            "output_rel_l2_vs_fp32": e_out, "dropped_share": dropped, "capacity": cap}


def moe_causality_check(model, dev):
    """check_causal on the trained model's trunk (blocks and final norm on
    float inputs, the embedding skipped) with a capacity that drops no token
    (factor 4: 40 slots an expert for 2 x 10 tokens). Whether a dropping
    capacity leaks is settled on the CPU against JAX
    (tests/test_torch_moe.py)."""
    import torch
    from liteattention_torch.modules.moe import MoEMlp
    from liteattention_torch.ops.norms import layer_norm
    from liteattention_torch.training.diagnostics import causality_leakage

    t, cfg = model.transformer, model.cfg
    moes = [m for m in model.modules() if isinstance(m, MoEMlp)]
    saved = [m.capacity_factor for m in moes]

    def trunk(x):
        h, res = x.to(cfg.dtype), None
        for blk in t.blocks:
            h, res = blk(h, res)
        return layer_norm((h.float() + res).to(cfg.dtype), t.ln_f_scale, t.ln_f_bias,
                          eps=cfg.eps)

    try:
        for m in moes:
            m.capacity_factor = 4.0
        leak = causality_leakage(trunk, seq_len=10, input_dim=cfg.dim, device=dev)
        dropped = max(float(m.dropped) for m in moes)
    finally:
        for m, f in zip(moes, saved):
            m.capacity_factor = f
    worst = leak.max().item()
    log(f"  check_causal on the trained model's trunk (2 x 10 tokens, capacity factor 4, dropped "
        f"{dropped:.4f}): the largest future-gradient leak {worst:.3e}")
    check(dropped == 0.0 and worst < 1e-6, "the MoE GPT leaks gradient from the future")
    return {"max_leak": worst, "dropped": dropped}


def moe_phase(dev, card):
    """Phase 17: the config-tree trainer on configs/experiment/gpt2s-moe.yaml
    at GPT-2 small's width and depth, through ``liteattention_torch.train.
    run`` (the counted path), then one MoE layer against fp32 and the
    causality monitor."""
    import torch
    from liteattention_torch import train as train_cli
    from liteattention_torch.modules.moe import MoEMlp
    from liteattention_torch.training.config_tree import load_config

    root = str(ROOT / "configs" / "config.yaml")
    tree = load_config(root, MOE_OVERRIDES)
    log(f"  composed tree: {json.dumps(tree, sort_keys=True)}")
    argv = ["--config", root, *MOE_OVERRIDES, "--device", "cuda", "--log-every", "1",
            "--overfit-batch"]
    log(f"  python -m liteattention_torch.train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = []
    reset_counts()
    trainer = train_cli.run(argv, log_fn=recs.append)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    model, cfg, steps = trainer.model, trainer.model.cfg, tree["run"]["steps"]
    check(cfg.moe_experts == 4 and cfg.moe_top_k == 2 and cfg.moe_capacity_factor == 1.25
          and cfg.dim == 768 and cfg.num_layers == 12,
          f"the composed tree did not reach the model: {cfg}")
    log(f"  launches during the training run: {counts}")
    want = cfg.num_layers * steps
    others = sum(n for name, n in counts.items()
                 if name.startswith(("flash_fwd", "flash_bwd"))
                 and name not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    check(counts["flash_fwd"] == want and counts["flash_bwd_dq"] == want and others == 0,
          f"MoE training: expected {cfg.num_layers} causal B1 and {cfg.num_layers} B7 launches a "
          f"step ({want} over {steps} steps) and no other B1 / B7 launch")
    losses = [r["loss"] for r in recs]
    moes = [m for m in model.modules() if isinstance(m, MoEMlp)]
    aux = sum(float(m.aux_loss.detach()) for m in moes)
    dropped = [float(m.dropped) for m in moes]
    step_ms = [1e3 / r["steps_per_s"] for r in recs]
    ms = statistics.median(step_ms[2:])
    tokens = tree["run"]["batch_size"] * tree["run"]["seqlen"]
    log(f"  loss per step {[round(v, 4) for v in losses]}; the last step's aux loss (sum over "
        f"{len(moes)} layers) {aux:.4f}; (token, slot) pairs dropped per layer "
        f"{[round(v, 4) for v in dropped]} (capacity {moes[0].capacity} of {tokens} tokens x 2 "
        f"slots over 4 experts)")
    log(f"  ms/step {ms:.1f} (median of steps 3-{steps}; first two {step_ms[0]:.1f}, "
        f"{step_ms[1]:.1f}), {tokens / ms * 1e3:.0f} tokens/s, {want // steps} B1 and "
        f"{want // steps} B7 launches a step, peak memory {peak:.2f} GB [{card}]")
    check(all(math.isfinite(v) for v in losses), "MoE training: a loss is not finite")
    check(losses[-1] < losses[0], "MoE training: the loss does not fall")
    check(math.isfinite(aux) and aux > 0, "MoE training: the aux loss is not finite")
    stats = {"losses": losses, "ms_per_step": step_ms, "median_ms_per_step": ms,
             "tokens_per_s": tokens / ms * 1e3, "peak_gb": peak, "aux_loss_last_step": aux,
             "dropped_share_per_layer": dropped, "capacity": moes[0].capacity,
             "launches_per_step": {"flash_fwd": want // steps, "flash_bwd": want // steps},
             "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6}
    # One more step on the training batch (the CLI's first synthetic batch),
    # counted alone: a step's launches.
    from liteattention_torch.training.data import synthetic_lm_batches

    ids = torch.as_tensor(next(synthetic_lm_batches(cfg.vocab_size, tree["run"]["batch_size"],
                                                    tree["run"]["seqlen"])), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    trainer.train_step(ids)
    torch.cuda.synchronize()
    one = read_counts()
    log(f"  one more step, counted alone: {one['flash_fwd']} B1 and {one['flash_bwd_dq']} B7 "
        "launches")
    check(one["flash_fwd"] == cfg.num_layers and one["flash_bwd_dq"] == cfg.num_layers,
          f"MoE training: a step should launch B1 and B7 {cfg.num_layers} times each")
    stats["launches_one_step"] = {"flash_fwd": one["flash_fwd"], "flash_bwd": one["flash_bwd_dq"]}
    # Block 0's MoE input on that batch, captured by a hook.
    seen = []
    hook = moes[0].register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
    with torch.no_grad():
        model(ids)
    hook.remove()
    stats["moe_layer"] = moe_layer_check(moes[0], seen[0].reshape(-1, cfg.dim))
    stats["causality"] = moe_causality_check(model, dev)
    del trainer, model, seen
    torch.cuda.empty_cache()
    return counts, stats


# ---------------------------------------------------------------- phase 18

VIT_BATCH = 64  # images of 224 x 224 x 3 (NHWC)
VIT_SEED = 1818


class plain_attention:
    """While open, MHA's attention runs the plain fp32 version
    (``flash_attention_plain``: torch ops, differentiable through autograd)
    instead of B1 / B7: the reference path of a model check on the card."""

    def __enter__(self):
        from liteattention_torch.modules import mha
        from liteattention_torch.ops.flash_fwd import flash_attention_plain

        self.module, self.saved = mha, mha.flash_attention_masked

        def plain(q, k, v, alibi_slopes=None, scale=None, causal=False, dropout_p=0.0,
                  dropout_seed=None, **kw):
            check(alibi_slopes is None and dropout_p == 0.0 and not kw,
                  "plain_attention: channels are not taken here")
            return flash_attention_plain(q.float(), k.float(), v.float(), scale=scale,
                                         causal=causal)[0].to(q.dtype)

        mha.flash_attention_masked = plain
        return self

    def __exit__(self, *exc):
        self.module.flash_attention_masked = self.saved
        return False


def vit_phase(dev, card):
    """Phase 18: ViT-B/16 (``ViTConfig()``: 224 x 224, patch 16, 768 / 12 /
    12, ffn 3072, bf16): (a) B1 and B7 at its attention, 64 x 12 x 197 x 64
    non-causal (a ragged last tile of 69 rows and keys), against their plain
    versions and timed; (b) a forward of 64 NHWC images and one AdamW step
    on random labels (the counted path: 12 B1 and 12 B7 launches), the
    logits and the first block's gradients against the same weights with
    the plain attention in fp32; the forward timed by
    ``utils/benchmark.py:benchmark_forward``, the step by CUDA events."""
    import torch
    import torch.nn.functional as F
    from liteattention_torch.models.vit import ViTConfig, VisionTransformer
    from liteattention_torch.utils.benchmark import benchmark_forward, benchmark_memory

    cfg = ViTConfig()
    b, n, h, d = VIT_BATCH, cfg.num_tokens, cfg.num_heads, cfg.dim // cfg.num_heads
    g = torch.Generator(device=dev).manual_seed(VIT_SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    label = f"ViT-B/16 {b}x{h}x{n}x{d} non-causal"
    q, k, v, dout = (rnd(b, h, n, d) for _ in range(4))
    kres = {"fwd": check_flash(q, k, v, label, causal=False, time_it=True, blocks=True),
            "bwd": check_bwd(q, k, v, dout, label, False, time_it=True)}
    del q, k, v, dout
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = VisionTransformer(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(VIT_SEED + 1))
    ref = VisionTransformer(dataclasses.replace(cfg, dtype=torch.float32), device=dev)
    ref.load_state_dict(model.state_dict())
    h_img, w_img = cfg.image_size
    images = torch.randn(b, h_img, w_img, cfg.in_chans, generator=g, device=dev)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=g, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  ViT-B/16: {n_params / 1e6:.1f} M parameters (fp32 master, bf16 products), {b} images "
        f"{h_img} x {w_img} x {cfg.in_chans} NHWC, {n} tokens, random labels")
    with plain_attention():
        ref_logits = ref(images)
        F.cross_entropy(ref_logits, labels).backward()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
    torch.cuda.synchronize()
    reset_counts()
    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches during the counted step (forward, backward, AdamW): {counts}")
    others = sum(c for name, c in counts.items() if name.startswith(("flash_fwd", "flash_bwd"))
                 and name not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    check(counts["flash_fwd"] == cfg.num_layers and counts["flash_bwd_dq"] == cfg.num_layers
          and others == 0, f"ViT: expected {cfg.num_layers} B1 and {cfg.num_layers} B7 launches "
          "and no other B1 / B7 launch")
    e_fwd = rel_l2(logits.detach().float(), ref_logits.detach())
    ref_grads = dict(ref.named_parameters())
    e_grad = {name: rel_l2(p.grad.float(), ref_grads[name].grad)
              for name, p in model.named_parameters() if name.startswith("blocks.0.")}
    worst = max(e_grad, key=e_grad.get)
    log(f"  bf16 kernels vs fp32 plain attention, same weights: logits rel-L2 {e_fwd:.2e} "
        f"(limit {SMALL_FWD_TOL}), loss {loss.item():.4f}; first block's gradients worst rel-L2 "
        f"{e_grad[worst]:.2e} ({worst}; limit {SMALL_GRAD_TOL})")
    check(torch.isfinite(logits).all() and logits.shape == (b, cfg.num_classes),
          "ViT: bad logits")
    check(e_fwd < SMALL_FWD_TOL, "ViT: logits disagree with the plain fp32 path")
    check(e_grad[worst] < SMALL_GRAD_TOL, "ViT: the first block's gradients disagree")
    del ref, ref_logits, ref_grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    with torch.no_grad():
        fwd_s, fwd_std = benchmark_forward(model, images, repeats=10, warmup=2, verbose=False)
        fwd_peak = benchmark_memory(model, images)

    def step():
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(model(images), labels).backward()
        opt.step()

    step()
    step_ms = cuda_ms(step, reps=5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  forward {fwd_s * 1e3:.2f} ms (+/- {fwd_std * 1e3:.2f}; benchmark_forward, CUDA events) "
        f"= {b / fwd_s:.0f} images/s, peak {fwd_peak / 1e9:.2f} GB (benchmark_memory); training "
        f"step {step_ms:.2f} ms = {b / step_ms * 1e3:.0f} images/s; peak memory {peak:.2f} GB "
        f"[{card}]")
    stats = {"forward_ms": fwd_s * 1e3, "forward_std_ms": fwd_std * 1e3,
             "forward_peak_gb": fwd_peak / 1e9, "step_ms": step_ms, "peak_gb": peak,
             "logits_rel_l2": e_fwd, "first_block_worst_grad_rel_l2": e_grad[worst],
             "parameters_m": n_params / 1e6, "tokens": n}
    stats["attention_share_by_kernel_times"] = cfg.num_layers * (
        kres["fwd"]["ms"] + kres["bwd"]["flash_bwd_dq"]["ms"]) / step_ms
    log(f"  attention kernels' share of the step by their times in (a): "
        f"{stats['attention_share_by_kernel_times']:.1%}")
    del model, opt, images
    torch.cuda.empty_cache()
    return counts, kres, stats


# ---------------------------------------------------------------- phase 19

# Falcon-7B (tiiuae/falcon-7b config.json: hidden_size 4544, 32 layers, 71
# heads of 64, multi_query, parallel_attn, vocab 65 024) through
# falcon_config(); 8 requests of 512 prompt tokens, 32 greedy tokens each.
FALCON_BATCH, FALCON_PROMPT, FALCON_NEW = 8, 512, 32
FALCON_CONTEXT = FALCON_PROMPT + FALCON_NEW
FALCON_SEED = 1919


def falcon_kernel_phase(dev):
    """Phase 19 (a): B1 and the decode kernel at Falcon-7B's group of 71 q
    heads on one KV head (D 64): the prefill's bound_causal B1 over the
    serving cache and single-token decode steps over it (ragged and full
    lengths), against their plain versions, timed beside their bounds and
    SDPA (``enable_gqa``; a boolean mask for the bound)."""
    import torch
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
    )

    g = torch.Generator(device=dev).manual_seed(FALCON_SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    b, h, d, cap = FALCON_BATCH, 71, 64, FALCON_CONTEXT
    kc, vc = rnd(b, 1, cap, d), rnd(b, 1, cap, d)
    prompt = torch.full((b,), FALCON_PROMPT, dtype=torch.int32, device=dev)
    res = {"fwd_bound": check_channels(
        f"bound_causal prefill {b}x{h}/1x{FALCON_PROMPT}x{d} over a {cap}-slot cache (Falcon-7B)",
        rnd(b, h, FALCON_PROMPT, d), kc, vc, dict(kv_bound=prompt, bound_causal=True),
        time_it=True)}
    q = rnd(b, h, 1, d)
    lens = torch.randint(FALCON_PROMPT + 1, cap + 1, (b,), generator=g, device=dev).int()
    res["decode"] = decode_row(
        f"B8 bf16 {b}x{h}/1 rows of {d} (71 rows packed over one KV head), cache {cap}, lengths "
        f"{lens.min().item()}-{lens.max().item()}", flash_attention_decode,
        flash_attention_decode_plain, q, kc, vc, lens, cap)
    del kc, vc
    torch.cuda.empty_cache()
    return res


def falcon_hf_state_dict(cfg, dev, seed):
    """An HF-named Falcon-7B state dict (``FalconForCausalLM``'s keys) of
    random bf16 tensors on the card from ``seed``: ``query_key_value``
    grouped as (kv heads, group + 2, head dim) rows, N(0, 1 / fan_in)
    weights, unit norm scales, zero norm biases."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def w(out_f, in_f):
        return (torch.randn(out_f, in_f, generator=g, device=dev, dtype=torch.bfloat16)
                * in_f**-0.5)

    dim, h = cfg.dim, cfg.num_heads
    hk, hd = cfg.num_heads_kv, cfg.dim // cfg.num_heads
    ffn = cfg.ffn_dim or 4 * dim
    ones = lambda: torch.ones(dim, device=dev, dtype=torch.bfloat16)  # noqa: E731
    zeros = lambda: torch.zeros(dim, device=dev, dtype=torch.bfloat16)  # noqa: E731
    sd = {"transformer.word_embeddings.weight": w(cfg.vocab_size, dim),
          "transformer.ln_f.weight": ones(), "transformer.ln_f.bias": zeros()}
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        sd[pre + "self_attention.query_key_value.weight"] = w(hk * (h // hk + 2) * hd, dim)
        sd[pre + "self_attention.dense.weight"] = w(dim, h * hd)
        sd[pre + "mlp.dense_h_to_4h.weight"] = w(ffn, dim)
        sd[pre + "mlp.dense_4h_to_h.weight"] = w(dim, ffn)
        sd[pre + "input_layernorm.weight"] = ones()
        sd[pre + "input_layernorm.bias"] = zeros()
    return sd


def falcon_serve_phase(dev, card):
    """Phase 19 (b): Falcon-7B at full width and depth from an HF-named state
    dict through ``remap_state_dict_hf_falcon`` (the checkpoint built on the
    card in bf16: the one extra copy of the weights beside the model's fp32
    parameters), serving FALCON_BATCH requests (the counted path: greedy
    decoding into a bf16 cache), the step logits against a full recompute."""
    import torch
    from liteattention_torch.models.configs import falcon_config
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import greedy_decode
    from liteattention_torch.utils.pretrained import remap_state_dict_hf_falcon

    cfg = falcon_config()
    h, hk, hd = cfg.num_heads, cfg.num_heads_kv, cfg.dim // cfg.num_heads
    log(f"  Falcon-7B: dim {cfg.dim}, {cfg.num_layers} layers, {h} heads x {hd} on {hk} KV head, "
        f"rotary, tied-norm parallel block, ffn {4 * cfg.dim}, vocab {cfg.vocab_size}, no linear "
        "biases, tied embeddings; fp32 master weights, bf16 compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device=dev)
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    hf = falcon_hf_state_dict(cfg, dev, FALCON_SEED + 1)
    sd = remap_state_dict_hf_falcon(hf, cfg)
    model.load_state_dict(sd)
    # The remap's grouping on the card: q head j of the one group is rows
    # [j hd, (j + 1) hd) of query_key_value, k the group's next-to-last slot.
    qkv = hf["transformer.h.0.self_attention.query_key_value.weight"]
    wqkv = model.transformer.blocks[0].mha.Wqkv.weight
    check(torch.equal(wqkv[: h * hd], qkv[: h * hd].float())
          and torch.equal(wqkv[h * hd : (h + 1) * hd], qkv[h * hd : (h + 1) * hd].float())
          and torch.equal(wqkv[(h + 1) * hd :], qkv[(h + 1) * hd :].float()),
          "Falcon remap: Wqkv is not q | k | v of the grouped query_key_value")
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    del hf, sd, qkv
    torch.cuda.empty_cache()
    log(f"  {n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.1f} GB fp32); the HF-named "
        f"checkpoint built in bf16 on the card, remapped and loaded in {load_s:.1f} s (peak "
        f"{load_peak:.2f} GB); {FALCON_BATCH} requests x {FALCON_PROMPT} prompt tokens, "
        f"{FALCON_NEW} new tokens each, cache capacity {FALCON_CONTEXT}")
    g = torch.Generator(device=dev).manual_seed(FALCON_SEED + 2)
    ids = torch.randint(0, cfg.vocab_size, (FALCON_BATCH, FALCON_PROMPT), generator=g, device=dev)
    greedy_decode(model, ids[:1, :16], 2, 32)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    timer = StepTimer(model)
    toks = greedy_decode(timer, ids, FALCON_NEW, FALCON_CONTEXT)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the Falcon serving run: {counts}")
    n_decode = len(timer.calls) - 1
    want_b1, want_b8 = cfg.num_layers, cfg.num_layers * n_decode
    check(counts["flash_fwd_bound"] == want_b1 and counts["flash_decode"] == want_b8,
          f"Falcon serving: expected {want_b1} bound B1 launches (the prefill) and {want_b8} "
          "decode-kernel launches (one a layer a step)")
    prefill_ms = timer.calls[0][1]
    step_ms = [ms for _, ms in timer.calls[1:]]
    dec_ms = statistics.median(step_ms)
    with torch.inference_mode():
        full = torch.cat([model(toks[i : i + 1, :-1])[:, FALCON_PROMPT - 1 :].clone()
                          for i in range(FALCON_BATCH)])
    step_logits = timer.logits()
    check(toks.shape == (FALCON_BATCH, FALCON_CONTEXT) and torch.isfinite(step_logits).all(),
          "Falcon serving: bad greedy output")
    e_full = rel_l2(step_logits, full)
    agree = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    log(f"  prefill {prefill_ms:.1f} ms ({FALCON_BATCH * FALCON_PROMPT / prefill_ms * 1e3:.0f} "
        f"prompt tokens/s), decode {dec_ms:.2f} ms/step (median of {n_decode}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) = {FALCON_BATCH * 1e3 / dec_ms:.0f} "
        f"tokens/s; end to end {wall:.0f} ms; peak memory {peak:.2f} GB [{card}]")
    log(f"  incremental decode vs full recompute without a cache: logits rel-L2 {e_full:.3e} "
        f"(limit {SERVE_RECOMPUTE_TOL}), argmax agreement {agree:.3f}")
    check(e_full < SERVE_RECOMPUTE_TOL, "Falcon incremental decode disagrees with the recompute")
    stats = {"prefill_ms": prefill_ms, "decode_ms_per_step": dec_ms, "decode_ms": step_ms,
             "decode_tokens_per_s": FALCON_BATCH * 1e3 / dec_ms,
             "end_to_end_tokens_per_s": FALCON_BATCH * FALCON_NEW * 1e3 / wall, "peak_gb": peak,
             "load_peak_gb": load_peak, "load_s": load_s, "recompute_rel_l2": e_full,
             "recompute_argmax_agreement": agree, "parameters_b": n_params / 1e9,
             "decode_steps": n_decode, "layers": cfg.num_layers}
    del model, timer, full, step_logits
    torch.cuda.empty_cache()
    return counts, stats


def falcon_phase(dev, card):
    """Phase 19: B1 and the decode kernel at Falcon-7B's 71:1 group, then
    Falcon-7B served at full width and depth from a remapped HF state dict."""
    t0 = time.perf_counter()
    log(f"  (a) B1 and the decode kernel at Falcon-7B's group of 71 [{card}]")
    kres = falcon_kernel_phase(dev)
    secs = {"a": time.perf_counter() - t0}
    log(f"  (b) Falcon-7B serving ((a) took {secs['a']:.1f} s)")
    counts, stats = falcon_serve_phase(dev, card)
    secs["b"] = time.perf_counter() - t0 - secs["a"]
    stats["part_seconds"] = secs
    stats["prefill_b1_share_by_kernel_times"] = (
        stats["layers"] * kres["fwd_bound"]["ms"] / stats["prefill_ms"])
    log(f"  (b) took {secs['b']:.1f} s; B1's share of the prefill by its time in (a): "
        f"{stats['prefill_b1_share_by_kernel_times']:.1%}")
    return counts, kres, stats


# ---------------------------------------------------------------- phase 20

# Phase 20 (a): a continuous batch at Llama-3-8B's attention (32 q heads on
# 8 KV heads of 128, bf16; meta-llama/Meta-Llama-3-8B config.json: rope_theta
# 500 000) over a pool of 16 slots of 8192 tokens (K and V 0.54 GB), 8 of them
# live; each step packs two prefill chunks and six single tokens.
KVR = dict(slots=16, capacity=8192, heads=32, kv_heads=8, d=128, live=8, steps=8,
           chunk=(512, 2048), prior=(0, 6000), decode_steps=4, page=256, theta=500000.0)
KVR_WINDOW = (4095, 0)
# (b) the non-absorbed (192, 128) step: batch, new rows, cache slots, prior lengths.
MLA_BOUND_STEP = (2, 1024, 4096, (1500, 3000))
# rel-L2 of int8_mma against the exact dequant path (JAX tests/test_kv_quant.py).
INT8_MMA_TOL = 8e-2
INPLACE_SLACK = 64 << 20  # bytes a decode step may allocate beside the pool (a gather: 268 MB)
TIMED_STEPS = 3  # packed steps timed beside their sequences alone (the padding's cost)


def llama3_rotary(dev, n, d, theta):
    """Rotary tables ``[n, d / 2]`` fp32 at base ``theta`` over all ``d``
    features (the angles of the half-split layout)."""
    import torch

    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=dev, dtype=torch.float64) / d)
    ang = torch.arange(n, device=dev, dtype=torch.float64)[:, None] * inv[None]
    return ang.cos().float(), ang.sin().float()


def mixed_steps(dev, rnd, pick, lens, steps):
    """``steps`` packed steps over sequences at lengths ``lens`` (a list,
    advanced in place): the two shortest take a prefill chunk of
    ``KVR["chunk"]`` tokens, the others one token. Each step: packed q, k,
    v, cu_seqlens, the prior lengths, the q lengths and the longest."""
    import torch

    cfg, out = KVR, []
    for _ in range(steps):
        short = sorted(range(len(lens)), key=lambda i: lens[i])[:2]
        qlen = [pick.randint(*cfg["chunk"]) if i in short else 1 for i in range(len(lens))]
        total = sum(qlen)
        cu = torch.tensor([0] + list(itertools.accumulate(qlen)), dtype=torch.int32, device=dev)
        out.append(dict(q=rnd(total, cfg["heads"], cfg["d"]),
                        k=rnd(total, cfg["kv_heads"], cfg["d"]),
                        v=rnd(total, cfg["kv_heads"], cfg["d"]), cu=cu, qlen=qlen, maxq=max(qlen),
                        lens=torch.tensor(lens, dtype=torch.int32, device=dev)))
        for i, n in enumerate(qlen):
            lens[i] += n
        check(max(lens) <= cfg["capacity"], "phase 20: a sequence outgrew its slot")
    return out


def api_step(st, kc, vc, rot, **kw):
    """One packed step through flash_attn_with_kvcache (causal, Llama-3's
    rotary, half-split): (out ``[total, H, D]``, lse ``[H, total]``)."""
    from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache

    out, lse, _ = flash_attn_with_kvcache(
        st["q"], kc, vc, st["k"], st["v"], rotary_cos=rot[0], rotary_sin=rot[1],
        cache_seqlens=st["lens"], cu_seqlens_q=st["cu"], cu_seqlens_k_new=st["cu"],
        max_seqlen_q=st["maxq"], max_seqlen_k_new=st["maxq"], causal=True,
        rotary_interleaved=False, return_softmax_lse=True, **kw)
    return out, lse


def one_sequence(st, i):
    """Sequence ``i`` of a packed step as a packed step of its own."""
    import torch

    a, z = (int(x) for x in st["cu"][i:i + 2])
    return dict(q=st["q"][a:z], k=st["k"][a:z], v=st["v"][a:z], qlen=[z - a], maxq=z - a,
                cu=torch.tensor([0, z - a], dtype=torch.int32, device=st["q"].device),
                lens=st["lens"][i:i + 1]), (a, z)


def held_plain(label, st, out, lse, slot_kv, rot, window=None):
    """A packed step's rows against ``flash_attention_plain`` sequence by
    sequence: q rotated at its positions, over the sequence's K and V
    (``slot_kv(i)``: ``[1, Hk, S, D]`` each), bottom-right causal at its
    new length (and ``window``). out within OUT_TOL of max(1, |plain|), lse
    within LSE_TOL."""
    import torch
    from liteattention_torch.flash_attn_interface import _rotate
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    err = err_l = 0.0
    for i in range(len(st["qlen"])):
        sub, (a, z) = one_sequence(st, i)
        prior = int(sub["lens"][0])
        pos = torch.arange(prior, prior + z - a, device=out.device)[None]
        qr = _rotate(sub["q"][None], rot[0], rot[1], pos, False)
        kc, vc = slot_kv(i)
        ro, rl = flash_attention_plain(qr.transpose(1, 2), kc, vc, kv_bound=sub["lens"] + (z - a),
                                       bound_causal=True, window=window)
        got = out[a:z].transpose(0, 1)[None].float()
        err = max(err, ((got - ro.float()).abs() / ro.float().abs().clamp_min(1.0)).max().item())
        err_l = max(err_l, (lse[:, a:z][None] - rl).abs().max().item())
    log(f"  {label}: against flash_attention_plain sequence by sequence: max|out| err {err:.3e} "
        f"(over max(1, |plain|)), max|lse| err {err_l:.3e}")
    check(err < OUT_TOL and err_l < LSE_TOL, f"phase 20 {label} disagrees with the plain version")
    return err


def alone_check(st, out, lse, call, time_it):
    """The step's sequences one by one through the API (``call(sub, i)``;
    their appends rewrite the same rows): rows within DECODE_TOL and
    rel-L2 DECODE_REL_TOL of the packed call's. Returns (max abs error,
    rel-L2, with ``time_it`` the calls' device time summed, else None)."""
    import torch

    subs = [one_sequence(st, i) for i in range(len(st["qlen"]))]
    got, ref, err = [], [], 0.0
    for i, (sub, (a, z)) in enumerate(subs):
        o, l1 = call(sub, i)
        got.append(out[a:z].float())
        ref.append(o.float())
        err = max(err, (out[a:z].float() - o.float()).abs().max().item(),
                  (lse[:, a:z] - l1).abs().max().item())
    rel = rel_l2(torch.cat(got), torch.cat(ref))
    check(err < DECODE_TOL and rel < DECODE_REL_TOL,
          f"phase 20: a packed step differs from its sequences alone ({err:.3e}, {rel:.2e})")
    if not time_it:
        return err, rel, None
    ms = sum(device_ms(lambda sub=sub, i=i: call(sub, i), reps=10)[0]
             for i, (sub, _) in enumerate(subs))
    return err, rel, ms


def step_need(st, hk, d, elsize=2):
    """(bytes, flops) a packed step needs: each sequence's K and V rows to
    its new length read once, the new rows written, q / out / lse; QK and
    P V over its visible pairs (no padding)."""
    nbytes_, flops = 0, 0
    h = KVR["heads"]
    for prior, n in zip(st["lens"].tolist(), st["qlen"]):
        keys = prior + n
        nbytes_ += 2 * keys * hk * d * elsize + 2 * n * hk * d * elsize
        nbytes_ += n * h * (2 * d * elsize + 4)
        flops += 4 * d * h * sum(prior + r + 1 for r in range(n))
    return nbytes_, flops


def continuous_batch_inputs(dev):
    """Phase 20 (a)'s pool, slots, rotary tables and steps (made before the
    counted run)."""
    import random

    import torch

    cfg = KVR
    g = torch.Generator(device=dev).manual_seed(2020)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    pick = random.Random(20)
    x = {"kc": rnd(cfg["slots"], cfg["capacity"], cfg["kv_heads"], cfg["d"]),
         "vc": rnd(cfg["slots"], cfg["capacity"], cfg["kv_heads"], cfg["d"])}
    slots = torch.randperm(cfg["slots"], generator=torch.Generator().manual_seed(21))
    x["idx"] = slots[: cfg["live"]].to(dev, torch.int32)
    x["idle"] = slots[cfg["live"]:].to(dev)
    x["idle_k"], x["idle_v"] = x["kc"][x["idle"]].clone(), x["vc"][x["idle"]].clone()
    x["rot"] = llama3_rotary(dev, cfg["capacity"], cfg["d"], cfg["theta"])
    lo, hi = cfg["prior"]
    lens = [lo + (hi - lo) * i // (cfg["live"] - 1) for i in range(cfg["live"])]
    pick.shuffle(lens)
    x["steps"] = mixed_steps(dev, rnd, pick, lens, cfg["steps"])
    x["decode"] = []
    for _ in range(cfg["decode_steps"]):
        x["decode"].append(dict(q=rnd(cfg["live"], 1, cfg["heads"], cfg["d"]),
                                k=rnd(cfg["live"], 1, cfg["kv_heads"], cfg["d"]),
                                v=rnd(cfg["live"], 1, cfg["kv_heads"], cfg["d"]),
                                lens=torch.tensor(lens, dtype=torch.int32, device=dev)))
        lens = [n + 1 for n in lens]
    x["window"] = mixed_steps(dev, rnd, pick, lens, 1)[0]
    # The paged step: its own pool of 256-token pages (8 sequences' worth,
    # a shuffled table) and prior lengths.
    n_pages = cfg["live"] * cfg["capacity"] // cfg["page"]
    x["kp"] = rnd(n_pages, cfg["page"], cfg["kv_heads"], cfg["d"])
    x["vp"] = rnd(n_pages, cfg["page"], cfg["kv_heads"], cfg["d"])
    x["table"] = torch.randperm(n_pages, generator=g, device=dev).reshape(cfg["live"], -1).int()
    plens = [pick.randint(lo, hi) for _ in range(cfg["live"])]
    x["paged"] = mixed_steps(dev, rnd, pick, plens, 1)[0]
    return x


def mla_step_inputs(dev):
    """Phase 20 (b)'s inputs: DeepSeek-V3's absorbed decode (rope 64 and
    latent 512 caches, 128 heads, batch 64, ragged lengths; the same as a
    576 latent cache beside a 512 V cache) and the non-absorbed (192, 128)
    step over a head-major cache."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2022)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    b, s, h = MLA_BATCH, MLA_MAX_LEN, MLA_HEADS
    x = {"q": rnd(b, 1, h, MLA_ROPE), "qv": rnd(b, 1, h, MLA_DV), "kc": rnd(b, s, 1, MLA_ROPE),
         "vc": rnd(b, s, 1, MLA_DV)}
    x["lens"] = torch.randint(MLA_MIN_LEN, s + 1, (b,), generator=g, device=dev).int()
    x["latent"] = torch.cat([x["vc"], x["kc"]], dim=-1)  # [v 512 | rope 64]
    x["q576"] = torch.cat([x["qv"], x["q"]], dim=-1)
    nb, new, cap, (lo, hi) = MLA_BOUND_STEP
    x["nq"], x["nk"] = rnd(nb, new, h, MLA_QK), rnd(nb, new, h, MLA_QK)
    x["nv"] = rnd(nb, new, h, MLA_V)
    x["nkc"], x["nvc"] = rnd(nb, h, cap, MLA_QK), rnd(nb, h, cap, MLA_V)
    x["nlens"] = torch.randint(lo, hi + 1, (nb,), generator=g, device=dev).int()
    return x


def kvcache_rest_run(dev):
    """Phase 20's counted run, the main path: every call through
    ``flash_attn_with_kvcache``. (a) the continuous batch's 8 packed steps
    over the slot pool (``cache_batch_idx``, rotary, ``cu_seqlens_q`` /
    ``cu_seqlens_k_new``: B8 reading the slots in place), 4 single-token
    steps of all 8 sequences, one packed step with a window (B1's route,
    the live slots gathered) and one on the page pool (B9b); (b) the MLA
    decode through ``qv`` and through a 576 latent cache (B1-MLA V 512 with
    the key range), and the (192, 128) step (B1-MLA's prefill kernel with
    the key range); (c) ``int8_mma`` on the kvcache API shape's int8 cache
    and pool. The counts are set to 0 just before and read just after."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache

    cfg = KVR
    x = continuous_batch_inputs(dev)
    m = mla_step_inputs(dev)
    c = api_inputs(dev)
    rot, idx = x["rot"], x["idx"]
    torch.cuda.synchronize()
    reset_counts()
    for st in x["steps"]:
        st["out"], st["lse"] = api_step(st, x["kc"], x["vc"], rot, cache_batch_idx=idx)
    for st in x["decode"]:
        st["out"], st["lse"], _ = flash_attn_with_kvcache(
            st["q"], x["kc"], x["vc"], st["k"], st["v"], rotary_cos=rot[0], rotary_sin=rot[1],
            cache_seqlens=st["lens"], cache_batch_idx=idx, causal=True, rotary_interleaved=False,
            return_softmax_lse=True)
    st = x["window"]
    st["out"], st["lse"] = api_step(st, x["kc"], x["vc"], rot, cache_batch_idx=idx,
                                    window_size=KVR_WINDOW)
    st = x["paged"]
    st["out"], st["lse"] = api_step(st, x["kp"], x["vp"], rot, page_table=x["table"])
    m["out_qv"], m["lse_qv"] = flash_attn_with_kvcache(
        m["q"], m["kc"], m["vc"], qv=m["qv"], cache_seqlens=m["lens"], causal=True,
        return_softmax_lse=True)
    m["out_576"], m["lse_576"] = flash_attn_with_kvcache(
        m["q576"], m["latent"], m["vc"], cache_seqlens=m["lens"], causal=True,
        return_softmax_lse=True)
    m["out_192"], m["lse_192"], _ = flash_attn_with_kvcache(
        m["nq"], m["nkc"], m["nvc"], m["nk"], m["nv"], cache_seqlens=m["nlens"], causal=True,
        kv_cache_layout="bhsd", return_softmax_lse=True)
    lens8 = c["lens"]
    c["out_mma"] = flash_attn_with_kvcache(
        c["q"], c["kc8"], c["vc8"], cache_seqlens=lens8, causal=True, k_cache_scale=c["ks"],
        v_cache_scale=c["vs"], int8_mma=True)
    c["out_mma_paged"] = flash_attn_with_kvcache(
        c["q"], c["kp8"], c["vp8"], cache_seqlens=lens8, page_table=c["table"], causal=True,
        k_cache_scale=c["kps"], v_cache_scale=c["vps"], int8_mma=True)
    torch.cuda.synchronize()
    counts = read_counts()
    return counts, x, m, c


def kvcache_rest_phase(dev, card):
    """Phase 20: the rest of the kvcache API on the card. The counted run
    (:func:`kvcache_rest_run`) and its launches, then every output against
    plain versions on the card, the packed steps against their sequences
    run alone, the unpicked slots byte for byte, the decode step's
    allocations (the pool is read in place), and each new kernel variant
    against its plain version at the run's shapes, timed beside its bound
    (and SDPA where one call computes the same function). Returns the
    counts, the kernels-line rows and the stats."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache
    from liteattention_torch.ops.flash_decode import row_chunks
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
        flash_attention_masked,
        flash_attention_plain,
    )
    from liteattention_torch.ops.paged_attention import (
        paged_attention_folded,
        paged_attention_folded_plain,
    )

    cfg = KVR
    hk, d, group = cfg["kv_heads"], cfg["d"], cfg["heads"] // cfg["kv_heads"]
    t0 = time.perf_counter()
    counts, x, m, c = kvcache_rest_run(dev)
    # The launches: one B8 launch a step (several for a long padded q,
    # flash_decode.row_chunks), B9b's for the paged step, one B1 window
    # launch, the three B1-MLA calls, one int8_mma launch of each.
    chunks = lambda st: len(row_chunks(cfg["live"], st["maxq"] * group, group))  # noqa: E731
    want = {"flash_decode_batch_idx": sum(chunks(st) for st in x["steps"]) + len(x["decode"]),
            "paged_decode_folded": chunks(x["paged"]), "flash_fwd_window": 1,
            "flash_fwd_mla_v512_bound": 2, "flash_fwd_mla_bound": 1,
            "flash_decode_int8_mma": 1, "paged_decode_folded_int8_mma": 1}
    log(f"  counted run: {json.dumps({k: v for k, v in counts.items() if v})}")
    for name, n in counts.items():
        check(n == want.get(name, 0), f"phase 20: {n} launches of {name}, want "
                                      f"{want.get(name, 0)}")
    stats = {"launches": {k: v for k, v in counts.items() if v}}
    kres = {}

    # (a) the continuous batch.
    rot, idx = x["rot"], x["idx"]
    check(torch.equal(x["kc"][x["idle"]], x["idle_k"]) and torch.equal(x["vc"][x["idle"]],
                                                                       x["idle_v"]),
          "phase 20: a slot outside cache_batch_idx changed")
    log(f"  (a) the {len(x['idle'])} slots outside cache_batch_idx are unchanged, byte for byte")

    def slot_kv(pool_k, pool_v):
        return lambda i: tuple(p[idx[i]].transpose(0, 1)[None] for p in (pool_k, pool_v))

    err = 0.0
    for n_step in (0, len(x["steps"]) - 1):
        st = x["steps"][n_step]
        err = max(err, held_plain(f"(a) packed step {n_step} ({st['qlen']} tokens)", st,
                                  st["out"], st["lse"], slot_kv(x["kc"], x["vc"]), rot))
    st = x["window"]
    err = max(err, held_plain(f"(a) packed step with window {KVR_WINDOW}", st, st["out"],
                              st["lse"], slot_kv(x["kc"], x["vc"]), rot, window=KVR_WINDOW))
    st = x["paged"]
    tbl = x["table"].long()
    err = max(err, held_plain(
        f"(a) packed step on pages of {cfg['page']}", st, st["out"], st["lse"],
        lambda i: tuple(p[tbl[i]].reshape(-1, hk, d).transpose(0, 1)[None]
                        for p in (x["kp"], x["vp"])), rot))
    alone = []
    for n_step, st in enumerate(x["steps"]):
        e, r, ms = alone_check(st, st["out"], st["lse"], lambda sub, i: api_step(
            sub, x["kc"], x["vc"], rot, cache_batch_idx=idx[i:i + 1]), n_step < TIMED_STEPS)
        alone.append({"step": n_step, "max_abs_err": e, "rel_l2": r, "alone_ms": ms})
    log(f"  (a) each packed step against its sequences alone: max|err| "
        f"{max(a['max_abs_err'] for a in alone):.3e}, rel-L2 {max(a['rel_l2'] for a in alone):.2e}")
    # The decode route reads the pool in place: a step allocates about its
    # q, outputs and scratch, never a slot's copy.
    dst = x["decode"][0]

    def decode_call():
        return flash_attn_with_kvcache(
            dst["q"], x["kc"], x["vc"], dst["k"], dst["v"], rotary_cos=rot[0], rotary_sin=rot[1],
            cache_seqlens=dst["lens"], cache_batch_idx=idx, causal=True, rotary_interleaved=False,
            return_softmax_lse=True)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    decode_call()
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    log(f"  (a) a single-token step allocates {grew / 2**20:.2f} MiB at its peak beside the "
        f"{2 * nbytes(x['kc']) / 2**30:.2f} GiB pool (a gather of the live slots: "
        f"{2 * nbytes(x['kc'][idx]) / 2**20:.0f} MiB)")
    check(grew < INPLACE_SLACK, "phase 20: the decode step copied the pool")
    stats["decode_step_alloc_bytes"] = grew
    # Each packed step's device time beside its sequences alone, and the
    # padding: the padded q rows against the real ones.
    pad = []
    for n_step, st in enumerate(x["steps"][:TIMED_STEPS]):
        ms, kernel_ms, timer = device_ms(lambda st=st: api_step(
            st, x["kc"], x["vc"], rot, cache_batch_idx=idx), reps=10, names=DECODE_KERNELS)
        need = step_need(st, hk, d)
        pad.append({"step": n_step, "q_lengths": st["qlen"], "ms": ms, "kernel_ms": kernel_ms,
                    "timer": timer, "alone_ms": alone[n_step]["alone_ms"],
                    "rows_real": sum(st["qlen"]), "rows_padded": st["maxq"] * cfg["live"],
                    "bound_ms": bound(need[1], need[0])[0]})
    mixed_ms = sum(p["ms"] for p in pad)
    alone_ms = sum(p["alone_ms"] for p in pad)
    log(f"  (a) {TIMED_STEPS} packed steps: {mixed_ms:.3f} ms of device time (decode kernel "
        f"{fmt_ms(sum(p['kernel_ms'] or 0.0 for p in pad))}) against {alone_ms:.3f} ms for the "
        f"same sequences run alone; padded rows {sum(p['rows_padded'] for p in pad)} for "
        f"{sum(p['rows_real'] for p in pad)} real [{card}]")
    stats["packed_steps"] = pad
    # B1's window route gathers the live slots: the copy alone.
    win_ms = device_ms(lambda: api_step(x["window"], x["kc"], x["vc"], rot, cache_batch_idx=idx,
                                        window_size=KVR_WINDOW), reps=10)[0]
    gather_ms = device_ms(lambda: (x["kc"].transpose(1, 2)[idx].contiguous(),
                                   x["vc"].transpose(1, 2)[idx].contiguous()), reps=10)[0]
    log(f"  (a) the window step: {win_ms:.3f} ms, of which the gather of the live slots "
        f"{gather_ms:.3f} ms ({gather_ms / win_ms:.1%}) [{card}]")
    stats["window_step"] = {"ms": win_ms, "slot_gather_ms": gather_ms,
                            "gathered_bytes": 2 * nbytes(x["kc"][idx])}
    # B8 with cache_batch_idx against its plain version at the single-token
    # step's shape, timed.
    lens1 = dst["lens"] + 1
    keys = int(lens1.sum())
    q4 = dst["q"].transpose(1, 2)
    r = check_decode(
        f"B8 cache_batch_idx {cfg['live']} of {cfg['slots']} slots x {cfg['heads']}/{hk}x{d}, "
        f"lengths {lens1.min().item()}-{lens1.max().item()}", flash_attention_decode,
        flash_attention_decode_plain, (q4, x["kc"], x["vc"]),
        dict(kv_bound=lens1, causal=True, cache_batch_idx=idx),
        (2 * keys * hk * d * 2 + 2 * nbytes(q4) + 4 * cfg["live"] * cfg["heads"],
         4 * group * d * hk * keys), time_it=True)
    r["library"] = "none (no one call reads a slot pool by index)"
    r["err"] = max(r["err"], err)
    r["packed_steps"] = {"ms": mixed_ms, "alone_ms": alone_ms,
                         "bound_ms": sum(p["bound_ms"] for p in pad)}
    kres["flash_decode_batch_idx"] = r

    # (b) MLA decode through qv, the 576 latent cache and the (192, 128) step.
    b, h, s = MLA_BATCH, MLA_HEADS, MLA_MAX_LEN
    fold = lambda t: t.transpose(1, 2).reshape(b, 1, h, t.shape[-1])  # noqa: E731
    kh, vh = m["kc"].transpose(1, 2), m["vc"].transpose(1, 2)
    scale = (MLA_ROPE + MLA_DV) ** -0.5
    ro, rl = flash_attention_plain(fold(m["q"]), kh, vh, scale, qv=fold(m["qv"]),
                                   kv_bound=m["lens"])
    ro, rl = ro.reshape(b, h, 1, MLA_DV).transpose(1, 2), rl.reshape(b, h, 1)
    e_qv = check_mla("(b) qv decode, B1-MLA (64, 512) + qv with the key range", m["out_qv"],
                     m["lse_qv"], ro, rl)
    e_576 = check_mla("(b) the 576 latent cache, B1-MLA (576, 512) with the key range",
                      m["out_576"], m["lse_576"], ro, rl)
    same = rel_l2(m["out_576"].float(), m["out_qv"].float())
    log(f"  (b) the two forms of one latent cache agree: rel-L2 {same:.2e}")
    check(same < MLA_REL_TOL, "phase 20: the qv and 576 forms differ")
    keys_mla = int(m["lens"].sum())

    def mla_row(label, call, plain_call, flops, nbytes_, library):
        res = {"ms": device_ms(call)[0], "plain_ms": cuda_ms(plain_call, reps=1)}
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes_)
        backend, res["library_ms"], t_lib = sdpa_backend_ms(label, library)
        res["library"] = f"torch SDPA, boolean key mask ({backend} backend)" if backend else "none"
        res["timer"] = {"ms": "queued_events", "plain_ms": "events", "library_ms": t_lib}
        log(f"  {label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}), {res['library']} "
            f"{fmt_ms(res['library_ms'])} [{card}]")
        torch.cuda.empty_cache()
        return res

    sdpa = torch.nn.functional.scaled_dot_product_attention
    key_mask = (torch.arange(s, device=dev) < m["lens"][:, None])[:, None, None]  # [B, 1, 1, S]
    qf, qvf = fold(m["q"]), fold(m["qv"])
    r = mla_row(
        "(b) B1-MLA (64, 512) + qv, key range", lambda: flash_attention_masked(
            qf, kh, vh, kv_bound=m["lens"], scale=scale, qv=qvf),
        lambda: flash_attention_plain(qf, kh, vh, scale, qv=qvf, kv_bound=m["lens"]),
        2 * (MLA_ROPE + 2 * MLA_DV) * keys_mla * h,
        keys_mla * (MLA_ROPE + MLA_DV) * 2 + nbytes(qf, qvf) + b * h * (MLA_DV * 2 + 4),
        lambda: sdpa(torch.cat([qf, qvf], -1), torch.cat([kh, vh], -1), vh, attn_mask=key_mask,
                     scale=scale))
    lat = m["latent"].transpose(1, 2)
    q576 = fold(m["q576"])
    r["latent_576"] = mla_row(
        "(b) B1-MLA (576, 512), key range", lambda: flash_attention_masked(
            q576, lat, vh, kv_bound=m["lens"]),
        lambda: flash_attention_plain(q576, lat, vh, kv_bound=m["lens"]),
        2 * (MLA_D + MLA_DV) * keys_mla * h,
        keys_mla * (MLA_D + MLA_DV) * 2 + nbytes(q576) + b * h * (MLA_DV * 2 + 4),
        lambda: sdpa(q576, lat, vh, attn_mask=key_mask))
    r["err"] = max(e_qv, e_576)
    r["shape"] = f"{b} x {h} heads on 1, lengths {m['lens'].min().item()}-{s}, single token"
    kres["flash_fwd_mla_v512_bound"] = r
    nb, new, cap, _ = MLA_BOUND_STEP
    total = m["nlens"] + new
    qh = m["nq"].transpose(1, 2)
    ro, rl = flash_attention_plain(qh, m["nkc"], m["nvc"], kv_bound=total, bound_causal=True)
    out = m["out_192"].transpose(1, 2)
    e192 = ((out.float() - ro.float()).abs() / ro.float().abs().clamp_min(1.0)).max().item()
    e192_l = (m["lse_192"] - rl).abs().max().item()
    rel, blk = block_rel_l2(out, ro)
    log(f"  (b) the (192, 128) step with the key range: max|out| err {e192:.3e} (over max(1, "
        f"|plain|)), rel-L2 {rel:.2e}, worst 128-row block {blk:.2e}, max|lse| err {e192_l:.3e}")
    check(e192 < OUT_TOL and e192_l < LSE_TOL and blk < MLA_BLOCK_TOL,
          "phase 20: the (192, 128) step disagrees with the plain version")
    pairs = sum(p + r_ + 1 for p in m["nlens"].tolist() for r_ in range(new))
    vis = int(total.sum())
    last = torch.arange(new, device=dev)[:, None] + m["nlens"][:, None, None]  # a row's last key
    causal_mask = (torch.arange(cap, device=dev) <= last)[:, None]  # [B, 1, new, cap]
    r = mla_row(
        "(b) B1-MLA (192, 128), key range", lambda: flash_attention_masked(
            qh, m["nkc"], m["nvc"], kv_bound=total, bound_causal=True),
        lambda: flash_attention_plain(qh, m["nkc"], m["nvc"], kv_bound=total, bound_causal=True),
        2 * (MLA_QK + MLA_V) * pairs * h,
        vis * h * (MLA_QK + MLA_V) * 2 + nbytes(qh) + nb * h * new * (MLA_V * 2 + 4),
        lambda: sdpa(qh, m["nkc"], m["nvc"], attn_mask=causal_mask))
    r["err"] = e192
    r["shape"] = (f"{nb} x {h} x {new} new rows, (192, 128), head-major cache {cap}, prior "
                  f"{m['nlens'].min().item()}-{m['nlens'].max().item()}, causal")
    kres["flash_fwd_mla_bound"] = r
    del ro, rl, causal_mask, key_mask
    torch.cuda.empty_cache()

    # (c) int8_mma against its plain version, and against the exact path.
    lens8 = c["lens"]
    keys8 = int(lens8.sum())
    q4 = c["q"].transpose(1, 2)
    b8, hq8 = c["q"].shape[0], c["q"].shape[2]
    need = (2 * keys8 * API_HK * API_D + 2 * nbytes(c["q"]) + 4 * b8 * hq8 + 2 * nbytes(c["ks"]),
            4 * (API_HQ // API_HK) * API_D * API_HK * keys8)
    shape = f"{b8}x{hq8}/{API_HK}x{API_D}, cache {API_CACHE}, lengths {lens8.min().item()}-" \
            f"{lens8.max().item()}"
    r = check_decode(f"B8 int8_mma {shape}", flash_attention_decode, flash_attention_decode_plain,
                     (q4, c["kc8"], c["vc8"]),
                     dict(kv_bound=lens8, k_scale=c["ks"], v_scale=c["vs"], int8_mma=True,
                          causal=True), need, time_it=True)
    exact = flash_attention_decode_plain(q4, c["kc8"], c["vc8"], kv_bound=lens8, k_scale=c["ks"],
                                         v_scale=c["vs"])[0]
    r["rel_l2_vs_exact"] = rel_l2(c["out_mma"].transpose(1, 2).float(), exact.float())
    # The dequant path (int8 K cast to bf16 in registers) at the same shape.
    r["ms_dequant"], r["kernel_ms_dequant"], _ = device_ms(lambda: flash_attention_decode(
        q4, c["kc8"], c["vc8"], kv_bound=lens8, k_scale=c["ks"], v_scale=c["vs"], causal=True),
        names=DECODE_KERNELS)
    log(f"  (c) the dequant path at this shape: device {r['ms_dequant']:.4f} ms per call (decode "
        f"kernel {fmt_ms(r['kernel_ms_dequant'])}) [{card}]")
    r["library"] = "none"
    kres["flash_decode_int8_mma"] = r
    r = check_decode(f"B9b int8_mma {shape}, pages {API_PAGE}", paged_attention_folded,
                     paged_attention_folded_plain,
                     (c["q"], c["kp8"], c["vp8"], lens8, c["table"]),
                     dict(return_lse=True, k_scale=c["kps"], v_scale=c["vps"], int8_mma=True,
                          causal=True), (need[0] + nbytes(c["table"]), need[1]), time_it=True)
    exact_p = paged_attention_folded_plain(c["q"], c["kp8"], c["vp8"], lens8, c["table"],
                                           k_scale=c["kps"], v_scale=c["vps"])
    r["rel_l2_vs_exact"] = rel_l2(c["out_mma_paged"].float(), exact_p.float())
    r["library"] = "none"
    kres["paged_decode_folded_int8_mma"] = r
    for name in ("flash_decode_int8_mma", "paged_decode_folded_int8_mma"):
        rel = kres[name]["rel_l2_vs_exact"]
        log(f"  (c) {name}: rel-L2 {rel:.3e} against the exact dequant path (JAX's bound "
            f"{INT8_MMA_TOL})")
        check(rel < INT8_MMA_TOL, f"phase 20: {name} is off the exact path")
    for r in kres.values():
        r.setdefault("library_ms", None)
    del x, m, c
    torch.cuda.empty_cache()
    stats["seconds_checks"] = time.perf_counter() - t0
    return counts, kres, stats


# ---------------------------------------------------------------- phase 21

# The GPT-NeoX family through gpt_neox_config(). Pythia-2.8B
# (EleutherAI/pythia-2.8b config.json: hidden_size 2560, 32 layers, 32 heads
# of 80, rotary_pct 0.25, vocab 50 304, use_parallel_residual, untied
# embed_out) at full width and depth: 8 requests of 1024 prompt tokens and
# 64 greedy tokens (its context is 2048), with bf16 and int8 caches.
# GPT-NeoX-20B (EleutherAI/gpt-neox-20b: 6144, 44 layers, 64 heads of 96,
# vocab 50 432) at full width and 12 of its 44 layers: the fp32 weights of
# all 44 (82 GB) do not fit the card's 80 GB. 8 x (1024 + 32).
PYTHIA_KW = dict(dim=2560, num_layers=32, num_heads=32, vocab=50304)
PYTHIA_HEADS, NEOX_HEADS = 32, 64  # q heads (all KV heads too) of 80 and 96
PYTHIA_BATCH, PYTHIA_PROMPT, PYTHIA_NEW = 8, 1024, 64
NEOX_LAYERS, NEOX_BATCH, NEOX_PROMPT, NEOX_NEW = 12, 8, 1024, 32
NEOX_SEED = 2121
# The recompute check's planted faults (recompute_fault_readings): every
# step this many positions late, and the prompt's last rows zeroed; GPT-J's
# sizes, since rotary over a quarter of the head dim makes the attention
# near uniform over the prompt there too.
NEOX_FAULT_LATE, NEOX_FAULT_ROWS = 64, 64
# GPT-NeoX-20B's attention over packed causal documents: 16 384 tokens in
# 8 documents of 1024-3072 (B1's and B7's segment walks at 96), and ALiBi at
# 96 (b, h, s; causal), forward and backward.
NEOX_PACK = (16384, 64, 64, 96, (1024, 3072), 2311)
NEOX_ALIBI_SHAPE = (2, 64, 2048)
# The kvcache API's steps at GPT-NeoX-20B's attention: a slot pool, its live
# slots by cache_batch_idx, and pages of 64 keys.
NEOX_API_SLOTS, NEOX_API_PAGE = 16, 64


def neox_hf_state_dict(cfg, dev, seed):
    """An HF-named GPT-NeoX state dict (``GPTNeoXForCausalLM``'s keys) of
    random bf16 tensors on the card from ``seed``: ``query_key_value``
    head-interleaved as (heads, 3, head dim) rows, N(0, 1 / fan_in) weights,
    small biases, unit norm scales, zero norm biases."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def w(out_f, in_f):
        return (torch.randn(out_f, in_f, generator=g, device=dev, dtype=torch.bfloat16)
                * in_f**-0.5)

    def bias(n):
        return torch.randn(n, generator=g, device=dev, dtype=torch.bfloat16) * 0.02

    dim = cfg.dim
    ffn = cfg.ffn_dim or 4 * dim
    ones = lambda: torch.ones(dim, device=dev, dtype=torch.bfloat16)  # noqa: E731
    zeros = lambda: torch.zeros(dim, device=dev, dtype=torch.bfloat16)  # noqa: E731
    sd = {"gpt_neox.embed_in.weight": w(cfg.vocab_size, dim),
          "gpt_neox.final_layer_norm.weight": ones(),
          "gpt_neox.final_layer_norm.bias": zeros(),
          "embed_out.weight": w(cfg.vocab_size, dim)}
    for i in range(cfg.num_layers):
        pre = f"gpt_neox.layers.{i}."
        sd[pre + "attention.query_key_value.weight"] = w(3 * dim, dim)
        sd[pre + "attention.query_key_value.bias"] = bias(3 * dim)
        sd[pre + "attention.dense.weight"] = w(dim, dim)
        sd[pre + "attention.dense.bias"] = bias(dim)
        sd[pre + "mlp.dense_h_to_4h.weight"] = w(ffn, dim)
        sd[pre + "mlp.dense_h_to_4h.bias"] = bias(ffn)
        sd[pre + "mlp.dense_4h_to_h.weight"] = w(dim, ffn)
        sd[pre + "mlp.dense_4h_to_h.bias"] = bias(dim)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + norm + ".weight"] = ones()
            sd[pre + norm + ".bias"] = zeros()
    return sd


def decode_row(label, fn, plain, q, kc, vc, lens, cap, kw=None, library=True):
    """check_decode of a single-token step over a ``[B, Hk, cap, D]``
    head-major cache (bf16, or int8 with ``kw``'s scales) at ``lens``,
    timed beside its bound and SDPA (``enable_gqa``, a boolean key-padding
    mask; the bf16 cache), then at full lengths beside SDPA without a
    mask."""
    import torch

    b, h, _, d = q.shape
    hk = kc.shape[1]
    kw = dict(kw or {})
    el = kc.element_size()
    keys = int(lens.sum())
    need = (2 * keys * hk * d * el + 2 * nbytes(q) + 4 * b * h, 4 * d * h * keys)
    args = (q, kc.transpose(1, 2), vc.transpose(1, 2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r = check_decode(label, fn, plain, args, {"kv_bound": lens, **kw}, need, time_it=True)
    if library:
        pad = (torch.arange(cap, device=q.device) < lens[:, None])[:, None, None]
        backend, r["library_ms"], r["timer"]["library_ms"] = sdpa_backend_ms(
            label, lambda: sdpa(q, kc, vc, attn_mask=pad, enable_gqa=hk < h))
        r["library"] = f"SDPA enable_gqa, boolean key-padding mask ({backend})"
    full = torch.full((b,), cap, dtype=torch.int32, device=q.device)
    r["ms_full_lengths"], _, r["timer"]["ms_full_lengths"] = device_ms(
        lambda: fn(*args, kv_bound=full, **kw))
    r["bound_ms_full_lengths"] = bound(4 * d * h * b * cap,
                                       2 * b * cap * hk * d * el + 2 * nbytes(q) + 4 * b * h)[0]
    if library:
        _, r["library_ms_full_lengths"], r["timer"]["library_ms_full_lengths"] = (
            sdpa_backend_ms(f"{label} full", lambda: sdpa(q, kc, vc, enable_gqa=hk < h)))
    log(f"  decode {label}: SDPA (key-padding mask) {fmt_ms(r['library_ms'])}; full lengths "
        f"{r['ms_full_lengths']:.4f} ms (bound {r['bound_ms_full_lengths']:.4f} ms), SDPA "
        f"{fmt_ms(r.get('library_ms_full_lengths'))}")
    return r


def paged_inputs(kc, vc, lens, page, g):
    """The head-major cache ``[B, Hk, cap, D]`` cut into pages of ``page``
    keys (the last zero-filled past ``cap``) laid out at random: a native
    pool ``[pages, page, Hk, D]``, a head-major pool ``[Hk, pages, page,
    D]`` and the page table."""
    import torch

    b, hk, cap, d = kc.shape
    pps = -(-cap // page)
    perm = torch.randperm(b * pps, generator=g, device=kc.device)
    table = perm.reshape(b, pps).int()

    def native(x):
        pool = torch.zeros(b * pps, page, hk, d, dtype=x.dtype, device=x.device)
        rows = torch.zeros(b, pps * page, hk, d, dtype=x.dtype, device=x.device)
        rows[:, :cap] = x.transpose(1, 2)
        pool[perm] = rows.reshape(b * pps, page, hk, d)
        return pool

    kp, vp = native(kc), native(vc)
    return kp, vp, kp.permute(2, 0, 1, 3).contiguous(), vp.permute(2, 0, 1, 3).contiguous(), table


def int8_mma_kernel_times(dev, card):
    """The decode kernel alone (``launch_decode`` on rows packed and folded
    beforehand, so that the call launches nothing else) at the kvcache API
    shape over int8 caches: the int8_mma instantiation and the dequant one,
    contiguous (B8) and paged (B9b, pages of API_PAGE), each by queued_ms
    in turns within this run."""
    import torch
    from liteattention_torch.ops.flash_decode import launch_decode, pack_rows, quantize_rows
    from liteattention_torch.ops.kv_quant import quantize_kv_cache, quantize_kv_pages

    g = torch.Generator(device=dev).manual_seed(2131)
    b, hq, hk, d, cap, page = API_B, API_HQ, API_HK, API_D, API_CACHE, API_PAGE
    q = torch.randn(b, hq, 1, d, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(b, cap, hk, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.randint(cap // 2, cap + 1, (b,), generator=g, device=dev).int()
    c = quantize_kv_cache(kc, vc)
    pps = cap // page
    table = torch.randperm(b * pps, generator=g, device=dev).reshape(b, pps).int()
    kp = torch.empty(b * pps, page, hk, d, dtype=torch.bfloat16, device=dev)
    vp = torch.empty_like(kp)
    kp[table.long().reshape(-1)] = kc.reshape(b * pps, page, hk, d)
    vp[table.long().reshape(-1)] = vc.reshape(b * pps, page, hk, d)
    pool = quantize_kv_pages(kp, vp)
    group, scale = hq // hk, d**-0.5
    res = {"shape": f"{b}x{hq}/{hk}x{d}, int8 cache {cap}, lengths {lens.min().item()}-"
                    f"{lens.max().item()}, pages {page}", "card": card}
    calls = {}
    for form, ks, k8, v8, paged in (("contiguous", c.k_scale, c.k, c.v, False),
                                    ("paged", pool.k_scale[None].expand(b, hk, d), pool.k,
                                     pool.v, True)):
        # The wrappers' fold: q times k_scale, rows packed (q position,
        # group member); int8_mma then quantizes each row.
        qf = q.float().reshape(b, hk, group, 1, d) * ks[:, :, None, None, :]
        qp = pack_rows(qf.reshape(b, hq, 1, d).to(torch.bfloat16), hk)
        q8, qs = quantize_rows(qp)
        geo = dict(group=group, causal=True, scale=scale, softcap=0.0, num_splits=0,
                   capacity=cap)
        sizes = (b, cap, hk)
        if paged:
            sizes = (b * pps, page, hk)
            geo.update(table=table, page_size=page)
        for kind, rows, qsc in (("dequant", qp, None), ("int8_mma", q8, qs)):
            calls[f"{form}_{kind}"] = (
                lambda rows=rows, qsc=qsc, k8=k8, v8=v8, sizes=sizes, geo=geo: launch_decode(
                    rows, k8, v8, sizes, k8.stride()[:3], v8.stride()[:3], lens, None,
                    q_scale=qsc, **geo))
    for name in list(calls) + list(calls)[::-1]:  # in turns: each twice
        ms, timer = queued_ms(calls[name], 50)
        res.setdefault(name + "_ms", []).append(ms)
        res[name + "_timer"] = timer
    keys = int(lens.sum())
    for form in ("contiguous", "paged"):
        for kind, el_q in (("dequant", 2), ("int8_mma", 1)):
            nb = 2 * keys * hk * d + b * hq * d * (el_q + 2) + 4 * b * hq
            res[f"{form}_{kind}_bound_ms"], res[f"{form}_{kind}_bound_by"] = bound(
                4 * d * hq * keys, nb)
        log(f"  {form} int8 cache, the decode kernel alone: int8_mma "
            + " / ".join(f"{x:.4f}" for x in res[f"{form}_int8_mma_ms"]) + " ms, dequant "
            + " / ".join(f"{x:.4f}" for x in res[f"{form}_dequant_ms"])
            + f" ms ({res[f'{form}_int8_mma_timer']}; bound "
            f"{res[f'{form}_int8_mma_bound_ms']:.4f} ms) [{card}]")
    del kc, vc, kp, vp, c, pool
    torch.cuda.empty_cache()
    return res


def neox_kernel_phase(dev, card):
    """Phase 21 (a): the new instantiations at the GPT-NeoX family's shapes
    against their plain versions, each timed beside its bound and a
    library call: B1's bound_causal prefill at Pythia-2.8B (D 80) and
    GPT-NeoX-20B (D 96) over their serving caches; B8 bf16 and int8 at
    their decode steps (ragged and full lengths); at D 96 B8 over a slot
    pool by cache_batch_idx, B9b over a native page pool, B9a over a
    head-major one; B1's and B7's segment walks over packed documents and
    ALiBi, forward and backward; then int8_mma beside the dequant kernel at
    the kvcache API shape."""
    import torch
    from liteattention_torch.flash_attn_interface import varlen_segment_ids
    from liteattention_torch.modules.mha import alibi_slopes
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
    )
    from liteattention_torch.ops.kv_quant import quantize_kv_cache_native
    from liteattention_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_folded,
        paged_attention_folded_plain,
        paged_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(NEOX_SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    res = {}
    for tag, b, h, d, prompt, new in (("pythia_d80", PYTHIA_BATCH, PYTHIA_HEADS, 80,
                                       PYTHIA_PROMPT, PYTHIA_NEW),
                                      ("neox20b_d96", NEOX_BATCH, NEOX_HEADS, 96, NEOX_PROMPT,
                                       NEOX_NEW)):
        cap = prompt + new
        name = "Pythia-2.8B" if d == 80 else "GPT-NeoX-20B"
        kc, vc = rnd(b, h, cap, d), rnd(b, h, cap, d)
        plen = torch.full((b,), prompt, dtype=torch.int32, device=dev)
        qp = rnd(b, h, prompt, d)
        label = f"bound_causal prefill {b}x{h}x{prompt}x{d} over a {cap}-slot cache ({name})"
        res[f"fwd_bound_{tag}"] = check_channels(label, qp, kc, vc,
                                                 dict(kv_bound=plen, bound_causal=True),
                                                 time_it=True)
        if d == 96:
            # B7's key range at 96 (its RANGE instantiations, diagonal and
            # not): the prefill's gradient, and the bound alone, non-causal.
            res["bwd_bound_d96"] = check_bwd_channels(
                label, qp, kc, vc, rnd(b, h, prompt, d), dict(kv_bound=plen, bound_causal=True),
                time_it=True)
            lens2 = torch.randint(1, cap + 1, (b,), generator=g, device=dev).int()
            n = min(256, prompt)
            r = check_bwd_channels(f"bound {b}x{h}x{n}x{d} over {cap} keys, not causal",
                                   qp[:, :, :n].contiguous(), kc, vc, rnd(b, h, n, d),
                                   dict(kv_bound=lens2))
            res["bwd_bound_d96"]["err"] = max(res["bwd_bound_d96"]["err"], r["err"])
        del qp
        q = rnd(b, h, 1, d)
        lens = torch.randint(prompt + 1, cap + 1, (b,), generator=g, device=dev).int()
        shape = f"{b}x{h}/{h}x{d}, cache {cap}, lengths {lens.min().item()}-{lens.max().item()}"
        r = res[f"decode_{tag}"] = decode_row(f"B8 bf16 {shape} ({name})", flash_attention_decode,
                                             flash_attention_decode_plain, q, kc, vc, lens, cap)
        c8 = quantize_kv_cache_native(kc, vc)
        r["int8"] = decode_row(f"B8 int8 {shape} ({name})", flash_attention_decode,
                               flash_attention_decode_plain, q, c8.k, c8.v, lens, cap,
                               dict(k_scale=c8.k_scale, v_scale=c8.v_scale), library=False)
        r["err"] = max(r["err"], r["int8"]["err"])
        del c8
        if d == 96:
            # B8 over a slot pool by cache_batch_idx: the live slots' rows of
            # a pool twice the batch, read in place.
            slots = NEOX_API_SLOTS
            pick = torch.randperm(slots, generator=g, device=dev)[:b].int()
            kpool = torch.zeros(slots, cap, h, d, dtype=torch.bfloat16, device=dev)
            vpool = torch.zeros_like(kpool)
            kpool[pick.long()] = kc.transpose(1, 2)
            vpool[pick.long()] = vc.transpose(1, 2)
            keys = int(lens.sum())
            need = (2 * keys * h * d * 2 + 2 * nbytes(q) + 4 * b * h + 4 * b, 4 * d * h * keys)
            pad = (torch.arange(cap, device=dev) < lens[:, None])[:, None, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            r = res["decode_batch_idx_d96"] = check_decode(
                f"B8 cache_batch_idx {shape}, {b} of {slots} slots ({name})",
                flash_attention_decode, flash_attention_decode_plain, (q, kpool, vpool),
                dict(kv_bound=lens, cache_batch_idx=pick), need, time_it=True,
                library=lambda: sdpa(q, kc, vc, attn_mask=pad))
            r["library"] = "SDPA over the live slots' caches, boolean key-padding mask"
            del kpool, vpool
            # B9b / B9a: the same cache in pages of NEOX_API_PAGE keys.
            kp, vp, kh, vh, table = paged_inputs(kc, vc, lens, NEOX_API_PAGE, g)
            qb = q.transpose(1, 2).contiguous()  # [B, 1, H, D]
            pneed = (need[0] - 4 * b + nbytes(table), need[1])
            for key, fn, plain, kk, vv in (
                    ("paged_folded_d96", paged_attention_folded, paged_attention_folded_plain, kp,
                     vp),
                    ("paged_d96", paged_attention, paged_attention_plain, kh, vh)):
                layout = "native" if fn is paged_attention_folded else "head-major"
                r = res[key] = check_decode(
                    f"B9{'b' if layout == 'native' else 'a'} {shape}, {layout} pool of "
                    f"{NEOX_API_PAGE}-key pages ({name})", fn, plain, (qb, kk, vv, lens, table),
                    dict(return_lse=True, causal=True), pneed, time_it=True,
                    library=lambda: sdpa(q, kc, vc, attn_mask=pad))
                r["library"] = "SDPA over the dense cache, boolean key-padding mask"
            del kp, vp, kh, vh
        del kc, vc
        torch.cuda.empty_cache()

    # B1's and B7's segment walks at 96: GPT-NeoX-20B's attention over
    # packed causal documents, against each document alone, then against
    # their plain versions.
    total, h, hk, d = NEOX_PACK[:4]
    q, k, v, dout, lengths, cu = packed_docs(dev, NEOX_PACK)
    res["docs_alone"] = docs_alone_check(f"GPT-NeoX-20B {len(lengths)} documents, {total} "
                                         "tokens", q, k, v, dout, lengths, cu, None)
    seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
    kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None], causal=True)
    qh, kh, vh, dh = heads_first(q, k, v, dout)
    label = f"segments causal 1x{h}/{hk}x{total}x{d}, GPT-NeoX-20B's {len(lengths)} documents"
    res["fwd_segments_d96"] = check_channels(label, qh, kh, vh, kw, time_it=True)
    res["bwd_segments_d96"] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    del q, k, v, dout, qh, kh, vh, dh
    torch.cuda.empty_cache()
    # ALiBi at 96, causal, forward and backward.
    b, h, s = NEOX_ALIBI_SHAPE
    q, k, v, dout = (rnd(b, h, s, 96) for _ in range(4))
    kw = dict(alibi_slopes=alibi_slopes(h).to(dev), causal=True)
    label = f"ALiBi causal {b}x{h}x{s}x96"
    res["fwd_alibi_d96"] = check_channels(label, q, k, v, kw, time_it=True)
    res["bwd_alibi_d96"] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
    # The non-causal ALiBi instantiations, [B, H] slopes, Sq != Sk.
    slopes = alibi_slopes(h).to(dev) * torch.linspace(1.0, 2.0, b, device=dev)[:, None]
    kw = dict(alibi_slopes=slopes)
    n = s // 8
    qn, kn, vn, dn = (x[:, :, :m].contiguous() for x, m in ((q, n), (k, s // 2), (v, s // 2),
                                                             (dout, n)))
    label = f"ALiBi non-causal {b}x{h}x{n} over {s // 2} keys, [B, H] slopes"
    r = check_channels(label, qn, kn, vn, kw)
    res["fwd_alibi_d96"]["err"] = max(res["fwd_alibi_d96"]["err"], r["err"])
    r = check_bwd_channels(label, qn, kn, vn, dn, kw)
    res["bwd_alibi_d96"]["err"] = max(res["bwd_alibi_d96"]["err"], r["err"])
    del q, k, v, dout, qn, kn, vn, dn
    torch.cuda.empty_cache()
    res["int8_mma_kernel"] = int8_mma_kernel_times(dev, card)
    return res


def neox_serve(dev, card, cfg, label, batch, prompt, new, seed, int8):
    """GPT-NeoX at ``cfg`` from an HF-named bf16 state dict through
    ``remap_state_dict_hf_gpt_neox`` (built on the card: one extra copy of
    the weights beside the model's fp32 parameters), serving ``batch``
    requests of ``prompt`` tokens and ``new`` greedy tokens (the counted
    path: bf16 cache, then with ``int8`` an int8 one), each run's step
    logits against a full recompute and two planted faults above its
    limit. Returns (counts, stats)."""
    import torch
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import greedy_decode
    from liteattention_torch.utils.pretrained import remap_state_dict_hf_gpt_neox

    h, hd = cfg.num_heads, cfg.dim // cfg.num_heads
    cap = prompt + new
    log(f"  {label}: dim {cfg.dim}, {cfg.num_layers} layers, {h} heads x {hd}, rotary over "
        f"{cfg.rotary_emb_dim}, parallel residual (two norms), ffn {4 * cfg.dim}, vocab "
        f"{cfg.vocab_size}, untied head; fp32 master weights, bf16 compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device=dev)
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    hf = neox_hf_state_dict(cfg, dev, seed)
    sd = remap_state_dict_hf_gpt_neox(hf, cfg)
    model.load_state_dict(sd)
    # The remap's regrouping on the card: q head j is rows (j, 0, :) of the
    # head-interleaved query_key_value, k (j, 1, :), v (j, 2, :).
    qkv = hf["gpt_neox.layers.0.attention.query_key_value.weight"].reshape(h, 3, hd, -1)
    wqkv = model.transformer.blocks[0].mha.Wqkv.weight.reshape(3, h, hd, -1)
    check(torch.equal(wqkv, qkv.transpose(0, 1).float()),
          f"{label} remap: Wqkv is not q | k | v of the head-interleaved query_key_value")
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    del hf, sd, qkv
    torch.cuda.empty_cache()
    log(f"  {n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.1f} GB fp32); the HF-named "
        f"checkpoint built in bf16 on the card, remapped and loaded in {load_s:.1f} s (peak "
        f"{load_peak:.2f} GB); {batch} requests x {prompt} prompt tokens, {new} new tokens "
        f"each, cache capacity {cap}")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=dev)
    greedy_decode(model, ids[:1, :16], 2, 32)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    runs = []
    for quantize in (False, True) if int8 else (False,):
        t0 = time.perf_counter()
        timer = StepTimer(model)
        toks = greedy_decode(timer, ids, new, cap, quantize_cache=quantize)
        torch.cuda.synchronize()
        runs.append(("int8" if quantize else "bf16", timer, toks,
                     (time.perf_counter() - t0) * 1e3))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches during the {label} serving run"
        f"{' (bf16 and int8 caches)' if int8 else ''}: {counts}")
    n_decode = len(runs[0][1].calls) - 1
    want_b1, want_b8 = len(runs) * cfg.num_layers, len(runs) * cfg.num_layers * n_decode
    others = sum(n for name, n in counts.items() if name not in ("flash_fwd_bound", "flash_decode"))
    check(n_decode == new - 1 and counts["flash_fwd_bound"] == want_b1
          and counts["flash_decode"] == want_b8 and others == 0,
          f"{label} serving: expected {want_b1} bound B1 launches (the prefills), {want_b8} "
          "decode-kernel launches (one a layer a step) and no other")
    stats = {"peak_gb": peak, "load_peak_gb": load_peak, "load_s": load_s,
             "parameters_b": n_params / 1e9, "decode_steps": n_decode,
             "layers": cfg.num_layers, "card": card}
    for name, timer, toks, wall in runs:
        sfx = "" if name == "bf16" else "_int8"
        prefill_ms = timer.calls[0][1]
        step_ms = [ms for _, ms in timer.calls[1:]]
        dec_ms = statistics.median(step_ms)
        stats.update({f"prefill_ms{sfx}": prefill_ms, f"decode_ms_per_step{sfx}": dec_ms,
                      f"decode_tokens_per_s{sfx}": batch * 1e3 / dec_ms,
                      f"end_to_end_tokens_per_s{sfx}": batch * new * 1e3 / wall})
        log(f"  {name} cache: prefill {prefill_ms:.1f} ms ({batch * prompt / prefill_ms * 1e3:.0f}"
            f" prompt tokens/s), decode {dec_ms:.2f} ms/step (median of {n_decode}; min "
            f"{min(step_ms):.2f}, max {max(step_ms):.2f}) = {batch * 1e3 / dec_ms:.0f} tokens/s; "
            f"end to end {wall:.0f} ms; peak memory {peak:.2f} GB [{card}]")
    # Checks (their launches are not counted): each run's incremental decode
    # against a full recompute without a cache over its tokens, and two
    # planted faults in each cache held above the limit.
    for name, timer, toks, _ in runs:
        sfx = "" if name == "bf16" else "_int8"
        with torch.inference_mode():
            full = torch.cat([model(toks[i : i + 1, :-1])[:, prompt - 1 :].float()
                              for i in range(batch)])
        step_logits = timer.logits()
        check(toks.shape == (batch, cap) and torch.isfinite(step_logits).all(),
              f"{label} serving ({name}): bad greedy output")
        e_full = rel_l2(step_logits, full)
        agree = (step_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
        log(f"  {name} cache: incremental decode vs full recompute without a cache: logits "
            f"rel-L2 {e_full:.3e} (limit {SERVE_RECOMPUTE_TOL}), argmax agreement {agree:.3f}")
        check(e_full < SERVE_RECOMPUTE_TOL,
              f"{label} incremental decode ({name} cache) disagrees with the recompute")
        stats[f"recompute_rel_l2{sfx}"], stats[f"recompute_argmax_agreement{sfx}"] = e_full, agree
        res = recompute_fault_readings(model, toks, full, step_logits, prompt=prompt,
                                       capacity=cap, late_by=NEOX_FAULT_LATE,
                                       rows=NEOX_FAULT_ROWS, quantize=name == "int8")
        stats.update({f"{k}{sfx}": x for k, x in res.items()})
        del full, step_logits
    del model, runs
    torch.cuda.empty_cache()
    return counts, stats


def neox_attention_run(dev):
    """Phase 21 (d), the counted run at GPT-NeoX-20B's attention (64 heads
    of 96): through ``flash_attn_with_kvcache`` a contiguous single-token
    step, a step on the live slots of a pool by ``cache_batch_idx`` and a
    step over a native page pool (B9b); through ``ops.paged_attention`` a
    step over a head-major pool (B9a); ``flash_attn_varlen_func`` over
    NEOX_PACK's documents and ``flash_attn_func`` with ALiBi, each forward
    and backward. One launch of each kernel and nothing else; then every
    output against its plain version."""
    import torch
    from liteattention_torch import flash_attn_func, flash_attn_varlen_func
    from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache
    from liteattention_torch.modules.mha import alibi_slopes
    from liteattention_torch.ops.flash_fwd import flash_attention_decode_plain
    from liteattention_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_folded_plain,
        paged_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(NEOX_SEED + 7)
    b, h, d, cap, slots = NEOX_BATCH, NEOX_HEADS, 96, NEOX_PROMPT + NEOX_NEW, NEOX_API_SLOTS

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, kn, vn = rnd(b, 1, h, d), rnd(b, 1, h, d), rnd(b, 1, h, d)
    lens = torch.randint(NEOX_PROMPT, cap, (b,), generator=g, device=dev).int()
    kc, vc = rnd(b, cap, h, d), rnd(b, cap, h, d)
    kpool, vpool = rnd(slots, cap, h, d), rnd(slots, cap, h, d)
    pick = torch.randperm(slots, generator=g, device=dev)[:b].int()
    pps = -(-cap // NEOX_API_PAGE)
    table = torch.randperm(b * pps, generator=g, device=dev).reshape(b, pps).int()
    kp, vp = rnd(b * pps, NEOX_API_PAGE, h, d), rnd(b * pps, NEOX_API_PAGE, h, d)
    kh, vh = kp.permute(2, 0, 1, 3).contiguous(), vp.permute(2, 0, 1, 3).contiguous()
    pq, pk, pv, pdout, plens, pcu = packed_docs(dev, NEOX_PACK)
    ab, ah, as_ = NEOX_ALIBI_SHAPE
    aq, ak, av = (rnd(ab, as_, ah, d).requires_grad_() for _ in range(3))
    adout = rnd(ab, as_, ah, d)
    slopes = alibi_slopes(ah).to(dev)
    ref_k, ref_pool = kc.clone(), kpool.clone()
    torch.cuda.synchronize()
    reset_counts()
    # With k / v given the API returns (out, (k_cache, v_cache)).
    out_c = flash_attn_with_kvcache(q, kc, vc, kn, vn, cache_seqlens=lens, causal=True)[0]
    out_i = flash_attn_with_kvcache(q, kpool, vpool, kn, vn, cache_seqlens=lens,
                                    cache_batch_idx=pick, causal=True)[0]
    out_p = flash_attn_with_kvcache(q, kp, vp, kn, vn, cache_seqlens=lens, page_table=table,
                                    causal=True)[0]
    out_h = paged_attention(q[:, 0], kh, vh, lens, table)
    out_v = flash_attn_varlen_func(pq, pk, pv, pcu, pcu, causal=True)
    out_v.backward(pdout)
    out_a = flash_attn_func(aq, ak, av, causal=True, alibi_slopes=slopes)
    out_a.backward(adout)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  counted run (kvcache contiguous / cache_batch_idx / native pages, head-major pages, "
        f"varlen and ALiBi forward and backward at 64 x 96): {counts}")
    want = {"flash_decode": 1, "flash_decode_batch_idx": 1, "paged_decode_folded": 1,
            "paged_decode": 1, "flash_fwd_segments": 1, "flash_bwd_segments": 1,
            "flash_fwd_alibi": 1, "flash_bwd_alibi": 1}
    check(all(counts[n] == want.get(n, 0) for n in counts),
          f"phase 21's counted run: expected one launch each of {sorted(want)} and no other")
    # Each step against its plain version on the same (appended) caches.
    lens1 = lens + 1
    errs = {}
    for key, got, fn in (
            ("contiguous", out_c, lambda: flash_attention_decode_plain(
                q.transpose(1, 2), kc, vc, kv_bound=lens1)[0].transpose(1, 2)),
            ("cache_batch_idx", out_i, lambda: flash_attention_decode_plain(
                q.transpose(1, 2), kpool, vpool, kv_bound=lens1,
                cache_batch_idx=pick)[0].transpose(1, 2)),
            ("native_pages", out_p, lambda: paged_attention_folded_plain(q, kp, vp, lens1,
                                                                         table)),
            ("head_major_pages", out_h, lambda: paged_attention_plain(q[:, 0], kh, vh, lens,
                                                                      table))):
        ref = fn()
        errs[key] = (got.float() - ref.float()).abs().max().item()
        check(errs[key] < DECODE_TOL, f"phase 21's counted run: the {key} step disagrees with "
                                      "its plain version")
    # The appends landed where the plain versions read them, and nowhere else.
    rows = torch.arange(b, device=dev)
    ref_k[rows, lens.long()] = kn[:, 0]
    ref_pool[pick.long(), lens.long()] = kn[:, 0]
    check(torch.equal(kc, ref_k) and torch.equal(kpool, ref_pool),
          "phase 21's counted run: the kvcache appends are not where they belong")
    log("  counted run against the plain versions: max|out| err "
        + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items()) + f" (limit {DECODE_TOL})")
    del kc, vc, kpool, vpool, kp, vp, kh, vh, pq, pk, pv, aq, ak, av, ref_k, ref_pool
    torch.cuda.empty_cache()
    return counts, errs


def neox_phase(dev, card):
    """Phase 21: the decode kernel at head dims 80 and 96, and B1's and B7's
    per-batch channels at 96, against their plain versions at the GPT-NeoX
    family's shapes; Pythia-2.8B served at full width and depth (bf16 and
    int8 caches); GPT-NeoX-20B at full width, NEOX_LAYERS layers; the
    kvcache, paged and varlen calls at GPT-NeoX-20B's attention, counted."""
    from liteattention_torch.models.configs import gpt_neox_config

    t0 = time.perf_counter()
    log(f"  (a) the new instantiations against their plain versions [{card}]")
    kres = neox_kernel_phase(dev, card)
    secs = {"a": time.perf_counter() - t0}
    counts, stats = {}, {"part_seconds": secs}
    log(f"  (b) Pythia-2.8B serving, full width and depth ((a) took {secs['a']:.1f} s)")
    counts["pythia_serve"], stats["pythia_2p8b_serve"] = neox_serve(
        dev, card, gpt_neox_config(**PYTHIA_KW), "Pythia-2.8B", PYTHIA_BATCH, PYTHIA_PROMPT,
        PYTHIA_NEW, NEOX_SEED + 1, int8=True)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (c) GPT-NeoX-20B serving, full width, {NEOX_LAYERS} of 44 layers ((b) took "
        f"{secs['b']:.1f} s)")
    counts["neox_serve"], stats["gpt_neox_20b_serve"] = neox_serve(
        dev, card, gpt_neox_config(num_layers=NEOX_LAYERS), f"GPT-NeoX-20B ({NEOX_LAYERS} layers)",
        NEOX_BATCH, NEOX_PROMPT, NEOX_NEW, NEOX_SEED + 2, int8=False)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (d) the kvcache, paged and varlen calls at GPT-NeoX-20B's attention, counted ((c) "
        f"took {secs['c']:.1f} s)")
    counts["neox_attention"], stats["counted_run_max_err"] = neox_attention_run(dev)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  (d) took {secs['d']:.1f} s")
    for key, serve, tag in (("pythia_2p8b_serve", stats["pythia_2p8b_serve"], "pythia_d80"),
                            ("gpt_neox_20b_serve", stats["gpt_neox_20b_serve"], "neox20b_d96")):
        serve["prefill_b1_share_by_kernel_times"] = (
            serve["layers"] * kres[f"fwd_bound_{tag}"]["ms"] / serve["prefill_ms"])
        serve["decode_b8_share_by_kernel_times"] = (
            serve["layers"] * kres[f"decode_{tag}"]["ms"] / serve["decode_ms_per_step"])
        log(f"  {key}: B1's share of the prefill by its time in (a) "
            f"{serve['prefill_b1_share_by_kernel_times']:.1%}, B8's of a decode step "
            f"{serve['decode_b8_share_by_kernel_times']:.1%}")
    return counts, kres, stats


# ---------------------------------------------------------------- phase 22

# Two ranks share the one card over gloo. On torch 2.11.0+cu128 (an H100)
# gloo carries CUDA tensors for all_reduce, broadcast, all_to_all_single,
# all_gather_into_tensor and reduce_scatter_tensor, and a
# DeviceMesh("cuda") over it; its point-to-point calls (batch_isend_irecv,
# send, recv) abort the rank ("writev: Bad address": the TCP pair is handed
# the device pointer). So Ulysses (two all_to_all_single) runs at two
# ranks, and ring attention, whose hops are batch_isend_irecv, runs on the
# card at world size 1 over NCCL, beside every other new entry point.
SP_RANKS = 2
SP_STEPS = 4
SP_THRESHOLDS = [0.0, 0.0, 1.0, 1.0]  # phase 3 (c2)'s, a vote every step
SP_STEP1_TOL = SLICE_AB_TOL  # rel-L2 of step 1's latents, two ranks vs one card
# facebook/opt-1.3b config.json: hidden 2048, 24 layers, 32 heads, ffn
# 8192, vocab 50 272, 2048 positions (opt_config's defaults beside these).
OPT_KW = dict(dim=2048, num_layers=24, num_heads=32)
OPT_BATCH, OPT_PROMPT, OPT_NEW = 8, 512, 16
OPT_SEED = 2323
OPT_TP_TOL = 2e-2  # rel-L2 of a rank's logits shard against the one-rank model's slice
# Greedy ties: where the one-rank model's two best logits lie closer than
# this, a different choice at tp 2 (summed in another order) is a tie.
GREEDY_TIE = 5e-2
PAR_ATTN = (1, 32, 8, 16384, 128)  # Llama-3-8B's attention, causal: ring, Ulysses
PAR_SP_SHAPE = (1, 40, 8192, 128)  # world size 1: make_seq_parallel_attention at Wan's heads
PAR_WAN_GRID = (4, 60, 104)  # world size 1: a 1-block Wan2.1-14B, 6240 tokens
PAR_TIMEOUT = 900  # seconds a spawned rank may take


def _rank_log(rank, msg):
    log(f"  [rank {rank}] {msg}")


def _wan_sp_slice(dev, mesh, card, rank):
    """(a) Wan2.1-14B at full width (2 blocks) sequence-parallel over the
    mesh: denoise with CFG, SP_STEPS steps, a vote every step, driven one
    step at a time through ``denoise(step_range=)`` (the counted run); each
    step's first sequence-parallel attention call recorded."""
    import torch
    from liteattention_torch.models import WanConfig, WanModel, denoise
    from liteattention_torch.parallel import seq_parallel as sp_module

    cfg = dataclasses.replace(WanConfig(), num_layers=SLICE_LAYERS, sp_axis="sp")
    model = WanModel(cfg, device=dev, mesh=mesh)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))  # phase 3's weights
    model.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(1)
    frames, hh, ww = SLICE_GRID
    noise = torch.randn(1, frames, hh, ww, cfg.in_channels, generator=g, device=dev).bfloat16()
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    null = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev).bfloat16()
    common = dict(num_steps=SP_STEPS, guidance_scale=5.0, thresholds=SP_THRESHOLDS)
    denoise(model, noise, text, null, num_steps=1, enable_skipping=False)  # warm-up
    real_step = sp_module._local_step
    calls, steps_ms, sparsity, xs = [], [], [], [noise]

    def recording_step(state, q, k, v, threshold, group, block_sizes, emit_votes, schedule):
        out, lse, new_state = real_step(state, q, k, v, threshold, group, block_sizes,
                                        emit_votes, schedule)
        if len(calls) == len(steps_ms):  # the step's first call: block 0, cond
            calls.append(dict(state=state, q=q, k=k, v=v, thr=float(threshold),
                              schedule=schedule, out=out, lse=lse, new_state=new_state))
        return out, lse, new_state

    sp_module._local_step = recording_step
    st_c = st_u = None
    try:
        torch.distributed.barrier()
        reset_counts()
        for j in range(SP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, tel = denoise(model, xs[-1], text, null, **common, step_range=(j, j + 1),
                             initial_states=st_c, initial_states_uncond=st_u)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            st_c, st_u = tel["final_states"], tel["final_states_uncond"]
            sparsity.append(float(tel["sparsity_per_step"][-1]))
            xs.append(x)
        counts = read_counts()
    finally:
        sp_module._local_step = real_step
    check(all(torch.isfinite(x).all() for x in xs[1:]), "sequence-parallel latents not finite")
    _rank_log(rank, f"(a) Wan2.1-14B width, 2 blocks, {SP_STEPS} steps with CFG over "
              f"{SP_RANKS} ranks: global sparsity per step {[round(s, 4) for s in sparsity]}; "
              f"ms per step {[round(t, 1) for t in steps_ms]} (two ranks share one card: no "
              f"measure of parallel speed) [{card}]")
    _rank_log(rank, f"(a) launches during the counted run: {counts}")
    # Each block, CFG, step: B2 and B3 for the self-attention, B1 for the
    # cross-attention.
    want = SLICE_LAYERS * 2 * SP_STEPS
    got = [counts[n] for n in ("flash_fwd", "schedule_pack", "lite_flash_fwd")]
    check(got == [want] * 3, f"(a): B1 / B2 / B3 launched {got} times, not {want} each")
    return model, (noise, text, null), xs, calls, counts, dict(
        sparsity_per_step=sparsity, ms_per_step=steps_ms)


def _wan_step1_single_card(dev, inputs, x1, card, rank):
    """Step 1 (every tile live) of the single-card model of phase 3 on the
    same seed against the two ranks' step 1."""
    import torch
    from liteattention_torch.models import WanConfig, WanModel, denoise

    cfg = dataclasses.replace(WanConfig(), num_layers=SLICE_LAYERS)
    one = WanModel(cfg, device=dev)
    one.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    one.requires_grad_(False)
    noise, text, null = inputs
    x, _ = denoise(one, noise, text, null, num_steps=SP_STEPS, guidance_scale=5.0,
                   thresholds=SP_THRESHOLDS, step_range=(0, 1))
    err = rel_l2(x1.float(), x.float())
    _rank_log(rank, f"(a) step 1 on {SP_RANKS} ranks vs phase 3's single-card model: rel-L2 "
              f"{err:.3e} (bound {SP_STEP1_TOL})")
    check(err < SP_STEP1_TOL, "(a) the sequence-parallel step 1 departs from one card")
    del one
    torch.cuda.empty_cache()
    return err


def _check_sp_call(j, call, group, rank):
    """A later step's recorded sequence-parallel call recomputed by the
    plain versions over this rank's own live tiles: the packer's schedule
    bit for bit, the merged out (OUT_TOL) and lse (LSE_TOL, -inf on the
    same rows), and the new mask shard (tiles may differ only where a vote
    lies within MARGIN of the threshold)."""
    import torch
    from liteattention_torch.ops.combine import combine_attention_psum
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention_plain, vote_headroom
    from liteattention_torch.ops.mask import update_mask
    from liteattention_torch.ops.schedule_pack import pack_schedule_plain

    m = call["state"].do_mask
    fidx, count = pack_schedule_plain(m)
    if call["schedule"] is not None:
        check(all(torch.equal(a, b) for a, b in zip(call["schedule"], (fidx, count))),
              f"(a) step {j + 1}: B2's schedule differs from its plain version")
    q, k, v, thr = call["q"], call["k"], call["v"], call["thr"]
    ro, rl, rv = lite_flash_attention_plain(q, k, v, fidx, count, thr, m)
    po, pl = combine_attention_psum(ro, rl, group)
    err_o = (call["out"].float() - po.float()).abs().max().item()
    seen = torch.isfinite(pl)
    same_rows = torch.equal(seen, torch.isfinite(call["lse"]))
    err_l = (call["lse"] - pl)[seen].abs().max().item() if seen.any() else 0.0
    head = vote_headroom(q, k, fidx, count)
    valid = torch.arange(m.shape[-1], device=m.device) < count[..., None]
    margin = torch.where(valid, (head - thr).abs(), torch.full_like(head, math.inf))
    near = torch.full(m.shape, math.inf, device=m.device)
    near.scatter_reduce_(-1, fidx.long(), margin, reduce="amin")
    want = update_mask(call["state"], rv).do_mask
    diff = want != call["new_state"].do_mask
    bad = int((diff & (near >= MARGIN)).sum())
    _rank_log(rank, f"(a) step {j + 1}, block 0 (cond): the merged out against the plain versions "
              f"over this rank's live tiles max|err| {err_o:.3e} (bound {OUT_TOL}), merged lse "
              f"{err_l:.3e} (bound {LSE_TOL}, -inf rows the same: {same_rows}); new mask shard: "
              f"{int(diff.sum())} tiles differ, {bad} outside the {MARGIN} margin; shard sparsity "
              f"{1 - m.float().mean().item():.4f}")
    check(err_o < OUT_TOL and err_l < LSE_TOL and same_rows and bad == 0,
          f"(a) step {j + 1} disagrees with its plain versions")
    return err_o, err_l


def _opt_tp_run(dev, group, card, rank):
    """(b) OPT-1.3B at full width and depth, tensor-parallel over the
    group: every rank builds the one-rank model from the seed, keeps its
    reference (prompt logits, greedy tokens by recompute), slices its shard
    of the weights and drops the model; then the counted run serves
    OPT_BATCH prompts of OPT_PROMPT tokens and OPT_NEW greedy tokens by
    recompute through gpt_tp_apply."""
    import torch
    from liteattention_torch.models import GPTLMHeadModel, opt_config
    from liteattention_torch.models.gpt import gpt_tp_apply, gpt_tp_state_dict
    from liteattention_torch.parallel._collectives import all_gather_dim

    cfg = opt_config(**OPT_KW)
    tp, r = group.size(), group.rank()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(OPT_SEED))
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.randint(0, cfg.vocab_size, (OPT_BATCH, OPT_PROMPT),
                        generator=torch.Generator(device=dev).manual_seed(OPT_SEED + 1), device=dev)
    v_loc = cfg.vocab_size // tp
    with torch.no_grad():
        ref_prompt = model(ids)[..., r * v_loc:(r + 1) * v_loc].clone()
        ref_seq, ref_last = ids, []
        for _ in range(OPT_NEW):
            last = model(ref_seq)[:, -1]
            ref_last.append(last)
            ref_seq = torch.cat([ref_seq, last.argmax(-1, keepdim=True)], dim=1)
        shard = {k: v.clone() for k, v in gpt_tp_state_dict(cfg, model.state_dict(), r, tp).items()}
    del model
    torch.cuda.empty_cache()
    shard_params = sum(v.numel() for v in shard.values())
    with torch.no_grad():  # warm-up: the first call builds gpt_tp_apply's meta skeleton
        gpt_tp_apply(cfg, shard, ids, group)
    torch.distributed.barrier(group)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        seq, step_ms, prompt_local = ids, [], None
        for i in range(OPT_NEW):
            t1 = time.perf_counter()
            local = gpt_tp_apply(cfg, shard, seq, group)
            if prompt_local is None:
                prompt_local = local
            last = all_gather_dim(local[:, -1].contiguous(), 1, group)
            seq = torch.cat([seq, last.argmax(-1, keepdim=True)], dim=1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    err = rel_l2(prompt_local, ref_prompt)
    tp_tokens, ref_tokens = seq[:, OPT_PROMPT:], ref_seq[:, OPT_PROMPT:]
    same = tp_tokens == ref_tokens
    diverged = [(b, int((~same[b]).nonzero()[0])) for b in range(OPT_BATCH) if not same[b].all()]
    gaps = []
    for b, t in diverged:  # the first difference of each sequence must be a tie
        top2 = ref_last[t][b].float().topk(2).values
        gaps.append(float(top2[0] - top2[1]))
    _rank_log(rank, f"(b) OPT-1.3B ({n_params / 1e9:.3f} B parameters, this rank's shard "
              f"{shard_params / 1e9:.3f} B) at tp {tp}: prompt logits shard vs the one-rank model's "
              f"rel-L2 {err:.3e} (bound {OPT_TP_TOL}); greedy tokens equal in "
              f"{int(same.all(-1).sum())} of {OPT_BATCH} sequences, first differences "
              f"{diverged} at top-2 gaps {[round(gp, 4) for gp in gaps]} (ties below {GREEDY_TIE}); "
              f"{total_ms / OPT_NEW:.1f} ms per recompute step (prompt step {step_ms[0]:.1f} ms; two "
              f"ranks share one card) [{card}]")
    _rank_log(rank, f"(b) launches during the counted run: {counts}")
    check(err < OPT_TP_TOL, "(b) the tensor-parallel logits depart from the one-rank model")
    check(all(gp < GREEDY_TIE for gp in gaps), "(b) a greedy token differs where no tie is")
    want = cfg.num_layers * OPT_NEW
    check(counts["flash_fwd"] == want,
          f"(b) {counts['flash_fwd']} causal B1 launches, not {want} (one a layer a step)")
    return counts, dict(logits_rel_l2=err, sequences_equal=int(same.all(-1).sum()),
                        first_differences=diverged, top2_gaps=gaps,
                        ms_per_recompute_step=total_ms / OPT_NEW, params=n_params,
                        shard_params=shard_params)


def _attn_inputs(dev, seed, grad=False):
    import torch

    b, h, hk, s, d = PAR_ATTN
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, n, s, d, generator=g, device=dev).bfloat16()
               for n in (h, hk, hk))
    dout = torch.randn(b, h, s, d, generator=g, device=dev).bfloat16()
    if grad:
        q, k, v = (x.requires_grad_() for x in (q, k, v))
    return q, k, v, dout


def _one_card_grads(q, k, v, dout):
    """B1 and B7 over the whole sequence (flash_attention's autograd)."""
    import torch
    from liteattention_torch.ops.flash_fwd import flash_attention

    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = flash_attention(qs, ks, vs, causal=True)
    out.backward(dout)
    return out.detach(), (qs.grad, ks.grad, vs.grad)


def _context_parallel(name, fn, dev, mesh, rank, card):
    """``fn`` (ring_self_attention or ulysses_self_attention) causal at
    PAR_ATTN, forward and backward, counted, against B1 and B7 over the
    whole sequence on this card."""
    import torch

    q, k, v, dout = _attn_inputs(dev, 4545, grad=True)
    fn(q, k, v, mesh, "sp", causal=True).backward(dout)  # warm-up
    for x in (q, k, v):
        x.grad = None
    torch.distributed.barrier(mesh.get_group("sp"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(q, k, v, mesh, "sp", causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    ref, grads = _one_card_grads(q, k, v, dout)
    err_o = rel_l2(out.detach(), ref)
    err_g = max(rel_l2(x.grad, gr) for x, gr in zip((q, k, v), grads))
    n = mesh.get_group("sp").size()
    _rank_log(rank, f"{name} over {n} rank(s), 1x{PAR_ATTN[1]}/{PAR_ATTN[2]}x{PAR_ATTN[3]}x"
              f"{PAR_ATTN[4]} causal: out vs B1 over the whole sequence rel-L2 {err_o:.3e}, "
              f"dq/dk/dv vs B7 worst rel-L2 {err_g:.3e} (bound {BWD_TOL}); forward + backward "
              f"{ms:.1f} ms; launches {counts} [{card}]")
    check(err_o < BWD_TOL and err_g < BWD_TOL, f"{name} disagrees with one card")
    check(counts["flash_fwd"] > 0 and counts["flash_bwd_dq"] > 0,
          f"{name}: B1 or B7 never launched")
    return counts, dict(out_rel_l2=err_o, grad_rel_l2=err_g, ms=ms, ranks=n)


def _pair_body(rank, dev, mesh, card):
    """The two gloo ranks: (a) Wan sequence parallel, (b) OPT tensor
    parallel, (c) Ulysses."""
    import torch
    from liteattention_torch.parallel import ulysses_self_attention

    group = mesh.get_group("sp")
    out = {"counts": {}, "stats": {}}
    model, inputs, xs, calls, counts, stats = _wan_sp_slice(dev, mesh, card, rank)
    out["counts"]["sp_wan"] = counts
    del model
    torch.cuda.empty_cache()
    errs = [_check_sp_call(j, call, group, rank) for j, call in enumerate(calls) if j > 0]
    stats["later_steps_out_err"] = [e[0] for e in errs]
    stats["later_steps_lse_err"] = [e[1] for e in errs]
    if rank == 0:
        stats["step1_rel_l2_vs_one_card"] = _wan_step1_single_card(dev, inputs, xs[1], card, rank)
    torch.distributed.barrier(group)
    del calls, xs
    torch.cuda.empty_cache()
    out["stats"]["wan_sp"] = stats
    out["counts"]["tp_opt"], out["stats"]["opt_tp"] = _opt_tp_run(dev, group, card, rank)
    torch.cuda.empty_cache()
    out["counts"]["ulysses"], out["stats"]["ulysses"] = _context_parallel(
        "Ulysses", ulysses_self_attention, dev, mesh, rank, card)
    return out


def _nccl1_body(rank, dev, mesh, card):
    """World size 1 over NCCL: every new entry point against its one-card
    form (the comparisons are bit for bit where the path runs the same
    kernels on the same inputs), then ring attention, counted."""
    import torch
    import torch.nn.functional as F
    from liteattention_torch.lite_attention import lite_attention_step
    from liteattention_torch.models import (
        GPTLMHeadModel, WanConfig, WanModel, denoise, opt_config)
    from liteattention_torch.models.gpt import gpt_tp_apply, gpt_tp_state_dict
    from liteattention_torch.modules import MHA, GatedMlp, ParallelMHA, ParallelMLP
    from liteattention_torch.modules.mha import parallel_mha_state_dict
    from liteattention_torch.modules.mlp import parallel_mlp_state_dict
    from liteattention_torch.ops.combine import combine_attention, combine_attention_psum
    from liteattention_torch.ops.flash_fwd import flash_attention
    from liteattention_torch.ops.mask import init_mask
    from liteattention_torch.parallel import (
        make_seq_parallel_attention, ring_attention_local, ring_self_attention,
        ulysses_attention_local, ulysses_self_attention)
    from liteattention_torch.parallel import tensor_parallel as tpm

    group = mesh.get_group("sp")
    g = torch.Generator(device=dev).manual_seed(5656)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    same = {}
    b, h, s, d = PAR_SP_SHAPE
    o, l_ = rnd(b, h, s, d), torch.randn(b, h, s, generator=g, device=dev)
    po, pl = combine_attention_psum(o, l_, group)
    co, cl = combine_attention(o[None], l_[None])
    same["combine_attention_psum"] = torch.equal(po, co) and torch.equal(pl, cl)
    init_fn, step_fn = make_seq_parallel_attention(mesh, "sp")
    q, k, v = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d)
    st = init_fn(b, h, s, s, d)
    one = init_mask(b, h, s, s, 128, 128, device=dev)
    ok = True
    for thr in (0.0, 1.0):
        so, _, st = step_fn(st, q, k, v, thr)
        oo, one = lite_attention_step(one, q, k, v, thr)
        ok = ok and torch.equal(so, oo) and torch.equal(st.do_mask, one.do_mask)
    same["make_seq_parallel_attention"] = ok
    cfg = dataclasses.replace(WanConfig(), num_layers=1)
    wan_sp = WanModel(dataclasses.replace(cfg, sp_axis="sp"), device=dev, mesh=mesh)
    wan_sp.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    wan_one = WanModel(cfg, device=dev)
    wan_one.load_state_dict(wan_sp.state_dict())
    noise = torch.randn(1, *PAR_WAN_GRID, cfg.in_channels, generator=g, device=dev).bfloat16()
    text, null = rnd(1, cfg.text_len, cfg.text_dim), rnd(1, cfg.text_len, cfg.text_dim)
    with torch.no_grad():
        xs, ts = denoise(wan_sp, noise, text, null, num_steps=2, thresholds=[0.0, 1.0])
        xo, to = denoise(wan_one, noise, text, null, num_steps=2, thresholds=[0.0, 1.0])
    same["WanModel(sp_axis) denoise"] = (torch.equal(xs, xo) and torch.equal(
        ts["sparsity_per_step"], to["sparsity_per_step"]))
    del wan_sp, wan_one
    qa, ka, va, dout = _attn_inputs(dev, 4646)
    ro, rl = ring_attention_local(qa, ka, va, group, causal=True, return_lse=True)
    fo, fl = flash_attention(qa, ka, va, causal=True, return_lse=True)
    same["ring_attention_local"] = torch.equal(ro, fo) and torch.equal(rl, fl)
    same["ulysses_attention_local"] = torch.equal(
        ulysses_attention_local(qa, ka, va, group, causal=True), fo)
    same["ulysses_self_attention"] = torch.equal(
        ulysses_self_attention(qa, ka, va, mesh, "sp", causal=True), fo)
    del qa, ka, va, dout
    x, w, b = rnd(4, 256, 1024), rnd(2048, 1024), rnd(2048)
    emb, pos, ids = rnd(4096, 1024), rnd(512, 1024), torch.randint(0, 4096, (4, 256), device=dev)
    same["column_parallel_dense"] = all(torch.equal(y, F.linear(x, w, b)) for y in (
        tpm.column_parallel_dense(x, w, b), tpm.column_parallel_dense(x, w, b, group)))
    # The row-parallel bias is added after the sum, as in JAX (not in the GEMM).
    same["row_parallel_dense"] = all(torch.equal(y, F.linear(x, w) + b) for y in (
        tpm.row_parallel_dense(x, w, b, group), tpm.row_parallel_dense(x, w, b, group, True)))
    look = F.embedding(ids, emb)
    same["vocab_parallel_embedding"] = torch.equal(tpm.vocab_parallel_embedding(ids, emb, group),
                                                   look)
    same["column_parallel_embedding"] = torch.equal(tpm.column_parallel_embedding(ids, emb), look)
    same["parallel_gpt2_embeddings"] = torch.equal(
        tpm.parallel_gpt2_embeddings(ids, emb, pos, group=group), look + pos[:256])
    same["vocab_parallel_logits"] = torch.equal(tpm.vocab_parallel_logits(x, emb), x @ emb.T)
    close = {}  # rel-L2: the out-projection bias added after the sum, not in the GEMM
    with torch.no_grad():
        dim, heads = OPT_KW["dim"], OPT_KW["num_heads"]  # OPT-1.3B's attention and MLP widths
        xm = rnd(4, 512, dim)
        mha = MHA(dim, heads, causal=True, device=dev)
        pmha = ParallelMHA(dim, heads, group, causal=True, device=dev)
        pmha.load_state_dict(parallel_mha_state_dict(mha.state_dict(), heads, 0, 1))
        close["ParallelMHA"] = rel_l2(pmha(xm), mha(xm))
        mlp = GatedMlp(dim, 4 * dim, device=dev)
        pmlp = ParallelMLP(dim, 4 * dim, group, activation=F.silu, gated=True, device=dev)
        pmlp.load_state_dict(parallel_mlp_state_dict(mlp.state_dict(), 0, 1, gated=True))
        same["ParallelMLP"] = torch.equal(pmlp(xm), mlp(xm))
        ocfg = opt_config(**{**OPT_KW, "num_layers": 2})
        gpt = GPTLMHeadModel(ocfg, device=dev)
        gpt.reset_parameters(torch.Generator(device=dev).manual_seed(OPT_SEED))
        ids = torch.randint(0, ocfg.vocab_size, (4, 512), device=dev)
        close["gpt_tp_apply"] = rel_l2(
            gpt_tp_apply(ocfg, gpt_tp_state_dict(ocfg, gpt.state_dict(), 0, 1), ids, group),
            gpt(ids))
    _rank_log(rank, f"every new entry point at world size 1 over NCCL against its one-card form: "
              f"bit for bit {same}; rel-L2 {close} (bound {OPT_TP_TOL})")
    check(all(same.values()) and all(e < OPT_TP_TOL for e in close.values()),
          "a new entry point at world size 1 departs from its one-card form")
    del gpt, mha, pmha, mlp, pmlp
    torch.cuda.empty_cache()
    counts, stats = _context_parallel("ring attention", ring_self_attention, dev, mesh, rank, card)
    return {"counts": {"ring_nccl1": counts},
            "stats": {"ring": stats, "world1_equal": same, "world1_rel_l2": close}}


def parallel_rank(rank, world, backend, out_dir, card, body=None):
    """A spawned rank of phase 22 or 23: joins the group through a file in
    ``out_dir``, runs its part (``body``; phase 22's by default), writes
    its counts and stats (or its failure) to ``out_dir``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    path = Path(out_dir) / f"{backend}{world}_rank{rank}.json"
    try:
        dist.init_process_group(backend, init_method=f"file://{out_dir}/rendezvous", rank=rank,
                                world_size=world)
        mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("sp",))
        if body is None:
            body = _pair_body if world > 1 else _nccl1_body
        result = body(rank, dev, mesh, card)
        dist.barrier()
        path.write_text(json.dumps(result))
    except Exception as e:  # noqa: BLE001 -- reported to the parent, which fails
        import traceback

        path.write_text(json.dumps({"error": f"{type(e).__name__}: {e}",
                                    "trace": traceback.format_exc()}))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(world, backend, card, body=None, label="phase 22"):
    """Run ``world`` ranks of ``body`` (phase 22's by default) over
    ``backend``; every rank's result (a failure of any fails the phase;
    every process is stopped)."""
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=parallel_rank,
                             args=(r, world, backend, out_dir, card, body))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + PAR_TIMEOUT
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(procs):
            f = Path(out_dir) / f"{backend}{world}_rank{r}.json"
            res = json.loads(f.read_text()) if f.exists() else {
                "error": f"no result (exit code {p.exitcode})"}
            if "error" in res:
                log(res.get("trace", ""))
            check("error" not in res and p.exitcode == 0,
                  f"{label}: {backend} rank {r} of {world} failed: {res.get('error')}")
            results.append(res)
    return results


def parallel_phase(dev, card):
    """Phase 22: parallel/ on torch.distributed. Two ranks on the one card
    over gloo run (a) Wan2.1-14B-width sequence-parallel denoising, (b)
    OPT-1.3B tensor-parallel greedy serving and (c) Ulysses at Llama-3-8B's
    attention; one rank over NCCL runs every new entry point against its
    one-card form and ring attention (gloo has no CUDA point-to-point)."""
    import torch

    log(f"  ring attention: world size 1 over NCCL (gloo has no CUDA point-to-point: "
        f"batch_isend_irecv aborts a rank); Ulysses: {SP_RANKS} ranks over gloo "
        f"(all_to_all_single carries CUDA tensors)")
    log(f"  every kernel the ranks load was built in phase 1: "
        f"{torch.cuda.device_count()} card(s), {SP_RANKS} ranks sharing card 0")
    t0 = time.perf_counter()
    pair = _spawn_ranks(SP_RANKS, "gloo", card)
    t1 = time.perf_counter()
    solo = _spawn_ranks(1, "nccl", card)
    t2 = time.perf_counter()
    counts = {}
    for path in ("sp_wan", "tp_opt", "ulysses"):
        per_rank = [r["counts"][path] for r in pair]
        counts[path] = {name: sum(c[name] for c in per_rank) for name in per_rank[0]}
    counts["ring_nccl1"] = solo[0]["counts"]["ring_nccl1"]
    stats = {"ranks": [r["stats"] for r in pair], "nccl1": solo[0]["stats"],
             "seconds": {"gloo_pair": t1 - t0, "nccl_world1": t2 - t1}}
    log(f"  phase 22 launches (summed over ranks): {counts}")
    return counts, stats


# ---------------------------------------------------------------- phase 23

# The training half of parallel/ at two ranks sharing the one card over gloo
# (NCCL refuses two ranks on one device), each at the published width of a
# model the repo trains or serves. Times of two ranks on one card over gloo
# are no measure of parallel speed: gloo stages every CUDA collective
# through the host.
# (a) run.data_parallel through train.py: phase 17's gpt2s-moe run (GPT-2
# small's width and depth, 4 experts top-2, 8 x 1024 tokens a global
# batch), 4 steps of ZeRO-2 with the bfloat16 wire, then 2 steps each of
# plain data parallelism, ZeRO-1 and ZeRO-2 (its reduce-scatter: the wire
# takes the all-reduce); each against the unmodified one-rank run on the
# same global batches (the ranks' MoE layers route the global batch as one
# device does, modules/moe.py:data_parallel_routing). Tolerances are JAX's
# own for its data-parallel step against one device
# (tests/test_training.py): loss 2e-3 absolute and grad norm 2e-2
# relative; with the bfloat16 wire JAX's bounds for that wire, 2e-2 and
# 5e-2. Once the parameters have moved (the steps after the first update
# with lr > 0), the grad norm within DP_MOVED_GN_RTOL: these early AdamW
# steps amplify rounding, so that at step 4 two runs of the same
# ZeRO-2 + bf16 code already part by 2.27e-2-3.14e-2 and the data-parallel
# run lies 1.87e-2-5.21e-2 from the one rank (3 x 2 pairs; dp_spread.py on
# the H100), against 1.0e-3 and less at the initial parameters. The update
# (the parameters less their initial values) within DP_UPDATE_TOL rel-L2 of
# the one-rank run's: an update skipped reads 1, one of the wrong sign 2,
# ZeRO slices never gathered back 1 (half of them 0.7); the first step's lr
# is 0, so the loss and the grad norm of a 2-step run see no update. The
# sound run reads about 0.18 on the H100: the one rank multiplies 8192 rows
# where a rank multiplies 4096, so the bf16 products round otherwise, and
# AdamW's first steps, near sign(g), flip the elements whose gradient is
# that noise. Before the runs, the routing itself is held
# exactly: at GPT-2 small MoE's layer (768 wide, 4 experts top-2) over 8 x
# 1024 bf16 tokens, each rank's half routed over the group takes the same
# experts and drops the same (token, slot) pairs as one device routing
# all of them, at the model's capacity factor and at DP_ROUTE_FACTORS' 0.5
# (many drops); the ranks' aux losses average to the whole batch's within
# EP_AUX_RTOL. Routing each half alone is logged beside it.
DP_BASE = [o for o in MOE_OVERRIDES if not o.startswith("run.steps=")]
DP_RUNS = [("zero2_bf16", 4, ["trainer.shard_grads=true", "trainer.grad_comm_dtype=bfloat16"]),
           ("plain", 2, []), ("zero1", 2, ["trainer.shard_opt_state=true"]),
           ("zero2", 2, ["trainer.shard_grads=true"])]
DP_LOSS_ATOL, DP_GN_RTOL = 2e-3, 2e-2
DP_BF16_LOSS_ATOL, DP_BF16_GN_RTOL = 2e-2, 5e-2
DP_MOVED_GN_RTOL = 0.1
DP_UPDATE_TOL = 0.5
DP_ROUTE_FACTORS = (1.25, 0.5)
# ZeRO-1/2 hold each AdamW state tensor's half on a rank.
DP_STATE_SHARE = 0.55
# (b) OPT-1.3B (phase 22's model, full depth) at tp 2: one training
# forward and backward, 2 x 1024 tokens, through GPTLMHeadModel(cfg,
# group=g) and parallel_cross_entropy_loss, against the one-rank dense
# model with cross_entropy_loss: the loss 1e-2 relative; all the rank's
# gradient shards together within SMALL_GRAD_TOL (5e-2 rel-L2: both bf16,
# the row-parallel sums of bf16 partials in another order), and each
# tensor within GRAD_TENSOR_TOL (a norm's bias gradient is a sum over
# tokens that mostly cancels, so its rounding reads large; a missing sum
# over the ranks or a wrong shard reads 0.5 or more). The witness that
# the gap is bf16's rounding: at this shape the dense bf16 model's
# gradient shards lie 4.64e-2 from the same model's in fp32
# (tp_grad_witness.py on the H100), and the tensor-parallel shards read
# 4.03e-2-4.04e-2 from the dense bf16 ones in every run.
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 2, 1024
TP_LOSS_RTOL = 1e-2
GRAD_TENSOR_TOL = 0.2
# (c) pipeline_apply at pp 2 over GPT-2 XL's 48 blocks
# (openai-community/gpt2-xl config.json: n_embd 1600, n_layer 48, n_head
# 25), 24 a stage, 4 x 1024 tokens in 4 microbatches, forward and backward,
# against the same stages run one after another on one rank, microbatch by
# microbatch: the output rel-L2 1e-6 (the same kernels on the same shapes;
# the hop copies), the stage's gradients together 1e-2 (B7's dQ adds by
# atomics, and the two accumulate the microbatches in other orders) and
# each tensor within GRAD_TENSOR_TOL.
PP_DIM, PP_LAYERS, PP_HEADS = 1600, 48, 25
PP_BATCH, PP_SEQ, PP_MICRO = 4, 1024, 4
PP_OUT_TOL, PP_GRAD_TOL = 1e-6, 1e-2
# (d) moe_apply_sharded at ep 2: GPT-2 small MoE's layer (768 -> 3072, 4
# experts, 2 a rank, bf16 experts, the fp32 router), 8 x 1024 tokens a
# rank, against moe_forward on one rank over each rank's tokens at the same
# capacity: the output and the gradients 2e-2 rel-L2 (MOE_LAYER_TOL; the
# experts' products over other row counts), the aux loss 1e-5 relative.
EP_TOKENS, EP_DIM, EP_HIDDEN, EP_EXPERTS = 8 * 1024, 768, 3072, 4
EP_AUX_RTOL = 1e-5
PP_SEED, TP_TRAIN_SEED, EP_SEED = 2424, 2525, 2626


def _param_sums(params):
    """Per tensor (sum, sum of squares) in float64: equal on two ranks
    that hold the same bits."""
    return {k: [float(v.double().sum()), float(v.double().square().sum())]
            for k, v in params.items()}


def _dp_train_run(rank, card, name, steps, extra, data_parallel=True):
    """One ``liteattention_torch.train.run`` of DP_BASE for ``steps``
    steps (the counted run when data-parallel; without ``data_parallel``
    the one-rank run, and at 0 steps the initial parameters): its records,
    its parameters (a copy), the AdamW state bytes this rank holds and the
    launches."""
    import torch
    from liteattention_torch import train as train_cli
    from liteattention_torch.training.trainer import warmup_cosine_lr

    root = str(ROOT / "configs" / "config.yaml")
    argv = ["--config", root, *DP_BASE, f"run.steps={steps}",
            *(["run.data_parallel=true", *extra] if data_parallel else []),
            "--device", "cuda", "--log-every", "1"]
    torch.cuda.synchronize()
    reset_counts()
    recs = []
    trainer = train_cli.run(argv, log_fn=recs.append)
    torch.cuda.synchronize()
    counts = read_counts()
    state_bytes = sum(v.numel() * v.element_size() for st in trainer.opt.state.values()
                      for v in st.values() if torch.is_tensor(v))
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    lrs = [warmup_cosine_lr(trainer.cfg, i) for i in range(steps)]
    out = dict(recs=[{k: r[k] for k in ("loss", "grad_norm", "steps_per_s")} for r in recs],
               state_bytes=state_bytes, world=trainer.world, lrs=lrs, lr_sum=sum(lrs),
               ms_per_step=[1e3 / r["steps_per_s"] for r in recs])
    if data_parallel:
        _rank_log(rank, f"(a) {name}: {steps} steps at dp {trainer.world} "
                  f"(ZeRO split dims {sum(d is not None for d in trainer.shard_dims.values())} of "
                  f"{len(trainer.shard_dims) or len(params)} tensors, wire "
                  f"{trainer.comm_dtype}): loss {[round(r['loss'], 4) for r in recs]}, ms/step "
                  f"{[round(m, 1) for m in out['ms_per_step']]}, AdamW state on this rank "
                  f"{state_bytes / 1e9:.3f} GB; launches {counts['flash_fwd']} B1, "
                  f"{counts['flash_bwd_dq']} B7 [{card}]")
    del trainer
    torch.cuda.empty_cache()
    return out, params, counts


def _dp_routing_check(dev, group, card, rank):
    """(a)'s routing: each rank's half of 8 x 1024 tokens routed over the
    group against one device routing all of them (and against the half
    routed alone)."""
    import torch
    import torch.distributed as dist
    from liteattention_torch.modules.moe import _route_indices, capacity_for, init_moe_params

    g = torch.Generator(device=dev).manual_seed(EP_SEED + 1)
    params = init_moe_params(g, EP_DIM, EP_HIDDEN, EP_EXPERTS, torch.bfloat16, device=dev)
    x = torch.randn(EP_TOKENS, EP_DIM, generator=g, device=dev).bfloat16()
    n, r = group.size(), group.rank()
    t = EP_TOKENS // n
    mine = slice(r * t, (r + 1) * t)
    out = {}
    for factor in DP_ROUTE_FACTORS:
        cap = capacity_for(EP_TOKENS, EP_EXPERTS, 2, factor)
        _, e_all, _, _, k_all, aux_all = _route_indices(x, params["router"], 2, cap)
        _, e_dp, _, _, k_dp, aux_dp = _route_indices(x[mine], params["router"], 2, cap, group)
        _, _, _, _, k_alone, _ = _route_indices(x[mine], params["router"], 2,
                                                capacity_for(t, EP_EXPERTS, 2, factor))
        aux_dp = aux_dp.clone()
        dist.all_reduce(aux_dp, group=group)
        aux_err = abs(float(aux_dp) / n - float(aux_all)) / float(aux_all)
        moved = int((e_dp != e_all[mine]).sum()) + int((k_dp != k_all[mine]).sum())
        alone = int((k_alone != k_all[mine]).sum())
        out[str(factor)] = dict(dropped=float(1 - k_all.float().mean()), moved=moved,
                                moved_alone=alone, aux_rel_err=aux_err)
        _rank_log(rank, f"(a) routing at capacity factor {factor} ({cap} slots an expert, "
                  f"{out[str(factor)]['dropped']:.4f} of (token, slot) pairs dropped): this "
                  f"rank's {t} tokens routed over the group differ from one device's in {moved} "
                  f"experts and drops, routed alone in {alone} drops; aux rel {aux_err:.2e} "
                  f"[{card}]")
        check(moved == 0, f"(a) routing over the group departs from one device's at {factor}")
        check(aux_err <= EP_AUX_RTOL, f"(a) the ranks' aux losses at {factor} do not average "
              "to one device's")
    check(out["0.5"]["moved_alone"] > 0, "(a) routing alone drops what one device drops: "
          "the check cannot tell the two apart")
    return out


def _dp_phase(rank, group, card):
    """(a): the data-parallel runs on both ranks; on rank 0 the one-rank
    runs on the same global batches, and the checks."""
    import torch
    import torch.distributed as dist

    routing = _dp_routing_check(torch.device("cuda", 0), group, card, rank)
    counts, runs, params = {}, {}, {}
    for name, steps, extra in DP_RUNS:
        runs[name], params[name], c = _dp_train_run(rank, card, name, steps, extra)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        runs[name]["param_sums"] = _param_sums(params[name])
    stats = {"runs": runs, "routing": routing}
    failed = []
    if rank == 0:
        refs = {}
        _, init, _ = _dp_train_run(rank, card, "initial", 0, [], data_parallel=False)

        def update(p):
            return torch.cat([(p[k].float() - v.float()).flatten() for k, v in init.items()])

        for steps in sorted({s for _, s, _ in DP_RUNS}):
            refs[steps], ref_params, _ = _dp_train_run(rank, card, "one rank", steps, [],
                                                       data_parallel=False)
            for name, s, _ in DP_RUNS:
                if s != steps:
                    continue
                run, got = runs[name], params[name]
                worst = max((float((got[k].float() - v.float()).abs().max()), k)
                            for k, v in ref_params.items())
                rel = rel_l2(torch.cat([v.float().flatten() for v in got.values()]),
                             torch.cat([v.float().flatten() for v in ref_params.values()]))
                upd = rel_l2(update(got), update(ref_params))
                dl = [abs(a["loss"] - b["loss"]) for a, b in zip(run["recs"], refs[steps]["recs"])]
                dg = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                      for a, b in zip(run["recs"], refs[steps]["recs"])]
                share = run["state_bytes"] / refs[steps]["state_bytes"]
                loss_tol, gn_tol = ((DP_BF16_LOSS_ATOL, DP_BF16_GN_RTOL) if "bf16" in name
                                    else (DP_LOSS_ATOL, DP_GN_RTOL))
                lrs = refs[steps]["lrs"]
                gn_tols = [DP_MOVED_GN_RTOL if sum(lrs[:i]) > 0 else gn_tol
                           for i in range(len(dg))]
                _rank_log(rank, f"(a) {name} against the one-rank run: loss |diff| "
                          f"{[f'{x:.2e}' for x in dl]} (bound {loss_tol}), grad norm rel "
                          f"{[f'{x:.2e}' for x in dg]} (bounds {gn_tols}); the update's rel-L2 "
                          f"{upd:.3e} (bound {DP_UPDATE_TOL}); parameters: largest |diff| "
                          f"{worst[0]:.3e} in {worst[1]} (sum of lr {refs[steps]['lr_sum']:.2e}), "
                          f"rel-L2 of all {rel:.3e}; AdamW state on a rank {share:.4f} of the "
                          f"one rank's {refs[steps]['state_bytes'] / 1e9:.3f} GB")
                # Every run logs before a failure is raised.
                failed += [f"(a) {name}: {what}" for ok, what in (
                    (max(dl) <= loss_tol, "the loss departs from one rank's"),
                    (all(d <= b for d, b in zip(dg, gn_tols)),
                     "the grad norm departs from one rank's"),
                    (upd <= DP_UPDATE_TOL, "the update departs from one rank's"),
                    ((share <= DP_STATE_SHARE) == (name != "plain"),
                     f"the AdamW state a rank holds is {share:.3f} of one rank's")) if not ok]
                run.update(loss_abs_diff=dl, grad_norm_rel_diff=dg, update_rel_l2=upd,
                           param_max_abs_diff=worst[0], param_rel_l2=rel, state_share=share)
            del ref_params
            torch.cuda.empty_cache()
        del init
        stats["one_rank"] = refs
    dist.barrier(group)
    check(not failed, "; ".join(failed))
    want = 12 * sum(s for _, s, _ in DP_RUNS)
    check(counts["flash_fwd"] == want and counts["flash_bwd_dq"] == want,
          f"(a) {counts['flash_fwd']} B1 and {counts['flash_bwd_dq']} B7 launches on rank "
          f"{rank}, not {want} each (12 a step)")
    del params
    torch.cuda.empty_cache()
    return counts, stats


def tp_grad_apart(got, want):
    """(b)'s comparison of gradient shards: per tensor rel-L2, and all the
    tensors together (float64, on ``want``'s device)."""
    import torch

    errs, diff2, ref2 = {}, 0.0, 0.0
    for k, w in want.items():
        g, w = got[k].double().to(w.device), w.double()
        if k.endswith("Wqkv.bias"):  # q | k | v local: the k part's exact gradient is 0
            dl = w.shape[0] // 3
            keep = torch.cat([torch.arange(dl), torch.arange(2 * dl, 3 * dl)]).to(w.device)
            g, w = g[keep], w[keep]
        errs[k] = rel_l2(g, w)
        diff2 += float((g - w).square().sum())
        ref2 += float(w.square().sum())
    return errs, math.sqrt(diff2 / ref2)


def _tp_train_step(dev, group, card, rank):
    """(b): OPT-1.3B at tp 2, one training forward and backward."""
    import torch
    from liteattention_torch.losses import cross_entropy_loss, parallel_cross_entropy_loss
    from liteattention_torch.models import GPTLMHeadModel, opt_config
    from liteattention_torch.models.gpt import gpt_tp_state_dict

    cfg = opt_config(**OPT_KW)
    tp, r = group.size(), group.rank()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(TP_TRAIN_SEED))
    ids = torch.randint(0, cfg.vocab_size, (TP_TRAIN_BATCH, TP_TRAIN_SEQ), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(TP_TRAIN_SEED + 1))
    dense_loss = cross_entropy_loss(model(ids)[:, :-1], ids[:, 1:])
    dense_loss.backward()
    grads = gpt_tp_state_dict(cfg, {k: p.grad for k, p in model.named_parameters()}, r, tp)
    grads = {k: v.clone() for k, v in grads.items()}
    shard = {k: v.detach().clone() for k, v in
             gpt_tp_state_dict(cfg, {k: p.detach() for k, p in model.named_parameters()},
                               r, tp).items()}
    dense_loss = dense_loss.item()
    del model
    torch.cuda.empty_cache()
    tp_model = GPTLMHeadModel(cfg, device=dev, group=group)
    tp_model.load_state_dict(shard)
    del shard
    torch.distributed.barrier(group)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss = parallel_cross_entropy_loss(tp_model(ids)[:, :-1], ids[:, 1:], group)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    errs, whole = tp_grad_apart({k: p.grad for k, p in tp_model.named_parameters()}, grads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    loss_err = abs(float(loss) - dense_loss) / dense_loss
    _rank_log(rank, f"(b) OPT-1.3B at tp {tp}, {TP_TRAIN_BATCH} x {TP_TRAIN_SEQ} tokens: loss "
              f"{float(loss):.5f} against the dense model's {dense_loss:.5f} (rel {loss_err:.2e}, "
              f"bound {TP_LOSS_RTOL}); {len(errs)} gradient shards: together rel-L2 {whole:.3e} "
              f"(bound {SMALL_GRAD_TOL}), the largest alone {worst[1]:.3e} ({worst[0]}; bound "
              f"{GRAD_TENSOR_TOL}); {ms:.1f} ms forward and "
              f"backward (two ranks share one card); launches {counts['flash_fwd']} B1, "
              f"{counts['flash_bwd_dq']} B7 [{card}]")
    check(loss_err <= TP_LOSS_RTOL, "(b) the tensor-parallel loss departs from the dense model's")
    check(whole <= SMALL_GRAD_TOL, "(b) the gradient shards depart from the dense model's")
    check(worst[1] <= GRAD_TENSOR_TOL, f"(b) the gradient of {worst[0]} departs from the dense "
          "model's shard")
    check(counts["flash_fwd"] == cfg.num_layers and counts["flash_bwd_dq"] == cfg.num_layers,
          f"(b) {counts['flash_fwd']} B1 and {counts['flash_bwd_dq']} B7 launches, not "
          f"{cfg.num_layers} each")
    del tp_model, grads
    torch.cuda.empty_cache()
    return counts, dict(loss=float(loss), dense_loss=dense_loss, loss_rel_err=loss_err,
                        grad_shards=len(errs), grad_rel_l2=whole, worst_grad=list(worst), ms=ms)


def _block_stage(blocks):
    """A pipeline stage over pre-norm ``blocks``: an nn.Module carrying the
    residual stream between stages as one tensor (each stage starts its
    first block with no separate residual)."""
    import torch

    class Stage(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = torch.nn.ModuleList(blocks)

        def forward(self, x):
            h, res = x, None
            for blk in self.blocks:
                h, res = blk(h, res)
            return (h.float() + res).to(x.dtype)

    return Stage()


def _pipeline_run(dev, mesh, card, rank):
    """(c): pipeline_apply over GPT-2 XL's blocks at pp 2."""
    import torch
    from liteattention_torch.models import GPTLMHeadModel, gpt2_config
    from liteattention_torch.parallel import pipeline_apply

    group = mesh.get_group("sp")
    n, r = group.size(), group.rank()
    cfg = gpt2_config(dim=PP_DIM, num_layers=PP_LAYERS, num_heads=PP_HEADS)
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(PP_SEED))
    blocks = list(model.transformer.blocks)
    per = PP_LAYERS // n
    stages = [_block_stage(blocks[i * per:(i + 1) * per]) for i in range(n)]
    gen = torch.Generator(device=dev).manual_seed(PP_SEED + 1)
    x = torch.randn(PP_BATCH, PP_SEQ, PP_DIM, generator=gen, device=dev).to(cfg.dtype)
    cot = torch.randn(PP_BATCH, PP_SEQ, PP_DIM, generator=gen, device=dev)
    mb = PP_BATCH // PP_MICRO
    ref = []
    for i in range(PP_MICRO):  # the sequential model, microbatch by microbatch
        y = x[i * mb:(i + 1) * mb]
        for st in stages:
            y = st(y)
        (y.float() * cot[i * mb:(i + 1) * mb]).sum().backward()
        ref.append(y.detach())
    ref = torch.cat(ref)
    mine = stages[r]
    ref_grads = {k: p.grad.clone() for k, p in mine.named_parameters()}
    model.zero_grad(set_to_none=True)
    for i, st in enumerate(stages):
        if i != r:
            st.requires_grad_(False)
    torch.cuda.empty_cache()
    torch.distributed.barrier(group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    y = pipeline_apply(mine, None, x, mesh, "sp", num_microbatches=PP_MICRO)
    (y.float() * cot).sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    out_err = rel_l2(y.float(), ref.float())
    errs = {k: rel_l2(p.grad, ref_grads[k]) for k, p in mine.named_parameters()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    whole = rel_l2(torch.cat([p.grad.flatten() for p in mine.parameters()]),
                   torch.cat([ref_grads[k].flatten() for k, _ in mine.named_parameters()]))
    _rank_log(rank, f"(c) GPT-2 XL's {PP_LAYERS} blocks at pp {n} ({per} a stage), "
              f"{PP_BATCH} x {PP_SEQ} tokens in {PP_MICRO} microbatches: output rel-L2 against "
              f"the sequential blocks {out_err:.3e} (bound {PP_OUT_TOL}); this stage's "
              f"{len(errs)} gradients together {whole:.3e} (bound {PP_GRAD_TOL}), the largest "
              f"alone {worst[1]:.3e} ({worst[0]}; bound {GRAD_TENSOR_TOL}); {ms:.1f} ms forward "
              f"and backward (two ranks share one card, "
              f"{PP_MICRO + n - 1} ticks), peak {peak:.1f} GB on this rank; launches "
              f"{counts['flash_fwd']} B1, {counts['flash_bwd_dq']} B7 [{card}]")
    check(out_err <= PP_OUT_TOL, "(c) the pipeline's output departs from the sequential blocks'")
    check(whole <= PP_GRAD_TOL, "(c) the stage's gradients depart from the sequential model's")
    check(worst[1] <= GRAD_TENSOR_TOL, f"(c) the gradient of {worst[0]} departs from the "
          "sequential model's")
    want = per * PP_MICRO
    check(counts["flash_fwd"] == want and counts["flash_bwd_dq"] == want,
          f"(c) {counts['flash_fwd']} B1 and {counts['flash_bwd_dq']} B7 launches, not {want} "
          f"each ({per} blocks x {PP_MICRO} microbatches)")
    del model, blocks, stages, mine, ref_grads, y
    torch.cuda.empty_cache()
    return counts, dict(out_rel_l2=out_err, grad_rel_l2=whole, grad_rel_l2_worst=list(worst),
                        ms=ms, peak_gb=peak,
                        depth=PP_LAYERS, batch=PP_BATCH, microbatches=PP_MICRO)


def _ep_run(dev, mesh, card, rank):
    """(d): moe_apply_sharded at ep 2 against moe_forward over each rank's
    tokens at the same capacity."""
    import torch
    from liteattention_torch.modules.moe import capacity_for, init_moe_params, moe_apply_sharded
    from liteattention_torch.modules.moe import moe_forward

    n = mesh.get_group("sp").size()
    gen = torch.Generator(device=dev).manual_seed(EP_SEED)
    params = init_moe_params(gen, EP_DIM, EP_HIDDEN, EP_EXPERTS, dtype=torch.bfloat16,
                             device=dev)
    x = torch.randn(n * EP_TOKENS, EP_DIM, generator=gen, device=dev).to(torch.bfloat16)
    cot = torch.randn(n * EP_TOKENS, EP_DIM, generator=gen, device=dev)
    cap = capacity_for(EP_TOKENS, EP_EXPERTS, 2, 1.25)

    def grads_of(run):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        xx = x.detach().clone().requires_grad_()
        y, aux = run(p, xx)
        ((y.float() * cot).sum() + 0.01 * aux).backward()
        return y.detach(), float(aux), {"x": xx.grad, **{k: v.grad for k, v in p.items()}}

    def one_rank(p, xx):
        outs = [moe_forward(p, xx[i * EP_TOKENS:(i + 1) * EP_TOKENS], 2, capacity=cap)
                for i in range(n)]
        return torch.cat([o[0] for o in outs]), sum(o[1] for o in outs) / n

    y_ref, aux_ref, g_ref = grads_of(one_rank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux, g = grads_of(lambda p, xx: moe_apply_sharded(p, xx, mesh, "sp", capacity=cap))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    errs = {"y": rel_l2(y.float(), y_ref.float()),
            **{k: rel_l2(v.float(), g_ref[k].float()) for k, v in g.items()}}
    aux_err = abs(aux - aux_ref) / abs(aux_ref)
    _rank_log(rank, f"(d) moe_apply_sharded at ep {n} ({EP_EXPERTS} experts, {EP_DIM} -> "
              f"{EP_HIDDEN}, {EP_TOKENS} tokens a rank, capacity {cap}): rel-L2 against "
              f"moe_forward over each rank's tokens {json.dumps({k: f'{v:.2e}' for k, v in errs.items()})} "
              f"(bound {MOE_LAYER_TOL}), aux {aux:.6f} against {aux_ref:.6f} (rel {aux_err:.1e}, "
              f"bound {EP_AUX_RTOL}); {ms:.1f} ms forward and backward [{card}]")
    check(max(errs.values()) <= MOE_LAYER_TOL, "(d) the expert-parallel layer departs from "
          "moe_forward")
    check(aux_err <= EP_AUX_RTOL, "(d) the expert-parallel aux loss departs from moe_forward's")
    del params, x, g, g_ref
    torch.cuda.empty_cache()
    return dict(rel_l2=errs, aux=aux, aux_ref=aux_ref, aux_rel_err=aux_err, capacity=cap, ms=ms)


def _training_pair_body(rank, dev, mesh, card):
    """Phase 23's two gloo ranks: (a) data parallelism through train.py,
    (b) a tensor-parallel training step, (c) the pipeline, (d) expert
    parallelism."""
    group = mesh.get_group("sp")
    out = {"counts": {}, "stats": {}}
    t0 = time.perf_counter()
    out["counts"]["dp_train"], out["stats"]["dp"] = _dp_phase(rank, group, card)
    t1 = time.perf_counter()
    out["counts"]["tp_train"], out["stats"]["tp_train"] = _tp_train_step(dev, group, card, rank)
    t2 = time.perf_counter()
    out["counts"]["pp_blocks"], out["stats"]["pp"] = _pipeline_run(dev, mesh, card, rank)
    t3 = time.perf_counter()
    out["stats"]["ep"] = _ep_run(dev, mesh, card, rank)
    t4 = time.perf_counter()
    out["stats"]["seconds"] = {"dp": t1 - t0, "tp_train": t2 - t1, "pp": t3 - t2, "ep": t4 - t3}
    _rank_log(rank, f"sub-phase seconds {json.dumps({k: round(v, 1) for k, v in out['stats']['seconds'].items()})}")
    return out


def training_parallel_phase(dev, card):
    """Phase 23: the training half of parallel/ at two ranks on the card
    over gloo: (a) train.py run.data_parallel (ZeRO-2 with the bfloat16
    wire, plain, ZeRO-1, ZeRO-2), (b) OPT-1.3B's tensor-parallel training step, (c)
    pipeline_apply over GPT-2 XL's blocks, (d) moe_apply_sharded."""
    import torch

    log(f"  {SP_RANKS} ranks sharing card 0 over gloo (NCCL refuses two ranks on one device); "
        f"their times are no measure of parallel speed; {torch.cuda.device_count()} card(s)")
    pair = _spawn_ranks(SP_RANKS, "gloo", card, body=_training_pair_body, label="phase 23")
    runs = [r["stats"]["dp"]["runs"] for r in pair]
    for name, _, _ in DP_RUNS:
        sums = [rr[name].pop("param_sums") for rr in runs]
        check(all(x == sums[0] for x in sums[1:]),
              f"(a) {name}: the ranks end with different parameters")
    log(f"  (a) every rank ends each data-parallel run with the same parameters (float64 sums "
        f"and sums of squares of all {len(sums[0])} tensors equal)")
    counts = {}
    for path in ("dp_train", "tp_train", "pp_blocks"):
        per_rank = [r["counts"][path] for r in pair]
        counts[path] = {name: sum(c[name] for c in per_rank) for name in per_rank[0]}
    log(f"  phase 23 launches (summed over ranks): "
        f"{json.dumps({p: {k: c[k] for k in ('flash_fwd', 'flash_bwd_dq')} for p, c in counts.items()})}")
    return counts, {"ranks": [r["stats"] for r in pair]}


# ---------------------------------------------------------------- phase 24

# The varlen functions with their window, softcap and dropout channels over
# packed documents: B1's and B7's segment walks with those channels
# (flash_fwd_segments_channels.cu, flash_bwd_segments_channels.cu).
# (a) Mistral-7B's attention (mistralai/Mistral-7B-v0.1 config.json: 32 q
# heads, 8 KV heads, head dim 128, sliding_window 4096): 16 384 packed tokens
# in seeded documents of 512-8192 tokens (5544, 2695, 3379, 4766: two longer
# than the window, which then cuts inside them), causal, window (4095, 0).
MISTRAL_PACK = (16384, 32, 8, 128, (512, 8192), 2426)
MISTRAL_VARLEN_WINDOW = (4095, 0)
# (b) Gemma-2-27B's attention (google/gemma-2-27b config.json: 32 q heads, 16
# KV heads, head dim 128, attn_logit_softcapping 50, sliding_window 4096,
# query_pre_attn_scalar 144, so the scale is 144^-0.5): 8192 packed tokens
# in seeded documents of 1024-6144 tokens (1561, 1685, 4946), causal; a local
# layer (cap and window) and a global one (the cap alone).
GEMMA2_27B_PACK = (8192, 32, 16, 128, (1024, 6144), 2527)
GEMMA2_27B_SOFTCAP, GEMMA2_27B_WINDOW, GEMMA2_27B_SCALE = 50.0, (4095, 0), 144**-0.5
# (c) BERT-large's attention (google-bert/bert-large-uncased config.json: 16
# heads of 64, attention_probs_dropout_prob 0.1) over phase 13's unpadded
# batch, non-causal, dropout 0.1 (phase 15's seed); its keep mask read back
# over READBACK_DOCS documents of 64 tokens at the same heads.
BERT_ATTN_DROPOUT = 0.1
READBACK_DOCS = 140


def varlen_channel_kernel_phase(dev):
    """Phase 24 (a)-(c): B1's and B7's segment walks with the window / cap
    and with dropout against their plain versions (out, lse, dQ / dK / dV
    and every 128-row block; dK, dV bit-stable), each timed beside its
    bound over the visible pairs, its plain version and one PyTorch call of
    the same function (FlexAttention with the document and window
    BlockMask and the cap's score_mod; SDPA's efficient backend with the
    block-diagonal mask and dropout); (a) against each document alone
    through the dense window walk. Returns the kernels line's four entries
    and the phase's stats."""
    import torch
    from liteattention_torch.flash_attn_interface import varlen_segment_ids
    from liteattention_torch.utils.padding import unpad_input

    win_f, win_b, drop_f, drop_b, stats = {}, {}, {}, {}, {}
    # (a) Mistral-7B: documents against each alone, then the kernels.
    total, h, hk, d = MISTRAL_PACK[:4]
    q, k, v, dout, lengths, cu = packed_docs(dev, MISTRAL_PACK)
    cut = sum(n > MISTRAL_VARLEN_WINDOW[0] + 1 for n in lengths)
    check(cut >= 2, f"phase 24 (a): {cut} documents longer than the window, want 2")
    label = (f"segments + window {MISTRAL_VARLEN_WINDOW} causal 1x{h}/{hk}x{total}x{d}, "
             f"Mistral-7B's {len(lengths)} documents")
    stats["mistral_7b_docs"] = {"lengths": lengths, **docs_alone_check(
        label, q, k, v, dout, lengths, cu, None, window=MISTRAL_VARLEN_WINDOW)}
    seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
    kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None], causal=True,
              window=MISTRAL_VARLEN_WINDOW)
    qh, kh, vh, dh = heads_first(q, k, v, dout)
    win_f["mistral_7b_docs"] = check_channels(label, qh, kh, vh, kw, time_it=True)
    win_b["mistral_7b_docs"] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    del q, k, v, dout, qh, kh, vh, dh
    torch.cuda.empty_cache()

    # (b) Gemma-2-27B: the local layer (cap and window) and the global one.
    total, h, hk, d = GEMMA2_27B_PACK[:4]
    q, k, v, dout, lengths, cu = packed_docs(dev, GEMMA2_27B_PACK, grad=False)
    seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
    qh, kh, vh, dh = heads_first(q, k, v, dout)
    stats["gemma2_27b_docs"] = {"lengths": lengths}
    for key, extra in (("gemma2_27b_local", dict(window=GEMMA2_27B_WINDOW)),
                       ("gemma2_27b_global", {})):
        kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None], causal=True,
                  softcap=GEMMA2_27B_SOFTCAP, scale=GEMMA2_27B_SCALE, **extra)
        label = (f"segments + softcap {GEMMA2_27B_SOFTCAP}"
                 + (f" + window {GEMMA2_27B_WINDOW}" if extra else "")
                 + f" causal 1x{h}/{hk}x{total}x{d}, Gemma-2-27B's {len(lengths)} documents "
                 f"({key.split('_')[-1]} layer)")
        win_f[key] = check_channels(label, qh, kh, vh, kw, time_it=True)
        win_b[key] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    del q, k, v, dout, qh, kh, vh, dh
    torch.cuda.empty_cache()

    # (c) BERT-large's unpadded batch with dropout 0.1.
    _, mask, total, g = bert_padded_mask(dev)
    h, d = 16, 64
    x = [torch.randn(BERT_BATCH, BERT_SEQ, h, d, generator=g, device=dev).to(torch.bfloat16)
         for _ in range(4)]
    packed = [unpad_input(t, mask, max_tokens=total)[0] for t in x]
    cu = unpad_input(x[0], mask, max_tokens=total)[2]
    seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device=dev)
    kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None], dropout_p=BERT_ATTN_DROPOUT,
              dropout_seed=seed)
    qh, kh, vh, dh = heads_first(*packed)
    label = (f"segments + dropout {BERT_ATTN_DROPOUT} 1x{h}x{total}x{d}, BERT-large's "
             f"{BERT_BATCH} sequences")
    drop_f["bert_large_unpadded"] = check_channels(label, qh, kh, vh, kw, time_it=True)
    drop_b["bert_large_unpadded"] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    for r in (drop_f["bert_large_unpadded"], drop_b["bert_large_unpadded"]):
        # The keep hash's integer instructions are operations too: the bound is the
        # larger of it and the tensor-core / bytes bound.
        r["int_bound_ms"] = int_bound_ms(r["visible_pairs"])
        r["tensor_bound_ms"], r["tensor_bound_by"] = r["bound_ms"], r["bound_by"]
        if r["int_bound_ms"] > r["bound_ms"]:
            r["bound_ms"], r["bound_by"] = r["int_bound_ms"], "operations"
    stats["bert_dropout_readback"] = varlen_dropout_readback(dev)
    del x, packed, qh, kh, vh, dh
    torch.cuda.empty_cache()
    kres = {"flash_fwd_segments_window": _channel_entry(win_f, "mistral_7b_docs"),
            "flash_bwd_segments_window": _channel_entry(win_b, "mistral_7b_docs"),
            "flash_fwd_segments_dropout": _channel_entry(drop_f, "bert_large_unpadded"),
            "flash_bwd_segments_dropout": _channel_entry(drop_b, "bert_large_unpadded")}
    return kres, stats


def varlen_dropout_readback(dev):
    """Phase 24 (c): the segment walks' keep mask read back through the
    varlen function, bit for bit. READBACK_DOCS documents of 64 tokens at
    BERT-large's 16 heads of 64, q = k = 0 (P uniform over a row's
    document), V one-hot over each document's keys and dO one-hot over its
    rows: B1's out[i, j] must equal keep[i, s + j] (1 / (1 - p)) / 64 and
    B7's dV[s + j, c] be nonzero exactly where keep[s + c, s + j] (s the
    document's first token), keep the plain version's mask on the packed
    axis (dropout_keep_mask at bh = h, packed rows and columns). The dropped
    share must lie within 4 sigma of p. Returns the share and the count."""
    import torch
    from liteattention_torch import flash_attn_varlen_func
    from liteattention_torch.ops.flash_fwd import dropout_keep_mask

    h, d, p = 16, 64, BERT_ATTN_DROPOUT
    total = 64 * READBACK_DOCS
    cu = torch.arange(0, total + 1, 64, dtype=torch.int32, device=dev)
    q = torch.zeros(total, h, d, dtype=torch.bfloat16, device=dev, requires_grad=True)
    k = torch.zeros(total, h, d, dtype=torch.bfloat16, device=dev, requires_grad=True)
    eye = torch.eye(64, d, dtype=torch.bfloat16, device=dev).repeat(READBACK_DOCS, 1)
    v = eye[:, None].expand(total, h, d).contiguous().requires_grad_()
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device=dev)
    out = flash_attn_varlen_func(q, k, v, cu, cu, dropout_p=p, dropout_seed=seed)
    out.backward(eye[:, None].expand(total, h, d))
    cols = (torch.arange(total, device=dev) // 64 * 64)[:, None] + torch.arange(64, device=dev)
    kept = 0
    for hi in range(h):
        keep = dropout_keep_mask(DROPOUT_SEED, hi, 0, 0, (total, total), p, device=dev)
        mine = torch.gather(keep, 1, cols)
        want = (mine.float() * (1.0 / (1.0 - p)) / 64).bfloat16()
        check(torch.equal(out[:, hi, :64].detach(), want),
              f"phase 24 read-back (head {hi}): B1's keep mask is not the plain version's")
        check(torch.equal(v.grad[:, hi, :64] != 0, torch.gather(keep.t(), 1, cols)),
              f"phase 24 read-back (head {hi}): B7's keep mask is not the plain version's")
        kept += int(mine.sum())
        del keep
    n = total * 64 * h
    share = 1.0 - kept / n
    sigma = (p * (1.0 - p) / n) ** 0.5
    log(f"  read-back: {n} scores of {READBACK_DOCS} documents of 64 tokens x {h} heads through "
        f"flash_attn_varlen_func: B1's out and B7's dV carry the plain version's keep mask bit "
        f"for bit; dropped share {share:.5f} ({(share - p) / sigma:+.2f} sigma)")
    check(abs(share - p) < 4 * sigma, f"phase 24: dropped share {share} is not p {p} +- 4 sigma")
    return {"scores": n, "dropped_share": share}


def varlen_channel_counted_run(dev):
    """Phase 24's counted run, the main path: flash_attn_varlen_func forward
    and backward (autograd) at (a) Mistral-7B's window, (b) Gemma-2-27B's
    local and global layers and (c) BERT-large's unpadded batch with
    dropout (through unpad_input and pad_input), every plain version
    forbidden. Each call is one launch of B1's and one of B7's segment
    instantiation of its channels and nothing else."""
    import torch
    from liteattention_torch import flash_attn_varlen_func
    from liteattention_torch.utils.padding import pad_input, unpad_input

    _, mask, total, g = bert_padded_mask(dev)
    x = torch.randn(BERT_BATCH, BERT_SEQ, 16, 64, generator=g, device=dev).to(torch.bfloat16)
    x.requires_grad_()
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device=dev)
    mistral, gemma = packed_docs(dev, MISTRAL_PACK), packed_docs(dev, GEMMA2_27B_PACK)

    def bert():
        p, idx, cu, _ = unpad_input(x, mask, max_tokens=total)
        out = flash_attn_varlen_func(p, p, p, cu, cu, dropout_p=BERT_ATTN_DROPOUT,
                                     dropout_seed=seed)
        pad_input(out, idx, BERT_BATCH, BERT_SEQ).float().square().sum().backward()

    def docs(data, **kw):
        q, k, v, dout, _, cu = data
        return lambda: flash_attn_varlen_func(q, k, v, cu, cu, causal=True, **kw).backward(dout)

    calls = [("mistral_7b_window", docs(mistral, window_size=MISTRAL_VARLEN_WINDOW), "window"),
             ("gemma2_27b_local", docs(gemma, window_size=GEMMA2_27B_WINDOW,
                                       softcap=GEMMA2_27B_SOFTCAP,
                                       softmax_scale=GEMMA2_27B_SCALE), "window"),
             ("gemma2_27b_global", docs(gemma, softcap=GEMMA2_27B_SOFTCAP,
                                        softmax_scale=GEMMA2_27B_SCALE), "window"),
             ("bert_large_dropout", bert, "dropout")]
    torch.cuda.synchronize()
    reset_counts()
    with plain_forbidden():
        for name, call, kind in calls:
            before = read_counts()
            call()
            delta = {n: c - before[n] for n, c in read_counts().items() if c != before[n]}
            want = {f"flash_fwd_segments_{kind}": 1, f"flash_bwd_segments_{kind}": 1}
            check(delta == want, f"phase 24's counted run: {name} launched {delta}, want {want}")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  counted run (Mistral-7B window, Gemma-2-27B local and global, BERT-large dropout; "
        f"forward and backward through flash_attn_varlen_func): {counts}")
    del mistral, gemma, x
    torch.cuda.empty_cache()
    return counts


def varlen_channel_phase(dev, card):
    """Phase 24: the varlen functions with the window, softcap and dropout
    channels over packed documents at Mistral-7B's, Gemma-2-27B's and
    BERT-large's attention; the combinations not built still raise."""
    import torch
    from liteattention_torch import flash_attn_varlen_func

    t0 = time.perf_counter()
    log(f"  (a)-(c) B1's and B7's segment walks with the channels against their plain versions "
        f"[{card}]")
    kres, stats = varlen_channel_kernel_phase(dev)
    counts = varlen_channel_counted_run(dev)
    # The combinations left out raise before any launch, naming their item.
    cu = torch.tensor([0, 100, 256], dtype=torch.int32, device=dev)
    qs = torch.zeros(256, 4, 128, dtype=torch.bfloat16, device=dev)
    q96 = torch.zeros(256, 4, 96, dtype=torch.bfloat16, device=dev)
    refused = {}
    for name, args, kw, item in (
            ("dropout_with_window", (qs,) * 3, dict(causal=True, window_size=(64, 0),
                                                    dropout_p=0.1), "B-i 3's rest"),
            ("dropout_with_softcap", (qs,) * 3, dict(softcap=30.0, dropout_p=0.1),
             "B-i 3's rest"),
            ("window_at_d96", (q96,) * 3, dict(causal=True, window_size=(64, 0)), "B-iii 4"),
            ("dropout_at_d96", (q96,) * 3, dict(dropout_p=0.1), "B-iii 4")):
        before, err = read_counts(), None
        try:
            flash_attn_varlen_func(*args, cu, cu, **kw)
        except NotImplementedError as e:
            err = refused[name] = str(e)
        check(err is not None and f"ROADMAP {item}" in err,
              f"phase 24: {name} did not raise naming ROADMAP {item} ({err})")
        check(read_counts() == before, f"phase 24: {name} launched a kernel before it raised")
    log(f"  refused before any launch: {sorted(refused)}")
    stats["refused"] = refused
    stats["part_seconds"] = {"all": time.perf_counter() - t0}
    return counts, kres, stats


# ---------------------------------------------------------------- phase 25

# Head dim 256 with the window, the cap, the key range and segments: B1's
# and B7's D 256 instantiations of those channels (flash_fwd_d256_window.cu,
# flash_fwd_d256_segments.cu, flash_bwd_d256.cu's RANGE,
# flash_bwd_d256_window.cu, flash_bwd_d256_segments.cu).
# Gemma-2-9B's attention (google/gemma-2-9b config.json: num_attention_heads
# 16, num_key_value_heads 8, head_dim 256, query_pre_attn_scalar 256, so
# the scale is 256^-0.5, attn_logit_softcapping 50.0, sliding_window 4096 on
# every other layer: window (4095, 0), as phase 16 takes Gemma-2's).
GEMMA2_9B = dict(heads=16, kv_heads=8, d=256)
GEMMA2_9B_SCALE, GEMMA2_9B_SOFTCAP, GEMMA2_9B_WINDOW = 256**-0.5, 50.0, (4095, 0)
# (a) its training shape, 1 x 8192 tokens (max_position_embeddings 8192).
GEMMA2_9B_TRAIN = 8192
# (b) served: 8 requests of 2048-6000 prompt tokens (from the seed: 3607,
# 5278, 4111, 3045, 4769, 4965, 4429, 5838, six longer than the window)
# into 8192-slot bf16 caches, prefilled in one call, then 32 single-token
# steps, every 8th held against a full recompute.
GEMMA2_SERVE = dict(batch=8, capacity=8192, prompt=(2048, 6000), steps=32, seed=2609,
                    check_every=8)
# (c) Gemma-3-4B's local layer (google/gemma-3-4b-pt config.json,
# text_config: num_attention_heads 8, num_key_value_heads 4, head_dim 256,
# query_pre_attn_scalar 256, sliding_window 1024: window (1023, 0), no
# cap), 1 x 16 384 tokens (its context is 128k; cut for the smoke's time).
GEMMA3_4B = dict(heads=8, kv_heads=4, d=256)
GEMMA3_4B_TOKENS, GEMMA3_4B_WINDOW = 16384, (1023, 0)
# (d) Gemma-2-9B's packed documents: 8192 tokens in four seeded documents
# (1570, 1177, 4280, 1165; two longer than the 4096-key window cannot fit in
# 8192 tokens, one does, and the window cuts inside it), causal.
GEMMA2_9B_PACK = (8192, 16, 8, 256, (1024, 6144), 2637)
# (e) Gemma-7B's attention (google/gemma-7b config.json:
# num_attention_heads 16, num_key_value_heads 16, head_dim 256): a padded
# fine-tuning batch of 8 x 2048, lengths 512-2048 from the seed (1168, 1981,
# 565, 1390, 1283, 1717, 930, 2044), causal, and its unpadded form through
# the varlen function.
GEMMA7B = dict(heads=16, kv_heads=16, d=256, batch=8, seq=2048, min_len=512, seed=2701)


def gemma_kernel_phase(dev):
    """Phase 25 (a), (c)-(e): B1's and B7's D 256 instantiations of the
    window / cap, the key range and segments against their plain versions
    (out, lse, dQ / dK / dV and every 128-row block; dK, dV bit-stable),
    each timed beside its bound over the visible pairs (and the MUFU bound
    with the cap), its plain version and one PyTorch call (FlexAttention
    with the window / document BlockMask and the cap's score_mod; SDPA's
    efficient backend with the boolean mask for the key range and
    segments alone); (d) against each document alone through (a)'s dense
    walk, (e)'s unpadded batch against the padded one on its valid rows.
    Returns the kernels line's entries and the phase's stats."""
    import torch
    from liteattention_torch import flash_attn_varlen_func
    from liteattention_torch.flash_attn_interface import varlen_segment_ids
    from liteattention_torch.ops.flash_fwd import flash_attention_masked
    from liteattention_torch.utils.padding import unpad_input

    win_f, win_b, seg_win_f, seg_win_b, stats = {}, {}, {}, {}, {}
    res = {}
    g = torch.Generator(device=dev).manual_seed(2525)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    # (a) Gemma-2-9B's training shape: the local and the global layer.
    h, hk, d, n = GEMMA2_9B["heads"], GEMMA2_9B["kv_heads"], GEMMA2_9B["d"], GEMMA2_9B_TRAIN
    q, k, v, dout = rnd(1, h, n, d), rnd(1, hk, n, d), rnd(1, hk, n, d), rnd(1, h, n, d)
    for key, extra in (("gemma2_9b_local", dict(window=GEMMA2_9B_WINDOW)),
                       ("gemma2_9b_global", {})):
        kw = dict(causal=True, softcap=GEMMA2_9B_SOFTCAP, scale=GEMMA2_9B_SCALE, **extra)
        label = (f"softcap {GEMMA2_9B_SOFTCAP}"
                 + (f" + window {GEMMA2_9B_WINDOW}" if extra else "")
                 + f" causal 1x{h}/{hk}x{n}x{d}, Gemma-2-9B's {key.split('_')[-1]} layer")
        win_f[key] = check_channels(label, q, k, v, kw, time_it=True)
        win_b[key] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
    del q, k, v, dout
    torch.cuda.empty_cache()

    # (c) Gemma-3-4B's local layer over 16 384 tokens.
    h, hk, d, n = GEMMA3_4B["heads"], GEMMA3_4B["kv_heads"], GEMMA3_4B["d"], GEMMA3_4B_TOKENS
    q, k, v, dout = rnd(1, h, n, d), rnd(1, hk, n, d), rnd(1, hk, n, d), rnd(1, h, n, d)
    kw = dict(causal=True, window=GEMMA3_4B_WINDOW, scale=256**-0.5)
    label = f"window {GEMMA3_4B_WINDOW} causal 1x{h}/{hk}x{n}x{d}, Gemma-3-4B's local layer"
    win_f["gemma3_4b_local"] = check_channels(label, q, k, v, kw, time_it=True)
    win_b["gemma3_4b_local"] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
    del q, k, v, dout
    torch.cuda.empty_cache()

    # (d) Gemma-2-9B's packed documents: each alone through (a)'s dense
    # walk, then the segment kernels.
    total, h, hk, d = GEMMA2_9B_PACK[:4]
    q, k, v, dout, lengths, cu = packed_docs(dev, GEMMA2_9B_PACK)
    cut = sum(x > GEMMA2_9B_WINDOW[0] + 1 for x in lengths)
    check(cut >= 1, f"phase 25 (d): no document longer than the window ({lengths})")
    seg_q, seg_k = varlen_segment_ids(cu, cu, total, total)
    qh, kh, vh, dh = heads_first(q, k, v, dout)
    stats["gemma2_9b_docs"] = {"lengths": lengths}
    for key, extra in (("gemma2_9b_docs_local", dict(window=GEMMA2_9B_WINDOW)),
                       ("gemma2_9b_docs_global", {})):
        label = (f"segments + softcap {GEMMA2_9B_SOFTCAP}"
                 + (f" + window {GEMMA2_9B_WINDOW}" if extra else "")
                 + f" causal 1x{h}/{hk}x{total}x{d}, Gemma-2-9B's {len(lengths)} documents "
                 f"({key.split('_')[-1]} layer)")
        stats["gemma2_9b_docs"][key] = docs_alone_check(
            label, q, k, v, dout, lengths, cu, GEMMA2_9B_SCALE, window=extra.get("window"),
            softcap=GEMMA2_9B_SOFTCAP)
        kw = dict(q_segments=seg_q[None], kv_segments=seg_k[None], causal=True,
                  softcap=GEMMA2_9B_SOFTCAP, scale=GEMMA2_9B_SCALE, **extra)
        seg_win_f[key] = check_channels(label, qh, kh, vh, kw, time_it=True)
        seg_win_b[key] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    del q, k, v, dout, qh, kh, vh, dh
    torch.cuda.empty_cache()

    # (e) Gemma-7B's padded fine-tuning batch: B1's and B7's key range, then
    # the same batch unpadded through the varlen function (the segment walk
    # alone at 256), its valid rows against the padded call's.
    cfg = GEMMA7B
    b, s, h, d = cfg["batch"], cfg["seq"], cfg["heads"], cfg["d"]
    gl = torch.Generator().manual_seed(cfg["seed"])
    lens = torch.randint(cfg["min_len"], s + 1, (b,), generator=gl).to(dev, torch.int32)
    q, k, v, dout = (rnd(b, h, s, d) for _ in range(4))
    kw = dict(kv_bound=lens, causal=True)
    label = (f"bound causal {b}x{h}x{s}x{d}, Gemma-7B's padded batch (lengths "
             f"{lens.tolist()})")
    res["bound_fwd"] = check_channels(label, q, k, v, kw, time_it=True)
    res["bound_bwd"] = check_bwd_channels(label, q, k, v, dout, kw, time_it=True)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None]).to(torch.int32)
    n_tok = int(lens.sum())
    packed = [unpad_input(x.transpose(1, 2), mask, max_tokens=n_tok)[0] for x in (q, k, v, dout)]
    idx, cu_e = unpad_input(q.transpose(1, 2), mask, max_tokens=n_tok)[1:3]
    seg_e_q, seg_e_k = varlen_segment_ids(cu_e, cu_e, n_tok, n_tok)
    qh, kh, vh, dh = heads_first(*packed)
    kw = dict(q_segments=seg_e_q[None], kv_segments=seg_e_k[None], causal=True)
    label = f"segments causal 1x{h}x{n_tok}x{d}, Gemma-7B's batch unpadded"
    res["segments_fwd"] = check_channels(label, qh, kh, vh, kw, time_it=True)
    res["segments_bwd"] = check_bwd_channels(label, qh, kh, vh, dh, kw, time_it=True)
    padded = flash_attention_masked(q, k, v, kv_bound=lens, causal=True).transpose(1, 2)
    unpadded = flash_attn_varlen_func(*packed[:3], cu_e, cu_e, causal=True)
    err = rel_l2(unpadded, padded.reshape(-1, h, d)[idx.long()])
    log(f"  Gemma-7B's batch: the varlen call on its {n_tok} valid tokens against the padded "
        f"call's valid rows: rel-L2 {err:.2e} (limit {PACKED_DOC_TOL})")
    check(err < PACKED_DOC_TOL, "phase 25 (e): the unpadded batch differs from the padded one")
    stats["gemma7b_batch"] = {"lengths": lens.tolist(), "unpadded_vs_padded_rel_l2": err}
    del q, k, v, dout, packed, qh, kh, vh, dh, padded, unpadded
    torch.cuda.empty_cache()
    kres = {"flash_fwd_window_d256": _channel_entry(win_f, "gemma2_9b_local"),
            "flash_bwd_window_d256": _channel_entry(win_b, "gemma2_9b_local"),
            "flash_fwd_segments_window_d256": _channel_entry(seg_win_f, "gemma2_9b_docs_local"),
            "flash_bwd_segments_window_d256": _channel_entry(seg_win_b, "gemma2_9b_docs_local"),
            "flash_fwd_segments_d256": _channel_entry({"gemma7b_unpadded": res["segments_fwd"]},
                                                      "gemma7b_unpadded"),
            "flash_bwd_segments_d256": _channel_entry({"gemma7b_unpadded": res["segments_bwd"]},
                                                      "gemma7b_unpadded"),
            "flash_fwd_bound_d256": res["bound_fwd"],
            "flash_bwd_bound_d256": _channel_entry({"gemma7b_padded": res["bound_bwd"]},
                                                   "gemma7b_padded")}
    return kres, stats


def gemma2_serve_inputs(dev):
    """Phase 25 (b)'s inputs, bf16 from the seed: the prompts' lengths,
    their packed q [T, 16, 256], k and v [T, 8, 256] and cu_seqlens, each
    step's q [8, 1, 16, 256], k and v [8, 1, 8, 256], and two layers'
    head-major caches [8, 8, 8192, 256] (local, global)."""
    import torch

    cfg = GEMMA2_SERVE
    b, cap, steps = cfg["batch"], cfg["capacity"], cfg["steps"]
    h, hk, d = GEMMA2_9B["heads"], GEMMA2_9B["kv_heads"], GEMMA2_9B["d"]
    gl = torch.Generator().manual_seed(cfg["seed"])
    lens = torch.randint(cfg["prompt"][0], cfg["prompt"][1] + 1, (b,), generator=gl)
    g = torch.Generator(device=dev).manual_seed(cfg["seed"])

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    total = int(lens.sum())
    cu = torch.tensor([0, *itertools.accumulate(lens.tolist())], dtype=torch.int32, device=dev)
    prompt = (rnd(total, h, d), rnd(total, hk, d), rnd(total, hk, d))
    step_qkv = [(rnd(b, 1, h, d), rnd(b, 1, hk, d), rnd(b, 1, hk, d)) for _ in range(steps)]
    caches = {layer: (torch.zeros(b, hk, cap, d, dtype=torch.bfloat16, device=dev),
                      torch.zeros(b, hk, cap, d, dtype=torch.bfloat16, device=dev))
              for layer in ("local", "global")}
    return lens.to(dev, torch.int32), cu, prompt, step_qkv, caches


def gemma2_serve_run(dev, inputs, call_step):
    """Phase 25 (b), the counted run of the serving path: the two layers'
    ragged prefill in one flash_attn_with_kvcache call each (packed q by
    cu_seqlens_q, the new keys by cu_seqlens_k_new), then GEMMA2_SERVE's
    single-token steps through both layers, every plain version forbidden.
    ``call_step(layer, ...)`` is the API call. Returns the prefill's and
    the checked steps' outputs for the recompute."""
    import torch

    lens, cu, prompt, step_qkv, caches = inputs
    every = GEMMA2_SERVE["check_every"]
    kept = {"prefill": {}, "steps": []}
    with plain_forbidden():
        for layer in ("local", "global"):
            kept["prefill"][layer] = call_step(layer, *prompt, cache_seqlens=0, cu=cu,
                                               max_q=int(lens.max()))
        cur = lens.clone()
        for i, (q1, k1, v1) in enumerate(step_qkv):
            outs = {layer: call_step(layer, q1, k1, v1, cache_seqlens=cur)
                    for layer in ("local", "global")}
            if (i + 1) % every == 0:
                kept["steps"].append((i, cur.clone(), q1, outs))
            cur = cur + 1
    torch.cuda.synchronize()
    return kept


def gemma2_serve_phase(dev):
    """Phase 25 (b): Gemma-2-9B's local and global layers served through
    flash_attn_with_kvcache (attention only): the counted run (each local
    call one launch of B1's window instantiation, each global one the decode
    kernel's at 256 with the cap: the prefill's padded q in its row chunks,
    a step one launch; nothing else), then the prefill and every 8th step
    against a full recompute through the plain version (each request's keys
    written apart from the caches), the local step's kernel against its
    plain version and timed, and the calls' times. Returns the counts, the
    kernels line's extra shapes and the stats."""
    import torch
    from liteattention_torch.flash_attn_interface import flash_attn_with_kvcache
    from liteattention_torch.ops.flash_decode import row_chunks
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    cfg = GEMMA2_SERVE
    b, steps = cfg["batch"], cfg["steps"]
    h, hk, d = GEMMA2_9B["heads"], GEMMA2_9B["kv_heads"], GEMMA2_9B["d"]
    inputs = gemma2_serve_inputs(dev)
    lens, cu, prompt, step_qkv, caches = inputs
    long = int((lens > GEMMA2_9B_WINDOW[0] + 1).sum())
    check(long >= b // 2, f"phase 25 (b): {long} prompts longer than the window, want most")
    chan = {"local": dict(window_size=GEMMA2_9B_WINDOW), "global": {}}

    def call_step(layer, q, k, v, cache_seqlens, cu=None, max_q=None):
        kc, vc = caches[layer]
        kw = dict(causal=True, softcap=GEMMA2_9B_SOFTCAP, softmax_scale=GEMMA2_9B_SCALE,
                  return_softmax_lse=True, kv_cache_layout="bhsd", **chan[layer])
        if cu is not None:
            kw.update(cu_seqlens_q=cu, cu_seqlens_k_new=cu, max_seqlen_q=max_q,
                      max_seqlen_k_new=max_q)
        out, lse, _ = flash_attn_with_kvcache(q, kc, vc, k, v, cache_seqlens=cache_seqlens,
                                              **kw)
        return out, lse

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kept = gemma2_serve_run(dev, inputs, call_step)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    chunks = len(row_chunks(b, int(lens.max()) * (h // hk), h // hk))
    want = {"flash_fwd_window": 1 + steps, "flash_decode": chunks + steps}
    got = {n: c for n, c in counts.items() if c}
    log(f"  (b) counted run: Gemma-2-9B's local and global layers, {b} prompts of "
        f"{lens.tolist()} tokens prefilled in one call each, then {steps} single-token steps "
        f"({run_s:.1f} s): {got}")
    check(got == want, f"phase 25 (b)'s counted run launched {got}, want {want}")

    # The full recompute: each request's keys and values written apart from
    # the caches, in order, the plain version over them.
    hist_k = torch.zeros(b, hk, cfg["capacity"], d, dtype=torch.bfloat16, device=dev)
    hist_v = torch.zeros_like(hist_k)
    for i, n in enumerate(lens.tolist()):
        a = int(cu[i])
        hist_k[i, :, :n] = prompt[1][a:a + n].transpose(0, 1)
        hist_v[i, :, :n] = prompt[2][a:a + n].transpose(0, 1)
    for j, (_, k1, v1) in enumerate(step_qkv):
        pos = (lens + j).long()
        hist_k[torch.arange(b, device=dev), :, pos] = k1[:, 0]
        hist_v[torch.arange(b, device=dev), :, pos] = v1[:, 0]
    errs = {}

    def held(name, layer, out, ref):
        err = rel_l2(out, ref)
        errs[f"{name}_{layer}"] = err
        check(err < DECODE_REL_TOL, f"phase 25 (b) {name} ({layer}): rel-L2 {err:.3e} to the "
              f"full recompute (limit {DECODE_REL_TOL})")

    for layer in ("local", "global"):
        out, _ = kept["prefill"][layer]
        refs = []
        for i, n in enumerate(lens.tolist()):
            a = int(cu[i])
            ro, _ = flash_attention_plain(
                prompt[0][a:a + n].transpose(0, 1)[None], hist_k[i:i + 1, :, :n],
                hist_v[i:i + 1, :, :n], scale=GEMMA2_9B_SCALE, causal=True,
                softcap=GEMMA2_9B_SOFTCAP, window=chan[layer].get("window_size"))
            refs.append(ro[0].transpose(0, 1))
        held("prefill", layer, out, torch.cat(refs))
        del refs
    for i, cur, q1, outs in kept["steps"]:
        for layer in ("local", "global"):
            ro, _ = flash_attention_plain(
                q1.transpose(1, 2), hist_k, hist_v, kv_bound=cur + 1, bound_causal=True,
                scale=GEMMA2_9B_SCALE, softcap=GEMMA2_9B_SOFTCAP,
                window=chan[layer].get("window_size"))
            held(f"step_{i + 1}", layer, outs[layer][0].transpose(1, 2), ro)
    log("  (b) against a full recompute through the plain version (each request's own keys, "
        f"written apart from the caches; limit rel-L2 {DECODE_REL_TOL}): "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    stats = {"prompt_lengths": lens.tolist(), "counted_run_s": run_s, "recompute_rel_l2": errs}
    # Times: each layer's prefill (the call and B1's kernel alone on the
    # padded q), one single-token step each; the cache is written in place
    # at the same positions with the same values on every repeat.
    last = lens + steps - 1
    q1, k1, v1 = step_qkv[-1]
    for layer in ("local", "global"):
        stats[f"{layer}_prefill_ms"], _, timer = device_ms(
            lambda layer=layer: call_step(layer, *prompt, cache_seqlens=0, cu=cu,
                                          max_q=int(lens.max())), reps=3)
        stats[f"{layer}_step_ms"] = device_ms(
            lambda layer=layer: call_step(layer, q1, k1, v1, cache_seqlens=last))[0]
    stats["timer"] = timer
    log(f"  (b) prefill ({b} requests, {int(lens.sum())} tokens): local {stats['local_prefill_ms']:.3f}"
        f" ms (B1 window), global {stats['global_prefill_ms']:.3f} ms (the decode kernel over "
        f"the padded q, {chunks} launches); a single-token step: local "
        f"{stats['local_step_ms']:.4f} ms, global {stats['global_step_ms']:.4f} ms ({timer})")
    # B1's window instantiation on the local step, against its plain version
    # over the cache, timed beside its bound.
    kc, vc = caches["local"]
    extra = {"kvcache_local_step": check_channels(
        f"kvcache single-token local step, {b}x{h}/{hk}x{d} over {cfg['capacity']} slots",
        q1.transpose(1, 2), kc, vc,
        dict(kv_bound=last + 1, bound_causal=True, window=GEMMA2_9B_WINDOW,
             softcap=GEMMA2_9B_SOFTCAP, scale=GEMMA2_9B_SCALE), time_it=True)}
    del inputs, caches, hist_k, hist_v, kept
    torch.cuda.empty_cache()
    return counts, extra, stats


def gemma_train_counted_run(dev):
    """Phase 25's counted run of the training calls, the main path: (a)
    flash_attn_func at Gemma-2-9B's local and global layers, (c) at
    Gemma-3-4B's local layer, (d) flash_attn_varlen_func over Gemma-2-9B's
    packed documents (both layers), (e) flash_attention_masked over
    Gemma-7B's padded batch and flash_attn_varlen_func over it unpadded,
    each forward and backward (autograd), every plain version forbidden.
    Each call is exactly one launch of B1's and one of B7's D 256
    instantiation of its channels."""
    import torch
    from liteattention_torch import flash_attn_func, flash_attn_varlen_func
    from liteattention_torch.ops.flash_fwd import flash_attention_masked
    from liteattention_torch.utils.padding import unpad_input

    g = torch.Generator(device=dev).manual_seed(2526)

    def rnd(*shape, grad=True):
        x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
        return x.requires_grad_() if grad else x

    def dense(n, h, hk, **kw):  # [B, S, H, D], as flash_attn_func takes them
        q, k, v = rnd(1, n, h, 256), rnd(1, n, hk, 256), rnd(1, n, hk, 256)
        do = rnd(1, n, h, 256, grad=False)
        return lambda: flash_attn_func(q, k, v, causal=True, **kw).backward(do)

    g2 = dict(softcap=GEMMA2_9B_SOFTCAP, softmax_scale=GEMMA2_9B_SCALE)
    n2, h2, hk2 = GEMMA2_9B_TRAIN, GEMMA2_9B["heads"], GEMMA2_9B["kv_heads"]
    docs = packed_docs(dev, GEMMA2_9B_PACK)

    def varlen(**kw):
        q, k, v, do, _, cu = docs
        return lambda: flash_attn_varlen_func(q, k, v, cu, cu, causal=True, **kw).backward(do)

    cfg = GEMMA7B
    b, s, h = cfg["batch"], cfg["seq"], cfg["heads"]
    gl = torch.Generator().manual_seed(cfg["seed"])
    lens = torch.randint(cfg["min_len"], s + 1, (b,), generator=gl).to(dev, torch.int32)
    x7 = [rnd(b, h, s, 256) for _ in range(3)]
    do7 = rnd(b, h, s, 256, grad=False)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None]).to(torch.int32)
    n_tok = int(lens.sum())

    def padded():
        flash_attention_masked(*x7, kv_bound=lens, causal=True).backward(do7)

    def unpadded():
        p = [unpad_input(x.transpose(1, 2), mask, max_tokens=n_tok) for x in (*x7, do7)]
        cu = p[0][2]
        out = flash_attn_varlen_func(p[0][0], p[1][0], p[2][0], cu, cu, causal=True)
        out.backward(p[3][0])

    calls = [("gemma2_9b_local", dense(n2, h2, hk2, window_size=GEMMA2_9B_WINDOW, **g2),
              "window"),
             ("gemma2_9b_global", dense(n2, h2, hk2, **g2), "window"),
             ("gemma3_4b_local", dense(GEMMA3_4B_TOKENS, GEMMA3_4B["heads"],
                                       GEMMA3_4B["kv_heads"], window_size=GEMMA3_4B_WINDOW,
                                       softmax_scale=256**-0.5), "window"),
             ("gemma2_9b_docs_local", varlen(window_size=GEMMA2_9B_WINDOW, **g2),
              "segments_window"),
             ("gemma2_9b_docs_global", varlen(**g2), "segments_window"),
             ("gemma7b_padded", padded, "bound"),
             ("gemma7b_unpadded", unpadded, "segments")]
    torch.cuda.synchronize()
    reset_counts()
    with plain_forbidden():
        for name, call, kind in calls:
            before = read_counts()
            call()
            delta = {n: c - before[n] for n, c in read_counts().items() if c != before[n]}
            want = {f"flash_fwd_{kind}": 1, f"flash_bwd_{kind}": 1}
            check(delta == want, f"phase 25's counted run: {name} launched {delta}, want {want}")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  counted run (flash_attn_func at Gemma-2-9B's two layers and Gemma-3-4B's local one, "
        f"flash_attn_varlen_func over Gemma-2-9B's documents, Gemma-7B's batch padded and "
        f"unpadded; forward and backward): {counts}")
    del docs, x7, do7
    torch.cuda.empty_cache()
    return counts


def gemma_phase(dev, card):
    """Phase 25: head dim 256 with the window, the cap, the key range and
    segments at Gemma-2-9B's, Gemma-3-4B's and Gemma-7B's attention; the
    combinations not built still raise."""
    import torch
    from liteattention_torch.modules.mha import alibi_slopes
    from liteattention_torch.ops.flash_fwd import flash_attention_masked

    t0 = time.perf_counter()
    log(f"  (a), (c)-(e) B1's and B7's D 256 channels against their plain versions [{card}]")
    kres, stats = gemma_kernel_phase(dev)
    secs = {"kernels": time.perf_counter() - t0}
    log("  (b) Gemma-2-9B served through flash_attn_with_kvcache")
    counts = {}
    counts["gemma2_9b_serve"], extra, stats["serve"] = gemma2_serve_phase(dev)
    shapes = kres["flash_fwd_window_d256"]["shapes"]
    shapes.update(extra)
    kres["flash_fwd_window_d256"]["err"] = max(r["err"] for r in shapes.values())
    secs["serve"] = time.perf_counter() - t0 - secs["kernels"]
    counts["gemma_train"] = gemma_train_counted_run(dev)
    # The combinations left out raise before any launch, naming their item.
    q = torch.zeros(1, 4, 128, 256, dtype=torch.bfloat16, device=dev)
    q96 = torch.zeros(1, 4, 128, 96, dtype=torch.bfloat16, device=dev)
    refused = {}
    for name, args, kw, item, kind in (
            ("alibi_at_d256", (q,) * 3, dict(alibi_slopes=alibi_slopes(4).to(dev)), "B-iii 4",
             ValueError),
            ("dropout_at_d256", (q,) * 3, dict(dropout_p=0.1), "B-iii 4", NotImplementedError),
            ("window_at_d96", (q96,) * 3, dict(causal=True, window=(64, 0)), "B-iii 4",
             NotImplementedError)):
        before, err = read_counts(), None
        try:
            flash_attention_masked(*args, **kw)
        except kind as e:
            err = refused[name] = str(e)
        check(err is not None and f"ROADMAP {item}" in err,
              f"phase 25: {name} did not raise naming ROADMAP {item} ({err})")
        check(read_counts() == before, f"phase 25: {name} launched a kernel before it raised")
    log(f"  refused before any launch: {sorted(refused)}")
    stats["refused"] = refused
    secs["all"] = time.perf_counter() - t0
    stats["part_seconds"] = secs
    return counts, kres, stats


# Kernels whose ptxas registers and spills ab_times reports ("flash_bwd"
# names the one-pass backward kernel and the two kernels it replaced;
# "flash_fwd_kernel" B1's wgmma kernel and, walking a live-tile list or a
# coarse schedule, B3, B4 and B5; "attention_fwd_kernel" the mma.sync loop
# that B4 ran on before, kept for older checkouts; "mla_decode_kernel"
# B10; "flash_fwd_dropout_kernel" B1's dropout channel,
# "flash_fwd_window_kernel" its window / chunk / softcap channels and
# "flash_fwd_segments_channels_kernel" the segment walk with them, whose B7
# sides "flash_bwd" names).
AB_KERNELS = ("flash_fwd_kernel", "attention_fwd_kernel", "flash_decode_kernel",
              "mla_fwd_kernel", "mla_decode_kernel", "flash_bwd", "kv_compact_kernel",
              "pack_schedule_kernel", "flash_fwd_dropout_kernel", "flash_fwd_window_kernel",
              "flash_fwd_segments_channels_kernel")


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
    ...; with their times), of B1's and B7's segment walks over four packed
    causal documents at head dims 64 and 128 and of the dense walk's window
    / softcap and dropout instantiations where the checkout has them
    (``b1_segments_d64_digest``, ``b7_window_d128_dkv_digest``, ...; with
    their times), and of the decode kernel's ragged B8 bf16 and
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

    # B1's and B7's segment walks (checkouts since they exist) over packed
    # causal documents, and the dense walk's window / softcap and dropout
    # instantiations (since they exist) at GPT-2 small's and a D 128 shape:
    # digests of out, lse and dK / dV, and device times, so that a checkout
    # that adds instantiations beside them can be seen to leave them as
    # they were.
    seg = {}
    if hasattr(flash_attention, "segment_launches"):
        from liteattention_torch.ops.flash_fwd import flash_attention_masked
        from liteattention_torch.ops.segments import segment_walk

        lengths = torch.tensor([700, 1300, 96, 1900], device=dev)
        ids = torch.repeat_interleave(torch.arange(4, device=dev), lengths).int()[None]
        for sd in (64, 128):
            sq_, sk_, sv_, sdo = (torch.randn(1, 8, ids.shape[1], sd, generator=g,
                                              device=dev).bfloat16() for _ in range(4))
            skw = dict(q_segments=ids, kv_segments=ids)
            so, slse = flash_attention_masked(sq_, sk_, sv_, causal=True, return_lse=True, **skw)
            walk = segment_walk(ids, ids)

            def sbwd(sq_=sq_, sk_=sk_, sv_=sv_, so=so, slse=slse, sdo=sdo, sd=sd, skw=skw,
                     walk=walk):
                return flash_attention_bwd(sq_, sk_, sv_, so, slse, sdo, sd**-0.5, True,
                                           segment_walk=walk, **skw)

            seg[f"b1_segments_d{sd}_digest"] = digest(so, slse)
            seg[f"b7_segments_d{sd}_dkv_digest"] = digest(*sbwd()[1:])
            # The kernels alone, on the precomputed walk (the ranges' small
            # ops would time the host).
            seg[f"b1_segments_d{sd}_ms"] = device_ms(segment_kernel_call(
                sq_, sk_, sv_, sd**-0.5, dict(skw, causal=True)), reps)[0]
            seg[f"b7_segments_d{sd}_ms"] = device_ms(sbwd, reps)[0]
            del sq_, sk_, sv_, sdo, so, slse
    if hasattr(flash_attention, "window_launches"):
        from liteattention_torch.ops.flash_fwd import flash_attention_masked

        for name, shape, wkw in (
                ("window_softcap_d64", (8, 12, 1024, 64), dict(window=(255, 0), softcap=30.0)),
                ("window_d128", (2, 8, 2048, 128), dict(window=(511, 0))),
                ("dropout_d128", (2, 8, 2048, 128),
                 dict(dropout_p=0.1, dropout_seed=torch.tensor([7], device=dev).int()))):
            wq, wk, wv, wdo = (torch.randn(*shape, generator=g, device=dev).bfloat16()
                               for _ in range(4))
            wo, wlse = flash_attention_masked(wq, wk, wv, causal=True, return_lse=True, **wkw)

            def wbwd(wq=wq, wk=wk, wv=wv, wo=wo, wlse=wlse, wdo=wdo, wkw=wkw):
                return flash_attention_bwd(wq, wk, wv, wo, wlse, wdo, wq.shape[-1] ** -0.5, True,
                                           **wkw)

            seg[f"b1_{name}_digest"] = digest(wo, wlse)
            seg[f"b7_{name}_dkv_digest"] = digest(*wbwd()[1:])
            seg[f"b1_{name}_ms"] = device_ms(lambda: flash_attention_masked(
                wq, wk, wv, causal=True, **wkw), reps)[0]
            seg[f"b7_{name}_ms"] = device_ms(wbwd, reps)[0]
            del wq, wk, wv, wdo, wo, wlse
    # Head dim 256's channels (checkouts since they exist): the window and
    # cap, the key range, and the segment walk alone and with the window and
    # cap, digests and times as above.
    from liteattention_torch.ops import flash_bwd as channels_module

    if 256 in getattr(channels_module, "WINDOW_HEAD_DIMS", ()):
        from liteattention_torch.ops.flash_fwd import flash_attention_masked

        # A generator of its own, so that the inputs drawn after this block
        # are the same for checkouts with and without it.
        g256 = torch.Generator(device=dev).manual_seed(2560)
        lengths = torch.tensor([500, 700, 96, 752], device=dev)
        ids = torch.repeat_interleave(torch.arange(4, device=dev), lengths).int()[None]
        for name, shape, wkw in (
                ("window_softcap_d256", (1, 16, 8, 2048),
                 dict(window=(511, 0), softcap=50.0, scale=256**-0.5)),
                ("bound_d256", (2, 8, 8, 1024),
                 dict(kv_bound=torch.tensor([1024, 700], dtype=torch.int32, device=dev))),
                ("segments_d256", (1, 8, 4, 2048), dict(q_segments=ids, kv_segments=ids)),
                ("segments_window_softcap_d256", (1, 8, 4, 2048),
                 dict(q_segments=ids, kv_segments=ids, window=(255, 0), softcap=30.0))):
            b_, h_, hk_, n_ = shape
            wq, wdo = (torch.randn(b_, h_, n_, 256, generator=g256, device=dev).bfloat16()
                       for _ in range(2))
            wk, wv = (torch.randn(b_, hk_, n_, 256, generator=g256, device=dev).bfloat16()
                      for _ in range(2))
            wo, wlse = flash_attention_masked(wq, wk, wv, causal=True, return_lse=True, **wkw)
            bkw = {n: x for n, x in wkw.items() if n != "scale"}
            wscale = wkw.get("scale", 256**-0.5)

            def wbwd(wq=wq, wk=wk, wv=wv, wo=wo, wlse=wlse, wdo=wdo, bkw=bkw, wscale=wscale):
                return flash_attention_bwd(wq, wk, wv, wo, wlse, wdo, wscale, True, **bkw)

            seg[f"b1_{name}_digest"] = digest(wo, wlse)
            seg[f"b7_{name}_dkv_digest"] = digest(*wbwd()[1:])
            seg[f"b1_{name}_ms"] = device_ms(lambda: flash_attention_masked(
                wq, wk, wv, causal=True, **wkw), reps)[0]
            seg[f"b7_{name}_ms"] = device_ms(wbwd, reps)[0]
            del wq, wk, wv, wdo, wo, wlse

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
    mla_outs = [flash_attention(pq, pk, pv, causal=True, return_lse=True)]
    for key, x in zip(("b1mla_576_ms", "b1mla_qv_ms"), mla_abs_inputs(dev).values()):
        xh = [a.transpose(1, 2).contiguous() for a in x]
        mla[key] = cuda_ms(lambda: flash_attention(
            xh[0], xh[1], xh[2], causal=True, qv=xh[3] if len(xh) > 3 else None), reps)
        mla_outs.append(flash_attention(xh[0], xh[1], xh[2], causal=True,
                                        qv=xh[3] if len(xh) > 3 else None, return_lse=True))
    # B1-MLA's outputs (out, lse) at the three shapes, so that two
    # checkouts can be seen to compute the same bits.
    mla["b1mla_digest"] = digest(*(t for o in mla_outs for t in o))
    del mla_outs
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
        **b1, **channels, **seg, **b2, **b4, **b10, **mla, **b6, **digests, **hd,
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
        phase("phase 16: window, attention_chunk and softcap at Mistral-7B, Gemma-2 and "
              "Llama-4-Scout settings; the kvcache API with them")
        counts["window"], p16_kres, p16_stats = window_phase(dev, card)
        kres.update(p16_kres)
        phase("phase 17: configs/experiment/gpt2s-moe.yaml trained at GPT-2 small's width through "
              "the config tree")
        counts["moe_train"], p17_stats = moe_phase(dev, card)
        phase("phase 18: ViT-B/16, forward and one training step")
        counts["vit"], p18_kres, p18_stats = vit_phase(dev, card)
        phase("phase 19: Falcon-7B served from a remapped HF state dict (71 q heads on one KV "
              "head)")
        counts["falcon_serve"], p19_kres, p19_stats = falcon_phase(dev, card)
        phase("phase 20: the kvcache API's rest: a continuous batch at Llama-3-8B width "
              "(varlen q, rotary, cache_batch_idx), DeepSeek-V3 MLA decode through qv, int8_mma")
        counts["kvcache_rest"], p20_kres, p20_stats = kvcache_rest_phase(dev, card)
        kres.update(p20_kres)
        phase("phase 21: the GPT-NeoX family: the decode kernel at head dims 80 and 96, B1's and "
              "B7's channels at 96; Pythia-2.8B and GPT-NeoX-20B served")
        p21_counts, p21_kres, p21_stats = neox_phase(dev, card)
        phase("phase 22: parallel/ on torch.distributed: Wan2.1-14B sequence-parallel and "
              "OPT-1.3B tensor-parallel at two ranks on the card (gloo), Ulysses; every new entry "
              "point and ring attention at world size 1 (NCCL)")
        p22_counts, p22_stats = parallel_phase(dev, card)
        counts.update(p22_counts)
        phase("phase 23: the training half of parallel/ at two ranks on the card (gloo): "
              "run.data_parallel with ZeRO-1/2 and the bfloat16 wire at gpt2s-moe, OPT-1.3B's "
              "tensor-parallel training step, pipeline_apply over GPT-2 XL's blocks, "
              "moe_apply_sharded")
        p23_counts, p23_stats = training_parallel_phase(dev, card)
        counts.update(p23_counts)
        phase("phase 24: the varlen functions with window, softcap and dropout over packed "
              "documents: Mistral-7B's window, Gemma-2-27B's local and global layers, BERT-large's "
              "dropout 0.1")
        counts["varlen_channels"], p24_kres, p24_stats = varlen_channel_phase(dev, card)
        kres.update(p24_kres)
        phase("phase 25: head dim 256 with the window, the cap, the key range and segments: "
              "Gemma-2-9B's and Gemma-3-4B's attention, Gemma-7B's padded batch")
        p25_counts, p25_kres, p25_stats = gemma_phase(dev, card)
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
    # Phase 18's and 19's shapes under the kernels they ran: B1 and B7 at
    # ViT-B/16's attention (non-causal, 197 tokens), B1's bound and the
    # decode kernel at Falcon-7B's group of 71.
    vit_fwd = p18_kres["fwd"]
    kres["flash_fwd"]["vit_b16_noncausal"] = {"max_abs_err": vit_fwd["err"], **{
        k: vit_fwd[k] for k in timed_keys + ("rel_l2", "worst_block_rel_l2") if k in vit_fwd}}
    kres["flash_fwd"]["err"] = max(kres["flash_fwd"]["err"], vit_fwd["err"])
    for name, r in p18_kres["bwd"].items():
        if name in ("flash_bwd_dq", "flash_bwd_dkv"):
            kres[name]["vit_b16_noncausal"] = {"max_abs_err": r["err"], **{
                k: r[k] for k in bwd_keys if k in r}}
            kres[name]["err"] = max(kres[name]["err"], r["err"])
    kres["flash_fwd_bound"]["shapes"]["falcon_7b_prefill_group71"] = p19_kres["fwd_bound"]
    kres["flash_fwd_bound"]["err"] = max(kres["flash_fwd_bound"]["err"],
                                         p19_kres["fwd_bound"]["err"])
    kres["flash_decode"]["falcon_7b_group71"] = p19_kres["decode"]
    kres["flash_decode"]["err"] = max(kres["flash_decode"]["err"], p19_kres["decode"]["err"])
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
        "flash_fwd_window": ("flash_fwd_window.cu", "flash_fwd_window_kernel",
                             "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_bwd_window": ("flash_bwd_window.cu", "flash_bwd_window_kernel",
                             "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_fwd_mla_bound": ("flash_fwd.cu", "flash_fwd_kernel<192, 128, ...> (key range)",
                                "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_fwd_mla_v512_bound": ("mla_fwd.cu", "mla_fwd_kernel<QV, true, true> (RANGE)",
                                     "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_decode_batch_idx": ("flash_decode.cu", "flash_decode_kernel (cache_batch_idx)",
                                   "liteattention_tpu/ops/flash_fwd.py:843"),
        "flash_decode_int8_mma": ("flash_decode.cu", "flash_decode_kernel<D, uint8_t, true>",
                                  "liteattention_tpu/ops/flash_fwd.py:843"),
        "paged_decode_folded_int8_mma": ("flash_decode.cu",
                                         "flash_decode_kernel<D, uint8_t, true>",
                                         "liteattention_tpu/ops/paged_attention.py:276"),
        "flash_fwd_segments_window": ("flash_fwd_segments_channels.cu",
                                      "flash_fwd_segments_channels_kernel<D, CAUSAL, WINDOW, "
                                      "SOFTCAP, false>", "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_bwd_segments_window": ("flash_bwd_segments_channels.cu",
                                      "flash_bwd_segments_channels_kernel<D, CAUSAL, false, "
                                      "WINDOW, SOFTCAP>", "liteattention_tpu/ops/flash_bwd.py:55"),
        "flash_fwd_segments_dropout": ("flash_fwd_segments_channels.cu",
                                       "flash_fwd_segments_channels_kernel<D, CAUSAL, false, "
                                       "false, true>", "liteattention_tpu/ops/flash_fwd.py:84"),
        "flash_bwd_segments_dropout": ("flash_bwd_segments_channels.cu",
                                       "flash_bwd_segments_channels_kernel<D, CAUSAL, true, "
                                       "false, false>", "liteattention_tpu/ops/flash_bwd.py:55"),
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
        paths = {path: c[counter] for path, c in p14_counts.items()}
        # Phase 25's paths run at head dim 256 too: its prefill-free B1
        # bound calls (Gemma-7B's padded batch) and its global layer's
        # decode steps.
        paths.update({f"phase 25 {path}": c[counter] for path, c in p25_counts.items()})
        row = entry(name, src, kernel, replaces, r, paths)
        if name == "flash_bwd_d256":
            row.update(dkv=p14_kres["bwd_causal"]["flash_bwd_dkv"],
                       fwd_bwd=p14_kres["bwd_causal"]["fwd_bwd"])
        if name == "flash_fwd_bound_d256":
            row["gemma7b_padded"] = p25_kres["flash_fwd_bound_d256"]
            row["max_abs_err"] = max(row["max_abs_err"], p25_kres["flash_fwd_bound_d256"]["err"])
        kernels.append(row)
    # Head dim 256's channels (phase 25): each row's instantiation source,
    # its kernel, the TPU kernel it replaces and the counter it shares with
    # its D 64 / 128 row; its launches are phase 25's paths' (every path
    # there runs at 256 only).
    gemma = {
        "flash_fwd_window_d256": ("flash_fwd_d256_window.cu",
                                  "flash_fwd_window_kernel<256, CAUSAL, WINDOW, SOFTCAP>",
                                  "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd_window"),
        "flash_bwd_window_d256": ("flash_bwd_d256_window.cu",
                                  "flash_bwd_d256_channels_kernel<CAUSAL, true, false, WINDOW, "
                                  "SOFTCAP>", "liteattention_tpu/ops/flash_bwd.py:55",
                                  "flash_bwd_window"),
        "flash_fwd_segments_window_d256": ("flash_fwd_d256_segments.cu",
                                           "flash_fwd_segments_channels_kernel<256, CAUSAL, "
                                           "WINDOW, SOFTCAP, false>",
                                           "liteattention_tpu/ops/flash_fwd.py:84",
                                           "flash_fwd_segments_window"),
        "flash_bwd_segments_window_d256": ("flash_bwd_d256_segments.cu",
                                           "flash_bwd_d256_channels_kernel<CAUSAL, false, true, "
                                           "WINDOW, SOFTCAP>",
                                           "liteattention_tpu/ops/flash_bwd.py:55",
                                           "flash_bwd_segments_window"),
        "flash_fwd_segments_d256": ("flash_fwd_d256_segments.cu",
                                    "flash_fwd_kernel<256, 256, CAUSAL, kSegment>",
                                    "liteattention_tpu/ops/flash_fwd.py:84",
                                    "flash_fwd_segments"),
        "flash_bwd_segments_d256": ("flash_bwd_d256_segments.cu",
                                    "flash_bwd_d256_channels_kernel<CAUSAL, false, true, false, "
                                    "false>", "liteattention_tpu/ops/flash_bwd.py:55",
                                    "flash_bwd_segments"),
        "flash_bwd_bound_d256": ("flash_bwd_d256.cu",
                                 "flash_bwd_d256_channels_kernel<CAUSAL, true, false, false, "
                                 "false> (RANGE)", "liteattention_tpu/ops/flash_bwd.py:55",
                                 "flash_bwd_bound"),
    }
    for name, (src, kernel, replaces, counter) in gemma.items():
        kernels.append(entry(name, src, kernel, replaces, p25_kres[name],
                             {path: c[counter] for path, c in p25_counts.items()}))
    # Head dims 80 and 96 (phase 21): each row's instantiation source, its
    # kernel, the TPU kernel it replaces, the counter it shares with its
    # row above, the phase-21 paths that run it at this head dim, and phase
    # 21 (a)'s result.
    hd = {
        "flash_fwd_bound_d80": ("flash_fwd_hd.cu", "flash_fwd_kernel<80, 80, ...> (key range)",
                                "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd_bound",
                                ("pythia_serve",), p21_kres["fwd_bound_pythia_d80"]),
        "flash_fwd_bound_d96": ("flash_fwd_hd.cu", "flash_fwd_kernel<96, 96, ...> (key range)",
                                "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd_bound",
                                ("neox_serve",), p21_kres["fwd_bound_neox20b_d96"]),
        "flash_fwd_alibi_d96": ("flash_fwd_hd.cu", "flash_fwd_kernel<96, 96, ..., ALIBI>",
                                "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd_alibi",
                                ("neox_attention",), p21_kres["fwd_alibi_d96"]),
        "flash_bwd_bound_d96": ("flash_bwd_hd.cu", "flash_bwd_kernel<96, ..., RANGE>",
                                "liteattention_tpu/ops/flash_bwd.py:55", "flash_bwd_bound",
                                ("neox_attention",), p21_kres["bwd_bound_d96"]),
        "flash_bwd_alibi_d96": ("flash_bwd_hd.cu", "flash_bwd_kernel<96, ..., RANGE, ALIBI>",
                                "liteattention_tpu/ops/flash_bwd.py:55", "flash_bwd_alibi",
                                ("neox_attention",), p21_kres["bwd_alibi_d96"]),
        "flash_fwd_segments_d96": ("flash_fwd_segments.cu",
                                   "flash_fwd_kernel<96, 96, ..., kSegment>",
                                   "liteattention_tpu/ops/flash_fwd.py:84", "flash_fwd_segments",
                                   ("neox_attention",), p21_kres["fwd_segments_d96"]),
        "flash_bwd_segments_d96": ("flash_bwd_segments.cu", "flash_bwd_segments_kernel<96, ...>",
                                   "liteattention_tpu/ops/flash_bwd.py:55", "flash_bwd_segments",
                                   ("neox_attention",), p21_kres["bwd_segments_d96"]),
        "flash_decode_d80": ("flash_decode_hd.cu", "flash_decode_kernel<80, ...>",
                             "liteattention_tpu/ops/flash_fwd.py:843", "flash_decode",
                             ("pythia_serve",), p21_kres["decode_pythia_d80"]),
        "flash_decode_d96": ("flash_decode_hd.cu", "flash_decode_kernel<96, ...>",
                             "liteattention_tpu/ops/flash_fwd.py:843", "flash_decode",
                             ("neox_serve", "neox_attention"), p21_kres["decode_neox20b_d96"]),
        "flash_decode_batch_idx_d96": ("flash_decode_hd.cu",
                                       "flash_decode_kernel<96, bf16, false, true>",
                                       "liteattention_tpu/ops/flash_fwd.py:843",
                                       "flash_decode_batch_idx", ("neox_attention",),
                                       p21_kres["decode_batch_idx_d96"]),
        "paged_decode_d96": ("flash_decode_hd.cu", "flash_decode_kernel<96, ...>",
                             "liteattention_tpu/ops/paged_attention.py:40", "paged_decode",
                             ("neox_attention",), p21_kres["paged_d96"]),
        "paged_decode_folded_d96": ("flash_decode_hd.cu", "flash_decode_kernel<96, ...>",
                                    "liteattention_tpu/ops/paged_attention.py:276",
                                    "paged_decode_folded", ("neox_attention",),
                                    p21_kres["paged_folded_d96"]),
    }
    for name, (src, kernel, replaces, counter, paths, r) in hd.items():
        kernels.append(entry(name, src, kernel, replaces, r,
                             {path: p21_counts[path][counter] for path in paths}))
    # The int8_mma rows (phase 20) gain the kernel alone beside the dequant
    # kernel, timed in turns at the kvcache API shape in phase 21.
    mma = p21_kres["int8_mma_kernel"]
    for row in kernels:
        form = {"flash_decode_int8_mma": "contiguous",
                "paged_decode_folded_int8_mma": "paged"}.get(row["name"])
        if form is not None:
            row["kernel_alone"] = {k: x for k, x in mma.items()
                                   if k.startswith(form) or k in ("shape", "card")}
    for n, st in ((10, p10_stats), (11, p11_stats), (12, p12_stats), (13, p13_stats),
                  (14, p14_stats), (15, p15_stats), (16, p16_stats), (17, p17_stats),
                  (18, p18_stats), (19, p19_stats), (20, p20_stats), (21, p21_stats),
                  (22, p22_stats), (23, p23_stats), (24, p24_stats), (25, p25_stats)):
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
    log(f"window, chunk and softcap: {json.dumps(p16_stats)}")
    log(f"config-tree MoE training (gpt2s-moe): {json.dumps(p17_stats)}")
    log(f"vit-b/16: {json.dumps(p18_stats)}")
    log(f"falcon-7b serving: {json.dumps(p19_stats)}")
    log(f"kvcache api rest: {json.dumps(p20_stats)}")
    log(f"gpt-neox family: {json.dumps(p21_stats)}")
    log(f"parallel (two ranks on one card; times are no measure of parallel speed): "
        f"{json.dumps(p22_stats)}")
    log(f"parallel training (two ranks on one card; times are no measure of parallel speed): "
        f"{json.dumps(p23_stats)}")
    log(f"varlen channels: {json.dumps(p24_stats)}")
    log(f"head dim 256 channels (gemma): {json.dumps(p25_stats)}")
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
