// B7: dense flash-attention backward on Hopper, one pass in three launches.
// It computes what the Pallas kernels
// liteattention_tpu/ops/flash_bwd.py:_dq_kernel (B7a, dQ) and _dkv_kernel
// (B7b, dK/dV) compute, and delta = rowsum(O * dO) (the JAX function's XLA
// pass), in the shape of FlashAttention-3's backward:
//
// (a) bwd_pre_kernel: delta in fp32 from the bf16 O and dO, lse in log2
//     units (lse -inf gives +inf, so P = 0 on a row with no valid key), and
//     the fp32 dQ accumulator set to 0. Rows are padded to a multiple of 64
//     (delta 0, lse2 +inf there).
// (b) flash_bwd_kernel: one CTA per (b, kv-head, 128-key tile), the longest
//     causal walks first; two warpgroups, 64 keys each. K and V stay in
//     shared memory. The CTA walks the group's q-heads and, per head, the
//     64-row q-tiles from the first one that reaches the k-tile's diagonal
//     (non-causal: from a q-tile that moves with the k-tile, so that the
//     CTAs of one head do not add into the same dQ rows at the same time).
//     Q and dO tiles (TMA, 128-byte swizzle) and their lse2 and delta rows
//     (bulk copies) arrive through a ring of kStages mbarrier stages, which
//     thread 0 refills kStages - 1 steps ahead. Five wgmma products a step:
//       S^T = K Q^T, dP^T = V dO^T                    (shared-memory operands)
//       P^T = exp2(S^T scale log2e - lse2), masked    (ragged Sk, causal)
//       dS^T = P^T (dP^T - delta) scale
//       dV += P^T dO, dK += dS^T Q                    (P^T, dS^T from registers)
//       dQ_part = dS K                                 (dS^T via shared memory)
//     Computing S^T rather than S puts the keys on the accumulator's rows,
//     so P^T and dS^T feed dV and dK from registers; Q, dO, dS and K are
//     read as MN-major operands. dQ_part goes through shared memory (in
//     the accumulator's own thread order) and is added to the fp32 dQ
//     accumulator by one bulk reduce-add per step. The GQA group sum of
//     dK/dV stays in one CTA's registers, so dK and dV are bit-stable;
//     dQ is summed across CTAs by atomics in no fixed order, so its last
//     bits may change from run to run.
// (c) bwd_post_kernel: the dQ accumulator to bf16 in q's layout.
//
// As in the JAX kernels P and dS are rounded to bf16 before they feed a
// product, and every product accumulates in fp32. Masks: ragged Sq / Sk and
// the bottom-right-aligned causal channel (key col valid for q row r iff
// col <= r + Sk - Sq), tested by key_mask.cuh's key_masked, the test the
// forward kernels use.
//
// B1's per-batch channels, backwards (entry lite_flash_bwd_masked; the JAX
// kernels' has_bound, bound_causal, has_low and has_alibi): the keys of
// batch b are [kv_low[b], min(Sk, kv_bound[b])), with bound_causal the
// diagonal at kv_bound[b] - Sq (the smaller of the two when causal too;
// bound_causal alone runs the CAUSAL instantiation at the bound's diagonal).
// They are the RANGE instantiations: a CTA reads its batch's range once into
// a KeyRange, folds the limit and the diagonal into the two bounds of the
// test the channel-free kernel already makes (and adds the low key), starts
// its causal walk at the bound's diagonal, and walks nothing when its k-tile
// lies wholly past the limit or below the low key (it still stores its zero
// dK and dV rows). ALIBI adds the bias -slope[b, h] log2(e) (|r + Sk - Sq -
// col| - shift) to the log2-space scores, the slope per step of the walk
// (the walk crosses the GQA group's q-heads; their slopes sit in shared
// memory), as B1 does: with bound_causal shift = Sk - kv_bound[b], the least
// distance of a visible key, which B1 drops from the scores and from lse
// (flash_fwd.cu); bwd_pre_kernel adds slope shift back to lse, so P is
// recomputed from the same small scores B1 summed. The channel-free
// instantiations are left as they were.
//
// The segment channel (the JAX kernels' has_segments, batch 1; kernel
// flash_bwd_segments_kernel, entry lite_flash_bwd_segments in
// flash_bwd_segments.cu): a key is seen by the q rows whose segment id
// equals its own. A CTA walks only the 64-row q-steps inside its k-tile's
// row range [x, y), which the wrapper computes on the device
// (ops/segments.py: for ids in order apart from negative markers, exactly
// the rows of the k-tile's segments, else [0, Sq)), from the causal
// diagonal on. The element test is B1's (key_mask.cuh), with this
// thread's two keys' ids read once; a step whose 64 rows and the k-tile's
// keys all carry one id skips it (each 64-row block's and each k-tile's
// least and largest id come from the wrapper). Rows with lse -inf (no key
// of their id) add 0 to dQ, dK and dV. The segment walk takes the dropout,
// window and softcap channels below too (at D 64 and 128: DROPOUT, WINDOW,
// SOFTCAP or both of the last two; kernel flash_bwd_segments_channels_kernel
// and entry lite_flash_bwd_segments_channels in
// flash_bwd_segments_channels.cu): a CTA walks the q-steps of its segments'
// rows that the window reaches, the element test takes the ids and the
// window together on the steps that need either, and dropout regenerates
// B1's bit at b = 0.
//
// Attention dropout (the DROPOUT instantiations: the RANGE walk at D 64 and
// 128; kernel flash_bwd_dropout_kernel, entry lite_flash_bwd_dropout in
// flash_bwd_dropout.cu; the JAX kernels' dropout_p): each score of the step
// regenerates B1's keep bit (key_mask.cuh's dropout_keep at (seed, the
// step's b * H + q head, the global q row, the global key)), and, as in
// JAX's _dkv_kernel and _dq_kernel, dV takes D P and dS = P (D dP - delta)
// with D = keep / (1 - p); delta is rowsum(O dO) of B1's dropped output.
//
// The window and softcap channels (the WINDOW / SOFTCAP instantiations: the
// RANGE walk at D 64 and 128; kernel flash_bwd_window_kernel, entry
// lite_flash_bwd_window in flash_bwd_window.cu; the JAX kernels' window and
// softcap): a 128-key CTA walks only the 64-row q-steps whose rows' windows
// reach its keys (the mirror of B1's window_range: row r at pos = r + off
// sees [pos - left, pos + right], so the rows are those with r + off +
// right >= k0 and r + off - left < k0 + 128), and a step whose rows and
// this warp's keys all lie inside each other's windows skips the
// per-element test. SOFTCAP recomputes B1's capped scores t = tanh(s scale
// / cap) (key_mask.cuh's softcap_tanh), P = exp2(cap t log2(e) - lse2), and
// dS = P (dP - delta) (1 - t^2) scale: the cap's derivative, taken before
// the mask as JAX takes it. attention_chunk is forward-only, as in JAX.
//
// Head dims 80 (BTLM) and 96 (GPT-NeoX-20B), as in B1: every K, V, Q and
// dO tile takes two 64-value atoms (sm90.cuh; the second partly filled by
// TMA, zeros past column D), so shared memory is D 128's; S^T and dP^T run
// D / 16 k-steps and dV and dK one wgmma at N = D. dQ = dS K splits its
// columns by atom: warpgroup 0 takes atom 0, warpgroup 1 atom 1 (a
// wgmma starts an MN-major operand at an atom or 16-byte chunk of one row,
// and its N columns run on from there, so a split at column D / 2 would
// have to start warpgroup 1 in the middle of a row and cross into the next
// atom, which the descriptor cannot express). Warpgroup 1's product then
// runs over atom 1's zero padding too (48 of its 64 columns at D 80, 32 at
// D 96: 12 % and 7 % more MMA work a step), so that both warpgroups issue
// the same instruction outside a branch, and stores only its D - 64 real
// columns. The RANGE, ALIBI and segment instantiations are built at both.
// At head dim 256 B7 is flash_bwd_d256.cu's kernel of its own, with the
// RANGE, WINDOW / SOFTCAP and segment channels as template flags there.
//
// What bounds it on the H100: tensor-core throughput (10 d FLOPs per
// (q row, key) pair, against bytes read once that are a small share at
// these shapes). The design keeps every product on wgmma fed by TMA, and
// computes S and dP once per pair. Registers: the dK and dV accumulators
// (128 keys x D fp32) with S^T and dP^T take ~200 per thread at D 128.
// There is no separate producer warp: a CTA of more than 256 threads gets
// at most 168 registers from ptxas, and setmaxnreg did not raise that
// budget (ptxas kept 168, spilled at D 128 and serialised every wgmma),
// so thread 0 issues the loads between products and the CTA keeps 256
// threads with up to 255 registers.
#include <math.h>

#include "key_mask.cuh"
#include "sm90.cuh"

namespace lite {
namespace bwd {

using sm90::desc_sw128;

constexpr int kKeys = 128;  // keys per CTA, 64 per consumer warpgroup
constexpr int kRows = 64;   // q rows per step of the walk
constexpr int kStages = 3;  // Q/dO ring depth
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  float* dq_accum;     // [B, H, Sq_pad, D] fp32, per 64-row block in thread order
  const float* lse2;   // [B, H, Sq_pad]
  const float* delta;  // [B, H, Sq_pad]
  __nv_bfloat16* dk;   // [B, Hk, Sk, D]
  __nv_bfloat16* dv;   // [B, Hk, Sk, D]
  int batch, heads, kv_heads, seqlen_q, seqlen_k, seqlen_q_pad;
  int causal_offset;  // Sk - Sq
  float scale;        // softmax scale
  float scale_log2;   // scale * log2(e)
};

// B1's per-batch channels arrive as key_mask.cuh's Channels, a kernel
// argument of their own so that the channel-free instantiations' Params
// stay as they were; a CTA reads its batch's KeyRange once.

// The most q-heads per kv-head whose ALiBi slopes a CTA keeps.
constexpr int kMaxGroup = 256;

// Shared-memory layout (byte offsets from a 1024-byte aligned base); tiles
// in 64-value atoms of 128-byte rows (two at D 80 and 96).
template <int D>
struct Smem {
  static constexpr int kKV = kKeys * sm90::atoms(D) * 128;  // one K or V tile
  static constexpr int kQ = kRows * sm90::atoms(D) * 128;   // one Q or dO tile
  static constexpr int k = 0;
  static constexpr int v = k + kKV;
  static constexpr int q = v + kKV;                // [kStages]
  static constexpr int dout = q + kStages * kQ;    // [kStages]
  static constexpr int ds = dout + kStages * kQ;   // dS^T [128 keys][64 rows]
  static constexpr int dq = ds + kKeys * kRows * 2;  // fp32 [64 * D]
  static constexpr int lse2 = dq + kRows * D * 4;    // [kStages][64]
  static constexpr int delta = lse2 + kStages * kRows * 4;
  static constexpr int bars = delta + kStages * kRows * 4;  // kv, full[kStages]
  static constexpr int bytes = bars + (1 + kStages) * 8;
  // ALIBI only: the group's slopes times log2(e), [kMaxGroup].
  static constexpr int slopes = bytes;
  static constexpr int bytes_alibi = slopes + kMaxGroup * 4;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// ------------------------------------------------------------ (a) pre

// With SHIFT (ALiBi with bound_causal) lse takes back the constant B1 left
// out of the scores, slope[b, h] (Sk - kv_bound[b]), before it goes to log2
// units, so that the main kernel's scores, which leave it out too, meet it.
struct LseShift {
  const float* alibi;    // [B, H] slopes
  const int* kv_bound;   // [B]
  int heads, seqlen_k;
};

// Threads per row of bwd_pre_kernel, 8 values each: D / 8 rounded up to a
// power of two (the row's sum is a butterfly over its lanes; at D 80 and
// 96 lanes 10-15 and 12-15 hold no values; at 256 a whole warp).
__host__ __device__ constexpr int pre_lanes(int d) {
  return d / 8 == 8 || d / 8 == 16 || d / 8 == 32 ? d / 8 : 16;
}

template <int D, bool SHIFT>
__global__ void bwd_pre_kernel(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ lse2,
                               float* __restrict__ delta, float* __restrict__ dq_accum,
                               int seqlen_q, int seqlen_q_pad, int rows, LseShift sh) {
  constexpr int kLanes = pre_lanes(D);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kLanes;
  const int part = gid % kLanes;
  const bool live = row < rows;
  const int bh = row / seqlen_q_pad;
  const int r = row % seqlen_q_pad;
  const bool valid = live && r < seqlen_q;
  const bool chunk = kLanes == D / 8 || part < D / 8;  // this lane holds values
  float acc = 0.f;
  if (valid && chunk) {
    const size_t off = (static_cast<size_t>(bh) * seqlen_q + r) * D + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(b2[i]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int s = kLanes / 2; s > 0; s /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (!live) return;
  if (chunk) {
    float4* z = reinterpret_cast<float4*>(dq_accum + static_cast<size_t>(row) * D + part * 8);
    z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (part == 0) {
    delta[row] = valid ? acc : 0.f;
    float l = valid ? lse[static_cast<size_t>(bh) * seqlen_q + r] : 0.f;
    if (SHIFT && valid && l != -INFINITY) {
      const int shift = max(sh.seqlen_k - __ldg(sh.kv_bound + bh / sh.heads), 0);
      l += __ldg(sh.alibi + bh) * static_cast<float>(shift);
    }
    lse2[row] = valid ? lse_log2(l) : INFINITY;
  }
}

// ----------------------------------------------------------- (b) main

// The CTA's walk: step it visits q-head bh(it), rows row0(it) .. + 63.
// Causal walks start at the k-tile's diagonal; non-causal ones start at a
// q-tile that moves with the k-tile, so that the CTAs of one head add into
// different dQ rows at a time.
struct Walk {
  int bh0;      // b * H + the group's first q-head
  int q_first;  // first q-tile of each head's walk
  int nq;       // q-tiles per head
  int rot;      // q-tile (after q_first) each head's walk starts at
  __device__ __forceinline__ int bh(int it) const { return bh0 + it / nq; }
  __device__ __forceinline__ int row0(int it) const {
    int i = it % nq + rot;
    if (i >= nq) i -= nq;
    return (q_first + i) * kRows;
  }
};

// The walk's q-tiles for KEYS keys from k0 (flash_bwd_d256.cu's 64-key
// CTAs; bwd_cta below spells out the same policy at 128 keys, since
// calling this there changes ptxas's register allocation of its
// instantiations): the first and their count. CAUSAL starts at the
// diagonal (the range's with RANGE); SEG keeps the q rows whose segments
// meet the keys of span tile `span` (ops/segments.py's row range, per 128
// keys); WINDOW reads the window into `wnd` and keeps the q rows whose
// window reaches the keys, row + off + right >= k0 and row + off - left <
// k0 + KEYS (each end of a row's window is nondecreasing in the row: B1's
// window_range, mirrored); RANGE walks nothing when the keys lie wholly
// past the limit or below the low key (their dK and dV rows are stored as
// zeros).
template <int KEYS, bool CAUSAL, bool RANGE, bool SEG, bool WINDOW>
__device__ __forceinline__ int2 walk_rows(const Params& p, const Channels& c,
                                          const KeyRange& range, Window& wnd, int b, int k0,
                                          int span) {
  const int qtiles = p.seqlen_q_pad / kRows;
  int q_first = 0;
  if constexpr (CAUSAL) {  // the first q-tile whose last row reaches the first key
    const int x = k0 - (RANGE ? range.diag : p.causal_offset);
    q_first = x < 0 ? 0 : min(qtiles, x / kRows);
  }
  int nq = qtiles - q_first;
  if constexpr (SEG) {
    const int2 rows = segment_range(c, span);
    q_first = max(q_first, rows.x / kRows);
    nq = max(min(qtiles, (rows.y + kRows - 1) / kRows) - q_first, 0);
  }
  if constexpr (WINDOW) {
    wnd = window_of(c, b, p.seqlen_q, p.seqlen_k);
    int q_end = SEG ? q_first + nq : qtiles;  // inside the segments' rows
    if (wnd.right >= 0) {
      q_first = max(q_first, min(qtiles, max(k0 - wnd.right - wnd.off, 0) / kRows));
    }
    if (wnd.left >= 0) {
      const int rows_end = k0 + KEYS + wnd.left - wnd.off;
      q_end = rows_end <= 0 ? 0 : min(q_end, (rows_end + kRows - 1) / kRows);
    }
    nq = max(q_end - q_first, 0);
  }
  if (RANGE && (k0 >= range.lim || k0 + KEYS <= range.low)) nq = 0;
  return make_int2(q_first, nq);
}

// Whether entry (key, row) of a step is hidden: key_masked with the
// channels' bounds, each moved out of reach where its flag says the step's
// keys cannot cross it (ragged: the range's limit and low key, else Sk;
// diag: the diagonal, the range's with RANGE; seg_test: the row's id
// against the key's `kid`; win_test: the row's window [row + win_lo, row +
// win_hi]). One branch-free test on every tile (on an H100 faster than
// testing the tile flags per element). The D 256 kernel's; consume spells
// out the same dispatch (as walk_rows, to keep its register allocation).
template <bool CAUSAL, bool RANGE, bool SEG, bool WINDOW>
__device__ __forceinline__ bool entry_masked(const Params& p, const Channels& c,
                                             const KeyRange& r, int diag_off, int key, int row,
                                             bool ragged, bool diag, bool seg_test, int kid,
                                             bool win_test, int win_lo, int win_hi) {
  if constexpr (SEG && WINDOW) {
    return key_masked<CAUSAL>(key, row, ragged ? p.seqlen_k : kNoBound,
                              diag ? p.causal_offset : kNoBound, 0,
                              seg_test ? __ldg(c.q_seg + row) : 0, seg_test ? kid : 0,
                              win_test ? make_int2(row + win_lo, row + win_hi + 1)
                                       : make_int2(-kNoBound, kNoBound));
  } else if constexpr (WINDOW) {
    return key_masked<CAUSAL>(key, row, ragged ? r.lim : kNoBound, diag ? diag_off : kNoBound,
                              ragged ? r.low : 0,
                              win_test ? make_int2(row + win_lo, row + win_hi + 1)
                                       : make_int2(-kNoBound, kNoBound));
  } else if constexpr (RANGE) {
    return key_masked<CAUSAL>(key, row, ragged ? r.lim : kNoBound, diag ? diag_off : kNoBound,
                              ragged ? r.low : 0);
  } else if constexpr (SEG) {
    return key_masked<CAUSAL>(key, row, ragged ? p.seqlen_k : kNoBound,
                              diag ? p.causal_offset : kNoBound, 0,
                              seg_test ? __ldg(c.q_seg + row) : 0, seg_test ? kid : 0);
  } else {
    return key_masked<CAUSAL>(key, row, ragged ? p.seqlen_k : kNoBound,
                              diag ? p.causal_offset : kNoBound);
  }
}

// K and V of the CTA's k-tile, once.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                        unsigned char* smem, int k0, int kvh) {
  using L = Smem<D>;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  sm90::mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
  for (int a = 0; a < sm90::atoms(D); ++a) {
    sm90::tma_load_3d(smem + L::k + a * kKeys * 128, &tm_k, kv_full, 64 * a, k0, kvh);
    sm90::tma_load_3d(smem + L::v + a * kKeys * 128, &tm_v, kv_full, 64 * a, k0, kvh);
  }
}

// Step `it` of the walk (q-head bh, rows row0..): the Q and dO tiles (TMA)
// and their lse2 and delta rows (bulk copies) into ring stage it % kStages.
template <int D>
__device__ __forceinline__ void load_step(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                                          const Params& p, unsigned char* smem, int stage,
                                          int bh, int row0) {
  using L = Smem<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars) + 1 + stage;
  sm90::mbar_expect_tx(full, 2 * L::kQ + 2 * kRows * 4);
#pragma unroll
  for (int a = 0; a < sm90::atoms(D); ++a) {
    sm90::tma_load_3d(smem + L::q + stage * L::kQ + a * kRows * 128, &tm_q, full, 64 * a, row0,
                      bh);
    sm90::tma_load_3d(smem + L::dout + stage * L::kQ + a * kRows * 128, &tm_do, full, 64 * a,
                      row0, bh);
  }
  const size_t stat = static_cast<size_t>(bh) * p.seqlen_q_pad + row0;
  sm90::bulk_load(smem + L::lse2 + stage * kRows * 4, p.lse2 + stat, kRows * 4, full);
  sm90::bulk_load(smem + L::delta + stage * kRows * 4, p.delta + stat, kRows * 4, full);
}

// The two warpgroups: wg owns keys k0 + 64 wg .. + 63. Thread 0 also
// refills the ring and adds each step's dQ part to the accumulator. RANGE
// takes the keys of `r` (B1's channels), ALIBI the bias with the group's
// slopes from shared memory, SEG the segment ids of `c`, DROPOUT the
// dropout of `c`, WINDOW the window `w`, SOFTCAP the cap of `c`.
template <int D, bool CAUSAL, bool RANGE, bool ALIBI, bool SEG, bool DROPOUT, bool WINDOW,
          bool SOFTCAP>
__device__ __forceinline__ void consume(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                                        const Params& p, const Channels& c, unsigned char* smem,
                                        const Walk& walk, const KeyRange& r, const Window& w,
                                        int b, int hk, int k0, int n_iter) {
  using L = Smem<D>;
  constexpr int kDqCols = D == 64 ? 32 : 64;  // dQ columns of each warpgroup's product
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  const int ct = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, ct / 128, 0);  // warp-uniform to the compiler
  const int tw = ct % 128;
  const int warp = tw / 32;
  const int g = (tw % 32) / 4;
  const int t = tw % 4;
  const int key_lo = k0 + 64 * wg + 16 * warp + g;  // this thread's rows: key_lo, key_lo + 8
  // SEG: this thread's keys' ids and the k-tile's least and largest (the
  // ids are padded to whole tiles).
  int kid_lo = 0, kid_hi = 0;
  int2 k_span{};
  if constexpr (SEG) {
    kid_lo = __ldg(c.k_seg + key_lo);
    kid_hi = __ldg(c.k_seg + key_lo + 8);
    k_span = __ldg(c.k_span + k0 / kKeys);
  }
  // Tiles that cross the key range's limit (or, RANGE, its low key) test
  // it per element; the diagonal is the range's (the bound's with
  // bound_causal).
  const bool ragged = RANGE ? k0 + kKeys > r.lim || k0 < r.low : k0 + kKeys > p.seqlen_k;
  const int diag_off = RANGE ? r.diag : p.causal_offset;
  const float* slopes = reinterpret_cast<const float*>(smem + L::slopes);
  const uint32_t k_addr = sm90::smem_u32(smem + L::k);
  // K and V rows of this warpgroup as K-major A operands; dS and K as the
  // MN-major operands of dQ = dS K (K: this warpgroup's kDqCols columns,
  // from column wg * kDqCols).
  const uint64_t k_desc = desc_sw128(k_addr + 64 * wg * 128, 16, 1024);
  const uint64_t v_desc = desc_sw128(sm90::smem_u32(smem + L::v) + 64 * wg * 128, 16, 1024);
  const uint64_t ds_desc = desc_sw128(sm90::smem_u32(smem + L::ds), kRows * 128, 1024);
  const uint64_t kt_desc =
      desc_sw128(k_addr + (D == 64 ? wg * 64 : wg * kKeys * 128), kKeys * 128, 1024);
  unsigned char* ds_smem = smem + L::ds;
  // DROPOUT: the seed, the keep test, 1 / (1 - p) and this thread's keys'
  // share of the hash's position.
  int drop_seed = 0;
  uint32_t drop_min = 0, drop_key_lo = 0, drop_key_hi = 0;
  float drop_scale = 1.f;
  if constexpr (DROPOUT) {
    drop_seed = __ldg(c.dropout_seed);
    drop_min = c.dropout_min;
    drop_scale = c.dropout_scale;
    drop_key_lo = static_cast<uint32_t>(key_lo) * kDropCol;
    drop_key_hi = static_cast<uint32_t>(key_lo + 8) * kDropCol;
  }
  // WINDOW: key - row must lie in [win_lo, win_hi] (the row's window about
  // pos = row + w.off). SOFTCAP: tanh's exp2 argument per raw score and cap
  // log2(e), as B1's.
  int win_lo = -kNoBound, win_hi = kNoBound;
  if constexpr (WINDOW) {
    if (w.left >= 0) win_lo = w.off - w.left;
    if (w.right >= 0) win_hi = w.off + w.right;
  }
  float cap_k = 0.f, cap_log2 = 0.f;
  if constexpr (SOFTCAP) {
    cap_k = 2.f * p.scale_log2 / c.cap;
    cap_log2 = c.cap * kLog2e;
  }
  float4* dq_smem = reinterpret_cast<float4*>(smem + L::dq);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_iter > 0) sm90::mbar_wait(kv_full, 0);
  size_t prev_block = 0;  // dQ accumulator offset of the last step's block
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % kStages;
    const int bh = walk.bh(it);
    const int row0 = walk.row0(it);
    // Q and dO as K-major B operands (S^T, dP^T) and MN-major B operands
    // (dK, dV: rows of 64 values of D, 64-value atoms kRows * 128 bytes apart).
    const uint32_t q_addr = sm90::smem_u32(smem + L::q + stage * L::kQ);
    const uint32_t do_addr = sm90::smem_u32(smem + L::dout + stage * L::kQ);
    const uint64_t q_desc = desc_sw128(q_addr, 16, 1024);
    const uint64_t do_desc = desc_sw128(do_addr, 16, 1024);
    const uint64_t qt_desc = desc_sw128(q_addr, kRows * 128, 1024);
    const uint64_t dot_desc = desc_sw128(do_addr, kRows * 128, 1024);
    const float* lse2 = reinterpret_cast<const float*>(smem + L::lse2) + stage * kRows;
    const float* delta = reinterpret_cast<const float*>(smem + L::delta) + stage * kRows;
    sm90::mbar_wait(&full[stage], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: [64 keys x 64 rows] each, K-major.
    float s[32], dp[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      sm90::wgmma_ss_n64<0, 0>(s, sm90::desc_add(k_desc, koff), sm90::desc_add(q_desc, qoff),
                               kk > 0);
    }
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      sm90::wgmma_ss_n64<0, 0>(dp, sm90::desc_add(v_desc, koff), sm90::desc_add(do_desc, qoff),
                               kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T from lse2 (masked entries 0) and dS^T = P^T (dP^T - delta) scale,
    // each rounded to bf16 as the A operand of its product, 16 rows of the
    // walk at a time.
    const bool diag = CAUSAL && k0 + 64 * wg + 16 * warp + 15 > row0 + diag_off;
    // ALiBi: this step's q-head's slope (log2 units).
    const float slope_log2 = ALIBI ? slopes[it / walk.nq] : 0.f;
    // SEG: the step's rows and the k-tile's keys are not all of one segment.
    const bool seg_test = SEG && !one_segment(k_span, __ldg(c.q_span + row0 / kRows));
    // WINDOW: the step's 64 rows and this warp's 16 keys are not all inside
    // each other's windows (key - row spans [k - row0 - 63, k + 15 - row0]
    // from the warp's first key k).
    const int kw0 = k0 + 64 * wg + 16 * warp;
    const bool win_test = WINDOW && (kw0 - row0 - (kRows - 1) < win_lo || kw0 + 15 - row0 > win_hi);
    // DROPOUT: the step's (seed, bh) term and its rows' share of the position.
    uint32_t drop_key = 0, drop_row = 0;
    if constexpr (DROPOUT) {
      drop_key = dropout_key(drop_seed, bh);
      drop_row = static_cast<uint32_t>(row0 + 2 * t) * kDropRow;
    }
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int e = 8 * k; e < 8 * k + 8; ++e) {
        const int qc = 8 * (e / 4) + 2 * t + (e & 1);
        const int key = key_lo + 8 * ((e >> 1) & 1);
        // Off the ragged tile and the tiles that cross the diagonal, that
        // channel's bound moves out of reach: one branch-free test on every
        // tile (on an H100 faster than testing the tile flags per element).
        // Off the ragged tile and the tiles that cross the diagonal, that
        // channel's bound moves out of reach: one branch-free test on every
        // tile (on an H100 faster than testing the tile flags per element).
        bool masked;
        if constexpr (SEG && WINDOW) {
          const int row = row0 + qc;
          masked = key_masked<CAUSAL>(key, row, ragged ? p.seqlen_k : kNoBound,
                                      diag ? p.causal_offset : kNoBound, 0,
                                      seg_test ? __ldg(c.q_seg + row) : 0,
                                      seg_test ? ((e >> 1) & 1 ? kid_hi : kid_lo) : 0,
                                      win_test ? make_int2(row + win_lo, row + win_hi + 1)
                                               : make_int2(-kNoBound, kNoBound));
        } else if constexpr (WINDOW) {
          const int row = row0 + qc;
          masked = key_masked<CAUSAL>(key, row, ragged ? r.lim : kNoBound,
                                      diag ? diag_off : kNoBound, ragged ? r.low : 0,
                                      win_test ? make_int2(row + win_lo, row + win_hi + 1)
                                               : make_int2(-kNoBound, kNoBound));
        } else if constexpr (RANGE) {
          masked = key_masked<CAUSAL>(key, row0 + qc, ragged ? r.lim : kNoBound,
                                      diag ? diag_off : kNoBound, ragged ? r.low : 0);
        } else if constexpr (SEG) {
          masked = key_masked<CAUSAL>(key, row0 + qc, ragged ? p.seqlen_k : kNoBound,
                                      diag ? p.causal_offset : kNoBound, 0,
                                      seg_test ? __ldg(c.q_seg + row0 + qc) : 0,
                                      seg_test ? ((e >> 1) & 1 ? kid_hi : kid_lo) : 0);
        } else {
          masked = key_masked<CAUSAL>(key, row0 + qc, ragged ? p.seqlen_k : kNoBound,
                                      diag ? p.causal_offset : kNoBound);
        }
        // SOFTCAP: the cap's derivative 1 - tanh^2, taken before the mask
        // as JAX takes it, times the scale.
        float ds_scale = p.scale;
        if constexpr (ALIBI) {
          // B1's bias: JAX's distance, less the range's least one.
          const int dist = abs(row0 + qc + p.causal_offset - key) - r.shift;
          s[e] = masked ? 0.f
                        : ex2(fmaf(s[e], p.scale_log2, -slope_log2 * static_cast<float>(dist)) -
                              lse2[qc]);
        } else if constexpr (SOFTCAP) {
          const float tc = softcap_tanh(s[e] * cap_k);
          s[e] = masked ? 0.f : ex2(fmaf(cap_log2, tc, -lse2[qc]));
          ds_scale = p.scale * fmaf(-tc, tc, 1.f);
        } else {
          s[e] = masked ? 0.f : ex2(s[e] * p.scale_log2 - lse2[qc]);
        }
        if constexpr (DROPOUT) {
          // JAX's order: dP and P each dropped and scaled by 1 / (1 - p);
          // dS from the dropped dP and the undropped P.
          const uint32_t pos = drop_row + static_cast<uint32_t>(8 * (e / 4) + (e & 1)) * kDropRow +
                               ((e >> 1) & 1 ? drop_key_hi : drop_key_lo);
          const bool keep = dropout_keep(pos, drop_key, drop_min);
          const float dpd = keep ? dp[e] * drop_scale : 0.f;
          dp[e] = s[e] * (dpd - delta[qc]) * p.scale;
          s[e] = keep ? s[e] * drop_scale : 0.f;
        } else {
          dp[e] = s[e] * (dp[e] - delta[qc]) * ds_scale;
        }
      }
      sm90::frag_a(pf[k], s, k);
      sm90::frag_a(dsf[k], dp, k);
    }

    // dV += P^T dO.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_rs<D, 1>(dv, pf[kk], sm90::desc_add(dot_desc, kk * 2048), 1);
    }
    sm90::wgmma_commit();

    // Both warpgroups are past the last step (dS free, its ring stage read)
    // and have written its dQ_part: add that to the accumulator, and load
    // step it + kStages - 1 into the last step's stage.
    sm90::named_sync(1, kConsumers);
    if (ct == 0) {
      if (it > 0) {
        sm90::bulk_reduce_add_f32(p.dq_accum + prev_block,
                                  reinterpret_cast<const float*>(dq_smem), kRows * D * 4);
        sm90::bulk_commit();
      }
      const int next = it + kStages - 1;
      if (next < n_iter) {
        load_step<D>(tm_q, tm_do, p, smem, next % kStages, walk.bh(next), walk.row0(next));
      }
    }
    // dS^T into shared memory, [key][row], 128-byte swizzle (the MN-major
    // A operand of dQ = dS K).
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 64 * wg + 16 * warp + g + 8 * (e & 1);
        const int row = 16 * k + 2 * t + 8 * (e >> 1);
        const int off = key * 128 + (((row >> 3) ^ (key & 7)) << 4) + (row & 7) * 2;
        *reinterpret_cast<uint32_t*>(ds_smem + off) = dsf[k][e];
      }
    }
    sm90::fence_proxy_async();

    // dK += dS^T Q.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_rs<D, 1>(dk, dsf[kk], sm90::desc_add(qt_desc, kk * 2048), 1);
    }
    sm90::wgmma_commit();
    if (ct == 0) sm90::bulk_wait_read();  // the dQ buffer is free again
    sm90::named_sync(2, kConsumers);      // dS^T complete

    // dQ_part = dS K over the 128 keys: this warpgroup's kDqCols columns.
    float dq[kDqCols / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t da = sm90::desc_add(ds_desc, kk * 2048);
      const uint64_t db = sm90::desc_add(kt_desc, kk * 2048);
      if constexpr (D == 64) {
        sm90::wgmma_ss_n32<1, 1>(dq, da, db, kk > 0);
      } else {
        sm90::wgmma_ss_n64<1, 1>(dq, da, db, kk > 0);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(pf);
    sm90::fence_regs(dsf);

    // dQ_part into shared memory in thread order: float4 j of thread tw of
    // warpgroup wg, columns 8 c .. 8 c + 7 (c = wg * kDqCols / 8 + j), at c *
    // 128 + tw (bwd_post_kernel reads it back in that order); at D 80 and 96
    // warpgroup 1 stores only its columns below D.
#pragma unroll
    for (int j = 0; j < kDqCols / 8; ++j) {
      const int c = wg * (kDqCols / 8) + j;
      if (2 * kDqCols == D || c < D / 8) {
        dq_smem[c * 128 + tw] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      }
    }
    sm90::fence_proxy_async();
    prev_block = (static_cast<size_t>(bh) * p.seqlen_q_pad + row0) * D;
  }
  sm90::named_sync(1, kConsumers);
  if (ct == 0 && n_iter > 0) {
    sm90::bulk_reduce_add_f32(p.dq_accum + prev_block, reinterpret_cast<const float*>(dq_smem),
                              kRows * D * 4);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }

  // dK, dV (the group's sum) as bf16.
  const size_t kvh = static_cast<size_t>(b) * p.kv_heads + hk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= p.seqlen_k) continue;
    __nv_bfloat16* dk_row = p.dk + (kvh * p.seqlen_k + key) * D;
    __nv_bfloat16* dv_row = p.dv + (kvh * p.seqlen_k + key) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_row + col) =
          sm90::pack_bf16x2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + col) =
          sm90::pack_bf16x2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// One CTA of the main kernel (flash_bwd_kernel; with SEG
// flash_bwd_segments_kernel, with DROPOUT flash_bwd_dropout_kernel, with
// WINDOW or SOFTCAP flash_bwd_window_kernel, with SEG and any of them
// flash_bwd_segments_channels_kernel).
template <int D, bool CAUSAL, bool RANGE, bool ALIBI, bool SEG, bool DROPOUT = false,
          bool WINDOW = false, bool SOFTCAP = false>
__device__ __forceinline__ void bwd_cta(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                        const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                        const Params& p, const Channels& c) {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128, "head dim must be 64, 80, 96 or 128");
  static_assert(RANGE || !ALIBI, "ALiBi runs in the RANGE instantiations");
  static_assert(!SEG || !RANGE, "segments without the key range");
  static_assert(!DROPOUT || ((RANGE || SEG) && !ALIBI && (D == 64 || D == 128)),
                "dropout runs in the RANGE and segment instantiations at D 64 and 128");
  static_assert(!(WINDOW || SOFTCAP) ||
                    ((RANGE || SEG) && !ALIBI && !DROPOUT && (D == 64 || D == 128)),
                "window and softcap run in the RANGE and segment instantiations at D 64 and 128");
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;

  // CTA -> (k-tile, b, kv-head), k-tile slowest: the first k-tiles have the
  // longest causal walks and start first.
  const int bhk = p.batch * p.kv_heads;
  const int kt = blockIdx.x / bhk;
  const int b = (blockIdx.x % bhk) / p.kv_heads;
  const int hk = blockIdx.x % p.kv_heads;
  const int k0 = kt * kKeys;
  const int qtiles = p.seqlen_q_pad / kRows;
  const int group = p.heads / p.kv_heads;
  const KeyRange range =
      RANGE ? key_range(c, b, p.seqlen_q, p.seqlen_k, p.causal_offset)
            : KeyRange{0, p.seqlen_k, p.causal_offset, 0};
  int q_first = 0;
  if constexpr (CAUSAL) {
    // First q-tile whose last row reaches the k-tile's first key.
    const int x = k0 - (RANGE ? range.diag : p.causal_offset);
    q_first = x < 0 ? 0 : min(qtiles, x / kRows);
  }
  int nq = qtiles - q_first;
  if constexpr (SEG) {  // the q rows whose segments meet the k-tile's keys
    const int2 rows = segment_range(c, kt);
    q_first = max(q_first, rows.x / kRows);
    nq = max(min(qtiles, (rows.y + kRows - 1) / kRows) - q_first, 0);
  }
  // WINDOW: only the q rows whose window reaches the k-tile, row + off +
  // right >= k0 and row + off - left < k0 + kKeys (each end of a row's
  // window is nondecreasing in the row): B1's window_range, mirrored. The
  // narrowing is walk_rows's, written out.
  Window wnd{};
  if constexpr (WINDOW) {
    wnd = window_of(c, b, p.seqlen_q, p.seqlen_k);
    int q_end = SEG ? q_first + nq : qtiles;  // inside the segments' rows
    if (wnd.right >= 0) {
      q_first = max(q_first, min(qtiles, max(k0 - wnd.right - wnd.off, 0) / kRows));
    }
    if (wnd.left >= 0) {
      const int rows_end = k0 + kKeys + wnd.left - wnd.off;
      q_end = rows_end <= 0 ? 0 : min(q_end, (rows_end + kRows - 1) / kRows);
    }
    nq = max(q_end - q_first, 0);
  }
  // A k-tile wholly past the range's limit or below its low key sees no q
  // row: no walk (its dK and dV rows are stored as zeros).
  if (RANGE && (k0 >= range.lim || k0 + kKeys <= range.low)) nq = 0;
  const int ktiles = (p.seqlen_k + kKeys - 1) / kKeys;
  const Walk walk{(b * p.heads + hk * group), q_first, nq, CAUSAL ? 0 : kt * nq / ktiles};
  const int n_iter = group * nq;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  if constexpr (ALIBI) {
    float* slopes = reinterpret_cast<float*>(smem + L::slopes);
    for (int i = threadIdx.x; i < group; i += kThreads) {
      slopes[i] = __ldg(c.alibi + walk.bh0 + i) * kLog2e;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_iter > 0) {
    load_kv<D>(tm_k, tm_v, smem, k0, b * p.kv_heads + hk);
    for (int it = 0; it < kStages - 1 && it < n_iter; ++it) {
      load_step<D>(tm_q, tm_do, p, smem, it, walk.bh(it), walk.row0(it));
    }
  }
  consume<D, CAUSAL, RANGE, ALIBI, SEG, DROPOUT, WINDOW, SOFTCAP>(tm_q, tm_do, p, c, smem, walk,
                                                                 range, wnd, b, hk, k0, n_iter);
}

template <int D, bool CAUSAL, bool RANGE = false, bool ALIBI = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const Params p,
                     const Channels c) {
  bwd_cta<D, CAUSAL, RANGE, ALIBI, false>(tm_q, tm_k, tm_v, tm_do, p, c);
}

// The RANGE walk with attention dropout (instantiated in
// flash_bwd_dropout.cu).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dropout_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do, const Params p,
                             const Channels c) {
  bwd_cta<D, CAUSAL, true, false, false, true>(tm_q, tm_k, tm_v, tm_do, p, c);
}

// The RANGE walk with the window and / or softcap channels (instantiated in
// flash_bwd_window.cu).
template <int D, bool CAUSAL, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_window_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do, const Params p,
                            const Channels c) {
  bwd_cta<D, CAUSAL, true, false, false, false, WINDOW, SOFTCAP>(tm_q, tm_k, tm_v, tm_do, p, c);
}

// The segment walk with dropout, or the window and / or softcap channels
// (instantiated in flash_bwd_segments_channels.cu).
template <int D, bool CAUSAL, bool DROPOUT, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_segments_channels_kernel(const __grid_constant__ CUtensorMap tm_q,
                                       const __grid_constant__ CUtensorMap tm_k,
                                       const __grid_constant__ CUtensorMap tm_v,
                                       const __grid_constant__ CUtensorMap tm_do, const Params p,
                                       const Channels c) {
  bwd_cta<D, CAUSAL, false, false, true, DROPOUT, WINDOW, SOFTCAP>(tm_q, tm_k, tm_v, tm_do, p, c);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_segments_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do, const Params p,
                              const Channels c) {
  bwd_cta<D, CAUSAL, false, false, true>(tm_q, tm_k, tm_v, tm_do, p, c);
}

// ----------------------------------------------------------- (c) post

// One CTA per (64-row block, b * H + h): the accumulator's thread order
// back to rows through shared memory, then rows of bf16 in 16-byte stores;
// at D 256 in two passes of 128 columns (the whole tile would take 66 KB of
// static shared memory).
template <int D>
__global__ void bwd_post_kernel(const float* __restrict__ dq_accum, __nv_bfloat16* __restrict__ dq,
                                int seqlen_q, int seqlen_q_pad) {
  constexpr int kCols = D > 128 ? 128 : D;  // columns a pass
  constexpr int kPitch = kCols + 4;         // floats per row of the tile
  __shared__ float tile[kRows * kPitch];
  const int blk = blockIdx.x;
  const size_t bh = blockIdx.y;
  const float4* src =
      reinterpret_cast<const float4*>(dq_accum + (bh * seqlen_q_pad + blk * kRows) * D);
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += kCols) {
    for (int f = threadIdx.x; f < kRows * kCols / 4; f += blockDim.x) {
      const int tw = f % 128;  // float4 f: columns c0 + 8 (f / 128) .., thread tw's rows
      const float4 x = src[c0 / 8 * 128 + f];
      const int row = 16 * (tw / 32) + (tw % 32) / 4;
      const int col = 8 * (f / 128) + 2 * (tw % 4);
      *reinterpret_cast<float2*>(tile + row * kPitch + col) = make_float2(x.x, x.y);
      *reinterpret_cast<float2*>(tile + (row + 8) * kPitch + col) = make_float2(x.z, x.w);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kRows * kCols / 8; c += blockDim.x) {
      const int row = c / (kCols / 8);
      const int col = (c % (kCols / 8)) * 8;
      if (blk * kRows + row >= seqlen_q) continue;
      const float* x = tile + row * kPitch + col;
      uint4 out;
      out.x = sm90::pack_bf16x2(x[0], x[1]);
      out.y = sm90::pack_bf16x2(x[2], x[3]);
      out.z = sm90::pack_bf16x2(x[4], x[5]);
      out.w = sm90::pack_bf16x2(x[6], x[7]);
      *reinterpret_cast<uint4*>(dq + (bh * seqlen_q + blk * kRows + row) * D + c0 + col) = out;
    }
    if (c0 + kCols < D) __syncthreads();  // the tile is read before the next pass writes it
  }
}

// ------------------------------------------------------------------ host

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *dq_accum, *lse2, *delta;
  int batch, heads, kv_heads, seqlen_q, seqlen_k;
  float scale;
};

// The main kernel of an instantiation (only that one is compiled).
template <int D, bool CAUSAL, bool RANGE, bool ALIBI, bool SEG, bool DROPOUT, bool WINDOW,
          bool SOFTCAP>
auto main_kernel() {
  if constexpr (SEG && (DROPOUT || WINDOW || SOFTCAP)) {
    return flash_bwd_segments_channels_kernel<D, CAUSAL, DROPOUT, WINDOW, SOFTCAP>;
  } else if constexpr (SEG) {
    return flash_bwd_segments_kernel<D, CAUSAL>;
  } else if constexpr (DROPOUT) {
    return flash_bwd_dropout_kernel<D, CAUSAL>;
  } else if constexpr (WINDOW || SOFTCAP) {
    return flash_bwd_window_kernel<D, CAUSAL, WINDOW, SOFTCAP>;
  } else {
    return flash_bwd_kernel<D, CAUSAL, RANGE, ALIBI>;
  }
}

template <int D, bool CAUSAL, bool RANGE = false, bool ALIBI = false, bool SEG = false,
          bool DROPOUT = false, bool WINDOW = false, bool SOFTCAP = false>
cudaError_t run(const Args& a, cudaStream_t stream, const Channels& c = Channels{}) {
  const int sq_pad = (a.seqlen_q + kRows - 1) / kRows * kRows;
  const int rows = a.batch * a.heads * sq_pad;
  constexpr int kPreThreads = 256;
  const long long pre_threads = static_cast<long long>(rows) * pre_lanes(D);
  const int pre_blocks = static_cast<int>((pre_threads + kPreThreads - 1) / kPreThreads);
  const LseShift sh{c.alibi, c.kv_bound, a.heads, a.seqlen_k};
  auto pre = ALIBI && c.bound_causal ? bwd_pre_kernel<D, true> : bwd_pre_kernel<D, false>;
  pre<<<pre_blocks, kPreThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.lse2),
      static_cast<float*>(a.delta), static_cast<float*>(a.dq_accum), a.seqlen_q, sq_pad, rows,
      sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int bh = a.batch * a.heads, bhk = a.batch * a.kv_heads;
  if ((err = sm90::make_tensor_map_3d(&tm_q, a.q, D, a.seqlen_q, bh, 64, kRows)) ||
      (err = sm90::make_tensor_map_3d(&tm_do, a.dout, D, a.seqlen_q, bh, 64, kRows)) ||
      (err = sm90::make_tensor_map_3d(&tm_k, a.k, D, a.seqlen_k, bhk, 64, kKeys)) ||
      (err = sm90::make_tensor_map_3d(&tm_v, a.v, D, a.seqlen_k, bhk, 64, kKeys))) {
    return err;
  }
  Params p{};
  p.dq_accum = static_cast<float*>(a.dq_accum);
  p.lse2 = static_cast<const float*>(a.lse2);
  p.delta = static_cast<const float*>(a.delta);
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.batch = a.batch;
  p.heads = a.heads;
  p.kv_heads = a.kv_heads;
  p.seqlen_q = a.seqlen_q;
  p.seqlen_k = a.seqlen_k;
  p.seqlen_q_pad = sq_pad;
  p.causal_offset = a.seqlen_k - a.seqlen_q;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  auto kernel = main_kernel<D, CAUSAL, RANGE, ALIBI, SEG, DROPOUT, WINDOW, SOFTCAP>();
  // + alignment of the base
  constexpr int smem = (ALIBI ? Smem<D>::bytes_alibi : Smem<D>::bytes) + 1024;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ktiles = (a.seqlen_k + kKeys - 1) / kKeys;
  kernel<<<ktiles * bhk, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_post_kernel<D><<<dim3(sq_pad / kRows, bh), 256, 0, stream>>>(
      static_cast<const float*>(a.dq_accum), static_cast<__nv_bfloat16*>(a.dq), a.seqlen_q,
      sq_pad);
  return cudaGetLastError();
}

// The RANGE instantiation at D, with or without the ALiBi bias.
template <int D, bool CAUSAL>
cudaError_t run_masked(const Args& a, const Channels& c, cudaStream_t stream) {
  if (c.alibi != nullptr) return run<D, CAUSAL, true, true>(a, stream, c);
  return run<D, CAUSAL, true, false>(a, stream, c);
}

// Head dims 80 and 96, defined in flash_bwd_hd.cu (whose nvcc runs beside
// this file's): the channel-free backward (CAUSAL when `causal`), and the
// RANGE / ALIBI instantiations (CAUSAL when `diag`). The segment
// instantiations and their entry are in flash_bwd_segments.cu.
cudaError_t run_hd(int head_dim, bool causal, const Args& a, cudaStream_t stream);
cudaError_t run_masked_hd(int head_dim, bool diag, const Args& a, const Channels& c,
                          cudaStream_t stream);

// Head dim 256 (CAUSAL when `causal` / `diag`): the 64-key kernel of
// flash_bwd_d256.cu, whose nvcc runs beside this file's, channel-free and
// with B1's key range (not ALiBi); its window / softcap instantiations
// (flash_bwd_d256_window.cu), and its segment walk alone or with the window /
// softcap (flash_bwd_d256_segments.cu; not dropout), each its own nvcc.
cudaError_t run_d256(bool causal, const Args& a, cudaStream_t stream);
cudaError_t run_masked_d256(bool diag, const Args& a, const Channels& c, cudaStream_t stream);
cudaError_t run_window_d256(bool diag, const Args& a, const Channels& c, bool window,
                            cudaStream_t stream);
cudaError_t run_segments_d256(bool causal, const Args& a, const Channels& c,
                              cudaStream_t stream);
cudaError_t run_segment_channels_d256(bool causal, const Args& a, const Channels& c, bool window,
                                      cudaStream_t stream);

}  // namespace bwd
}  // namespace lite

// flash_bwd_hd.cu includes the templates above and none of the entries below.
#ifndef LITE_BWD_TEMPLATES_ONLY

// dq, dk, dv from q, k, v, o, dout, lse (natural log); dq_accum
// [B, H, Sq_pad, D] fp32 and lse2 / delta [B, H, Sq_pad] fp32 are scratch,
// Sq_pad = Sq rounded up to 64. Three launches on `stream`.
extern "C" int lite_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dq, void* dk, void* dv,
                              void* dq_accum, void* lse2, void* delta, int batch, int heads,
                              int kv_heads, int seqlen_q, int seqlen_k, int head_dim,
                              float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const lite::bwd::Args a{q, k, v, o, dout, lse, dq, dk, dv, dq_accum, lse2, delta,
                          batch, heads, kv_heads, seqlen_q, seqlen_k, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lite::bwd;
  if (head_dim == 64) {
    err = causal ? run<64, true>(a, s) : run<64, false>(a, s);
  } else if (head_dim == 128) {
    err = causal ? run<128, true>(a, s) : run<128, false>(a, s);
  } else if (head_dim == 80 || head_dim == 96) {
    err = run_hd(head_dim, causal != 0, a, s);
  } else if (head_dim == 256) {
    err = run_d256(causal != 0, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B7 with B1's per-batch channels: as lite_flash_bwd, plus kv_bound and
// kv_low [B] int32 or null and alibi [B, H] fp32 slopes or null (at most
// 256 q-heads per kv-head with ALiBi; none at head dim 256). Keys of batch b: [kv_low[b],
// min(Sk, kv_bound[b])); causal bottom-right at Sk - Sq; bound_causal (with
// kv_bound) bottom-right at kv_bound[b] - Sq. lse is the forward's (B1's
// with the same channels).
extern "C" int lite_flash_bwd_masked(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* dq, void* dk,
                                     void* dv, void* dq_accum, void* lse2, void* delta,
                                     const void* kv_bound, const void* kv_low, const void* alibi,
                                     int batch, int heads, int kv_heads, int seqlen_q,
                                     int seqlen_k, int head_dim, float scale, int causal,
                                     int bound_causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using namespace lite::bwd;
  if (alibi != nullptr && heads / kv_heads > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, dq_accum, lse2, delta,
               batch, heads, kv_heads, seqlen_q, seqlen_k, scale};
  lite::Channels c{};
  c.kv_bound = static_cast<const int*>(kv_bound);
  c.kv_low = static_cast<const int*>(kv_low);
  c.alibi = static_cast<const float*>(alibi);
  c.bound_causal = bound_causal != 0 && kv_bound != nullptr;
  const bool diag = causal != 0 || c.bound_causal;  // the CAUSAL instantiation
  c.bound_only = diag && causal == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = diag ? run_masked<64, true>(a, c, s) : run_masked<64, false>(a, c, s);
  } else if (head_dim == 128) {
    err = diag ? run_masked<128, true>(a, c, s) : run_masked<128, false>(a, c, s);
  } else if (head_dim == 80 || head_dim == 96) {
    err = run_masked_hd(head_dim, diag, a, c, s);
  } else if (head_dim == 256) {
    err = run_masked_d256(diag, a, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#endif  // LITE_BWD_TEMPLATES_ONLY
