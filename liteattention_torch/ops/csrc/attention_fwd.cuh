// Shared forward mainloop of the coarse lite attention kernel (B4), and the
// online-softmax row steps that B1, B3 and B5 (flash_fwd.cu), the decode
// kernels and the MLA kernels share with it.
//
// One CTA owns one 128-row q-tile of one (batch, head): 8 warps, 16 q rows
// each. K and V are walked in 128-key tiles through a two-stage cp.async
// ring in shared memory; QK^T and PV run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate). Scores live in log2 space (s * scale * log2e) so the online
// softmax uses exp2; the lse written out is natural log.
//
// The walk over k-tiles is the template parameter MODE. A walk visits
// positions (e, s): entry e of the CTA's schedule row, fine k-tile s of it.
//   kCoarse: kv_idx[0..count) of the coarse row (block_q = 128 * qsub rows,
//            block_k = 128 * ksub keys) that holds this fine q-tile; entry e
//            is the ksub fine k-tiles of coarse tile kv_idx[e] (B4).
//   kSuper:  as kCoarse, but fine k-tile s of entry e is visited only if bit
//            (qs * ksub + s) of bits[e] is set, qs the place of this q-tile in
//            its coarse row (B4's super-tile mode).
// (The fine gather walk, B3 and with folded heads B5, runs on B1's
// wgmma/TMA mainloop in flash_fwd.cu.)
// A row with no valid key keeps its running max at -inf and ends with out 0,
// lse -inf.
//
// VOTES. A vote step is one entry (the gather walk's `gsize` entries: see
// flash_fwd.cu); m_prev is the running row max from before the step, and a
// fine tile passes for a valid q row iff (max_col s - m_prev) > thr, strict.
//   gather (B3/B5, flash_fwd.cu): each visited tile votes "do" (0) iff some row
//            passes, else "skip" (1), into the fine [B, H, Qt, Kt] array; the
//            first entry always votes 0.
//   kCoarse: the coarse tile votes 0 iff some row of its 128 * qsub rows
//            passes on some of its fine tiles, AND-ed over the qsub CTAs of
//            the coarse row with atomicAnd into votes pre-filled with 1 (exact:
//            the fine tiles of one step share m_prev); the first entry votes 0.
//   kSuper:  each visited fine tile votes into the fine [B, H, Qt_c * qsub,
//            Kt_c * ksub] array; in the first entry, the lowest live fine tile
//            of this q-tile votes 0.
// The coarse walks test the JAX kernel's values exactly: it masks dead
// columns with the finite kMaskValue, not -inf, so its running max is
// max(m, kMaskValue) once an entry was visited and a fully masked fine tile's
// max is kMaskValue. The vote clamps both to kMaskValue the same way (the
// softmax itself keeps -inf: the outputs do not depend on the sentinel).
//
// Keys past Sk are masked by key_mask.cuh's test, the one B1 and B7 use.
//
// What bounds it on the H100: at 128x128 tiles each K/V byte loaded feeds
// 128 q rows, so the kernel is bound by tensor-core issue, and mma.sync
// reaches well under the wgmma rate. This first version keeps the design
// simple (no TMA, no warp specialization, no wgmma); skipped tiles cost no
// load and no math, which is what turns sparsity into time. The coarse walks
// move onto B1's wgmma/TMA mainloop next, as the gather walk did (ROADMAP
// B-ii R1c).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "key_mask.cuh"

namespace lite {

constexpr int kBlockQ = 128;  // q rows per CTA = one fine q-tile
constexpr int kBlockK = 128;  // keys per k-tile = one fine k-tile
constexpr int kWarps = 8;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;
// The JAX kernels' finite mask value, -0.7 * FLT_MAX rounded to fp32.
constexpr float kMaskValue = -0x1.666664p+127f;

enum Mode { kCoarse = 2, kSuper = 3 };

struct FwdParams {
  const __nv_bfloat16* q;  // [B, H, Sq, D]
  const __nv_bfloat16* k;  // [B, Hk, Sk, D]
  const __nv_bfloat16* v;  // [B, Hk, Sk, D]
  __nv_bfloat16* out;      // [B, H, Sq, D]
  float* lse;              // [B, H, Sq]
  const int* fidx;         // schedule entries [B, H, sched_q, sched_k]
  const int* count;        // entries per schedule row [B, H, sched_q]
  const int* bits;         // kSuper: sub-tile liveness aligned with fidx
  int* votes;              // [B, H, vote_q, vote_k]
  int heads, kv_heads, seqlen_q, seqlen_k;
  int qtiles, ktiles;      // fine 128-row / 128-key tiles
  int sched_q, sched_k;    // schedule grid per (b, h)
  int qsub, ksub;          // fine tiles per schedule tile
  int vote_q, vote_k;      // vote grid per (b, h)
  float scale_log2;        // softmax scale * log2(e)
  float thr;               // vote threshold, log2 space
};

template <int D>
constexpr int smem_bytes() {
  // Two stages of (K tile, V tile), rows padded by 8 elements so the
  // fragment loads of 8 consecutive rows hit 8 distinct bank groups.
  return 2 * 2 * kBlockK * (D + 8) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i, and lane l receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each: the A fragment of m16n8k16 from a row-major tile,
// or two B fragments from the rows of K.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int bytes = pred ? 16 : 0;  // 0 source bytes = zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row steps of the online softmax, shared by the forward mainloop below, the
// decode kernel (flash_decode.cu) and the MLA kernels (mla_decode.cu,
// flash_fwd.cu). A warp owns 16 q rows of an m16n8k16 tile: lane (g, t) =
// (lane / 4, lane % 4) holds accumulator elements 0-1 of row g ("lo") and
// 2-3 of row g + 8 ("hi"), at columns 8 i + 2 t (+1) of block i. Scores s
// are NB blocks of 8 keys; m is the running row max (log2 space), l this
// thread's partial row sum.

// Scale raw scores to log2 space and, with `mask`, set every column that
// `hidden(col, hi)` hides (key col = col0 + 8 nb + 2 t + (e & 1) of the lo
// row, or with hi of the hi row) to -inf; returns the rows' maxima over the
// tile in mx_lo / mx_hi (quad-reduced). The unmasked tile takes its own loop
// with no per-element test: left to the compiler, the one masked loop cost
// B1 2 % and B3 4-7 % on an H100.
template <int NB, typename Hidden>
__device__ __forceinline__ void mask_scores(float (&s)[NB][4], float scale_log2, bool mask,
                                            int col0, Hidden&& hidden, float& mx_lo,
                                            float& mx_hi) {
  const int t = threadIdx.x % 4;
  mx_lo = -INFINITY;
  mx_hi = -INFINITY;
  if (!mask) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale_log2;
      mx_lo = fmaxf(mx_lo, fmaxf(s[nb][0], s[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nb][2], s[nb][3]));
    }
  } else {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + nb * 8 + 2 * t + (e & 1);
        s[nb][e] = hidden(col, e >= 2) ? -INFINITY : s[nb][e] * scale_log2;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nb][0], s[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nb][2], s[nb][3]));
    }
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
}

// The same with a key limit per row (key col hidden iff col >= lim): the
// decode kernels' per-request bounds.
template <int NB>
__device__ __forceinline__ void mask_scores(float (&s)[NB][4], float scale_log2, bool mask,
                                            int col0, int lim_lo, int lim_hi, float& mx_lo,
                                            float& mx_hi) {
  mask_scores(s, scale_log2, mask, col0,
              [&](int col, bool hi) { return col >= (hi ? lim_hi : lim_lo); }, mx_lo, mx_hi);
}

// Fold a tile's log2-space scores (row maxima mx_lo / mx_hi) into the running
// state: s becomes the tile's probabilities relative to the new max and l
// absorbs their sums; alpha_lo / alpha_hi are the factors that rescale the
// accumulator (rescale_rows). With `scale`, s and the maxima are raw scores
// that reach log2 space here, in each exp2's own FFMA: B1 and B3-B5 leave
// mask_scores' scale at 1 and pass theirs here, which saves an instruction a
// score and keeps their probabilities bit for bit alike (a dense and a lite
// forward over the same keys agree exactly). A row whose max is still -inf
// keeps base 0, so it never produces NaN.
template <int NB>
__device__ __forceinline__ void softmax_rows(float (&s)[NB][4], float mx_lo, float mx_hi,
                                             float& m_lo, float& m_hi, float& l_lo, float& l_hi,
                                             float& alpha_lo, float& alpha_hi,
                                             float scale = 1.f) {
  const float mn_lo = fmaxf(m_lo, mx_lo * scale);
  const float mn_hi = fmaxf(m_hi, mx_hi * scale);
  const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
  const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
  alpha_lo = fast_exp2(m_lo - base_lo);
  alpha_hi = fast_exp2(m_hi - base_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    s[nb][0] = fast_exp2(fmaf(s[nb][0], scale, -base_lo));
    s[nb][1] = fast_exp2(fmaf(s[nb][1], scale, -base_lo));
    s[nb][2] = fast_exp2(fmaf(s[nb][2], scale, -base_hi));
    s[nb][3] = fast_exp2(fmaf(s[nb][3], scale, -base_hi));
    sum_lo += s[nb][0] + s[nb][1];
    sum_hi += s[nb][2] + s[nb][3];
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
}

template <int NACC>
__device__ __forceinline__ void rescale_rows(float (&acc)[NACC][4], float alpha_lo,
                                             float alpha_hi) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc[i][0] *= alpha_lo;
    acc[i][1] *= alpha_lo;
    acc[i][2] *= alpha_hi;
    acc[i][3] *= alpha_hi;
  }
}

// softmax_rows, then the accumulator rescaled at once.
template <int NB, int NACC>
__device__ __forceinline__ void softmax_update(float (&s)[NB][4], float (&acc)[NACC][4],
                                               float mx_lo, float mx_hi, float& m_lo,
                                               float& m_hi, float& l_lo, float& l_hi) {
  float alpha_lo, alpha_hi;
  softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi);
  rescale_rows(acc, alpha_lo, alpha_hi);
}

// P of keys 16 kc .. 16 kc + 15 as the A operand of m16n8k16: the
// accumulator layout of two 8-key blocks is the A fragment layout.
template <int NB>
__device__ __forceinline__ void p_operand(const float (&s)[NB][4], int kc, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// O += P V over the tile's 8 NB keys and 8 NACC output columns: vs points at
// the tile's first key row and first output column in shared memory (pitch
// elements per key row); V^T's B fragments come by ldmatrix.trans.
template <int NB, int NACC>
__device__ __forceinline__ void pv_product(float (&acc)[NACC][4], const float (&s)[NB][4],
                                           const __nv_bfloat16* vs, int pitch) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* vp =
      vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < NB / 2; ++kc) {
    uint32_t a[4];
    p_operand(s, kc, a);
#pragma unroll
    for (int db = 0; db < NACC / 2; ++db) {
      uint32_t bfrag[4];
      ldmatrix_x4_trans(bfrag, vp + kc * 16 * pitch + db * 16);
      mma_bf16(acc[2 * db], a, bfrag[0], bfrag[1]);
      mma_bf16(acc[2 * db + 1], a, bfrag[2], bfrag[3]);
    }
  }
}

// End of a walk: the rows' full sums (quad-reduced), 1 / l and the
// natural-log lse; a row with no valid key gets 0 and -inf.
__device__ __forceinline__ void finish_rows(float m_lo, float m_hi, float l_lo, float l_hi,
                                            float& inv_lo, float& inv_hi, float& lse_lo,
                                            float& lse_hi) {
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const bool empty_lo = !(l_lo > 0.f) || m_lo == -INFINITY;
  const bool empty_hi = !(l_hi > 0.f) || m_hi == -INFINITY;
  inv_lo = empty_lo ? 0.f : 1.f / l_lo;
  inv_hi = empty_hi ? 0.f : 1.f / l_hi;
  lse_lo = empty_lo ? -INFINITY : m_lo * kLn2 + logf(l_lo);
  lse_hi = empty_hi ? -INFINITY : m_hi * kLn2 + logf(l_hi);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// Write the 16 x 8 NACC accumulator block, scaled by inv, to the rows at
// o_lo / o_hi (their first column; bf16 or fp32).
template <int NACC, typename T>
__device__ __forceinline__ void store_rows(T* o_lo, T* o_hi, const float (&acc)[NACC][4],
                                           float inv_lo, float inv_hi, bool lo_valid,
                                           bool hi_valid) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int c = i * 8 + 2 * t;
    if (lo_valid) store_pair(o_lo + c, acc[i][0] * inv_lo, acc[i][1] * inv_lo);
    if (hi_valid) store_pair(o_hi + c, acc[i][2] * inv_hi, acc[i][3] * inv_hi);
  }
}

// Merge of split-KV partials (the MLA decode's): out = sum_s w_s o_s /
// sum_s w_s with w_s = exp(lse_s - max lse) over the splits whose lse is
// finite (a split with no valid key writes lse -inf and may leave its o
// unwritten); no valid key in any split -> out 0, lse -inf. One CTA of D
// threads per row of o_part [splits, n_rows, D].
template <int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(const float* o_part,
                                                         const float* lse_part,
                                                         __nv_bfloat16* out, float* lse,
                                                         int splits, int n_rows) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lse_part[s * static_cast<size_t>(n_rows) + row]);
  float l = 0.f, o = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const size_t idx = s * static_cast<size_t>(n_rows) + row;
      if (lse_part[idx] == -INFINITY) continue;
      const float w = expf(lse_part[idx] - mx);
      l += w;
      o += w * o_part[idx * D + d];
    }
  }
  const bool empty = !(l > 0.f);
  out[row * D + d] = __float2bfloat16_rn(empty ? 0.f : o / l);
  if (d == 0) lse[row] = empty ? -INFINITY : mx + logf(l);
}

// Copy k-tile `tile` of K and V (rows past seqlen_k are zero-filled).
template <int D>
__device__ __forceinline__ void load_kv_tile(const FwdParams& p,
                                             const __nv_bfloat16* kbase,
                                             const __nv_bfloat16* vbase,
                                             __nv_bfloat16* ks,
                                             __nv_bfloat16* vs, int tile) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  constexpr int kChunks = kBlockK * kChunksPerRow;
  const int row0 = tile * kBlockK;
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool valid = row0 + r < p.seqlen_k;
    const size_t src = static_cast<size_t>(valid ? row0 + r : 0) * D + col;
    cp_async16(ks + r * (D + 8) + col, kbase + src, valid);
    cp_async16(vs + r * (D + 8) + col, vbase + src, valid);
  }
}

// The coarse walks: positions (e, s), entry e of the coarse schedule row and
// fine k-tile s of it, in order; kSuper visits only live fine tiles.
template <int MODE>
struct CoarseWalk {
  const int* sched;  // coarse tiles, kv_idx[0..n)
  const int* bits;   // kSuper: sub-tile liveness per entry
  int n;             // entries
  int ksub;          // fine k-tiles per entry
  int shift;         // kSuper: bit offset of this q-tile's sub-tiles

  __device__ __forceinline__ unsigned live(int e) const {
    const unsigned full = ksub >= 32 ? 0xffffffffu : (1u << ksub) - 1u;
    if constexpr (MODE == kSuper) {
      return (static_cast<unsigned>(bits[e]) >> shift) & full;
    } else {
      return full;
    }
  }

  // Step (e, s) to the next visited position; false past the end. The
  // first call (s = -1) finds the first position.
  __device__ __forceinline__ bool advance(int& e, int& s) const {
    for (++s; e < n; ++e, s = 0) {
      if (s < ksub) {
        const unsigned rest = live(e) >> s;
        if (rest) {
          s += __ffs(rest) - 1;
          return true;
        }
      }
    }
    return false;
  }

  __device__ __forceinline__ int tile(int e, int s) const { return sched[e] * ksub + s; }
};

template <int D>
__device__ __forceinline__ void load_q(const FwdParams& p, size_t bh, int r_lo,
                                       int r_hi, uint32_t (&qf)[D / 16][4]) {
  // Q fragments straight from global memory (A operand, row-major).
  const int t = threadIdx.x % 4;
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;
  const __nv_bfloat16* qrow_lo = p.q + (bh * p.seqlen_q + r_lo) * D;
  const __nv_bfloat16* qrow_hi = p.q + (bh * p.seqlen_q + r_hi) * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = lo_valid ? *reinterpret_cast<const uint32_t*>(qrow_lo + c) : 0u;
    qf[kk][1] = hi_valid ? *reinterpret_cast<const uint32_t*>(qrow_hi + c) : 0u;
    qf[kk][2] = lo_valid ? *reinterpret_cast<const uint32_t*>(qrow_lo + c + 8) : 0u;
    qf[kk][3] = hi_valid ? *reinterpret_cast<const uint32_t*>(qrow_hi + c + 8) : 0u;
  }
}

// One k-tile of the mainloop: S = Q K^T for this warp's 16 rows x 128 keys
// (columns past seqlen_k masked to -inf), then `vote(mx_lo, mx_hi)` with the
// tile's row maxima in log2 space before the running max absorbs them, then
// the online softmax update (the scale inside each exp2, as B1) and O += P V.
template <int D, typename Vote>
__device__ __forceinline__ void attend_tile(
    const FwdParams& p, const uint32_t (&qf)[D / 16][4], float (&acc)[D / 8][4],
    float& m_lo, float& m_hi, float& l_lo, float& l_hi, const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, int tile, int r_lo, int r_hi, Vote&& vote) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float s[16][4];
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      const __nv_bfloat16* kp = ks + (nb * 8 + g) * (D + 8) + kk * 16 + 2 * t;
      mma_bf16(s[nb], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
               *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }

  const int col0 = tile * kBlockK;
  float mx_lo, mx_hi;
  mask_scores(
      s, 1.f, col0 + kBlockK > p.seqlen_k, col0,
      [&](int col, bool hi) { return key_masked<false>(col, hi ? r_hi : r_lo, p.seqlen_k, 0); },
      mx_lo, mx_hi);

  vote(mx_lo * p.scale_log2, mx_hi * p.scale_log2);

  float alpha_lo, alpha_hi;
  softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, p.scale_log2);
  rescale_rows(acc, alpha_lo, alpha_hi);
  pv_product(acc, s, vs, D + 8);
}

// Epilogue: full row sums, normalize, natural-log lse.
template <int D>
__device__ __forceinline__ void store_out(const FwdParams& p, size_t bh, int r_lo,
                                          int r_hi, float (&acc)[D / 8][4], float m_lo,
                                          float m_hi, float l_lo, float l_hi) {
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;
  float inv_lo, inv_hi, lse_lo, lse_hi;
  finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
  store_rows(p.out + (bh * p.seqlen_q + r_lo) * D, p.out + (bh * p.seqlen_q + r_hi) * D, acc,
             inv_lo, inv_hi, lo_valid, hi_valid);
  if (threadIdx.x % 4 == 0) {
    if (lo_valid) p.lse[bh * p.seqlen_q + r_lo] = lse_lo;
    if (hi_valid) p.lse[bh * p.seqlen_q + r_hi] = lse_hi;
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const FwdParams p) {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static_assert(MODE == kCoarse || MODE == kSuper, "the coarse walks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kTileElems = kBlockK * (D + 8);

  const int qt = blockIdx.x;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  // Rows of this thread: r_lo (fragment rows g) and r_hi (g + 8).
  const int r_lo = qt * kBlockQ + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  // One head per CTA, the coarse row of this q-tile.
  const int h = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * p.heads + h;
  const int hk = h / (p.heads / p.kv_heads);
  const size_t kv = (static_cast<size_t>(b) * p.kv_heads + hk) * p.seqlen_k * D;
  const size_t srow = bh * p.sched_q + qt / p.qsub;
  CoarseWalk<MODE> w{};
  w.sched = p.fidx + srow * p.sched_k;
  w.n = p.count[srow];
  w.ksub = p.ksub;
  if constexpr (MODE == kSuper) {
    w.bits = p.bits + srow * p.sched_k;
    w.shift = (qt % p.qsub) * p.ksub;
  }
  int* vrow = p.votes +
              (bh * p.vote_q + (MODE == kCoarse ? qt / p.qsub : qt)) * p.vote_k;
  // kSuper: the lowest live fine tile of entry 0 votes 0.
  const int anchor = MODE == kSuper && w.n > 0 ? __ffs(w.live(0)) - 1 : -1;
  int e = 0, s = -1;
  bool have = w.advance(e, s);
  if (have) load_kv_tile<D>(p, p.k + kv, p.v + kv, smem, smem + kTileElems, w.tile(e, s));
  cp_async_commit();
  load_q<D>(p, bh, r_lo, r_hi, qf);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;
  float mv_lo = -INFINITY, mv_hi = -INFINITY;
  int step = -1;      // entry of the previous position
  int step_keep = 0;  // kCoarse: some fine tile of the entry passed
  for (int it = 0; have; ++it) {
    int ne = e, ns = s;
    const bool more = w.advance(ne, ns);
    const int stage = it & 1;
    __nv_bfloat16* nxt = smem + (stage ^ 1) * 2 * kTileElems;
    if (more) load_kv_tile<D>(p, p.k + kv, p.v + kv, nxt, nxt + kTileElems, w.tile(ne, ns));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = smem + stage * 2 * kTileElems;
    const int tile = w.tile(e, s);
    attend_tile<D>(
        p, qf, acc, m_lo, m_hi, l_lo, l_hi, ks, ks + kTileElems, tile, r_lo, r_hi,
        [&](float mx_lo, float mx_hi) {
          if (e != step) {  // a new entry: snapshot m_prev
            step = e;
            mv_lo = m_lo;
            mv_hi = m_hi;
            step_keep = 0;
          }
          const float mp_lo = e == 0 ? -INFINITY : fmaxf(mv_lo, kMaskValue);
          const float mp_hi = e == 0 ? -INFINITY : fmaxf(mv_hi, kMaskValue);
          const bool keep = (lo_valid & (fmaxf(mx_lo, kMaskValue) - mp_lo > p.thr)) |
                            (hi_valid & (fmaxf(mx_hi, kMaskValue) - mp_hi > p.thr));
          const int any_keep = __syncthreads_or(keep);
          if (threadIdx.x == 0) {
            if constexpr (MODE == kSuper) {
              vrow[tile] = (any_keep || (e == 0 && s == anchor)) ? 0 : 1;
            } else {
              step_keep |= any_keep;
              if (!(more && ne == e)) {  // the entry's last fine tile
                atomicAnd(vrow + w.sched[e], (e == 0 || step_keep) ? 0 : 1);
              }
            }
          }
        });
    __syncthreads();
    e = ne;
    s = ns;
    have = more;
  }
  store_out<D>(p, bh, r_lo, r_hi, acc, m_lo, m_hi, l_lo, l_hi);
  cp_async_wait<0>();
}

// Host-side launch of one instantiation on `stream`: one CTA per fine q-tile
// and head. Returns the CUDA error of the launch (0 on success).
template <int D, int MODE>
cudaError_t launch_attention_fwd(const FwdParams& p, int batch,
                                 cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<D, MODE>;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.qtiles, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace lite
