// The online-softmax row steps and small mma.sync helpers that the forward
// kernels share: B1, B3, B4 and B5 (flash_fwd.cu:flash_fwd_kernel, wgmma),
// B1's MLA channels at V 512 (mla_fwd.cu), the decode kernel B8/B9
// (flash_decode.cu, mma.sync) and the MLA decode B10 (mla_decode.cu), and
// the decode kernels' chunk arithmetic. No kernel lives here: what bounds
// each kernel on the H100 is in its own header.
//
// Scores live in log2 space (s * scale * log2e), so the online softmax uses
// exp2; the lse written out is natural log. A row with no valid key keeps
// its running max at -inf and ends with out 0, lse -inf, never NaN.
//
// The vote contract of the sparse forwards (B3, B4, B5; the JAX kernels'):
// a vote step is `gsize` list entries (B3, B5) or one coarse entry (B4);
// m_prev is the running row max from before the step, and a fine tile passes
// for a valid q row iff (max_col s - m_prev) > thr, strictly.
//   list (B3/B5): each visited tile votes "do" (0) iff some row passes, else
//            "skip" (1), into the fine [B, H, Qt, Kt] array; the first entry
//            always votes 0.
//   coarse (B4): the coarse tile votes 0 iff some row of its 128 * qsub rows
//            passes on some of its fine tiles (the qsub CTAs of the coarse
//            row each store 0 into votes pre-filled with 1: their AND); the
//            first entry votes 0.
//   super-tile (B4): each visited fine tile votes into the fine [B, H, Qt_c
//            * qsub, Kt_c * ksub] array; in the first entry, the lowest live
//            fine tile of this q-tile votes 0.
// The coarse walks test the JAX kernel's values exactly: it masks dead
// columns with the finite kMaskValue, not -inf, so its running max is
// max(m, kMaskValue) once an entry was visited and a fully masked fine tile's
// max is kMaskValue. The vote clamps both to kMaskValue the same way (the
// softmax itself keeps -inf: the outputs do not depend on the sentinel).
// Keys past Sk are masked by key_mask.cuh's test, the one B1 and B7 use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "key_mask.cuh"

namespace lite {

constexpr float kLn2 = 0.6931471805599453f;
// The JAX kernels' finite mask value, -0.7 * FLT_MAX rounded to fp32.
constexpr float kMaskValue = -0x1.666664p+127f;

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

// c += A B, mma.sync m16n8k8 (bf16 in, fp32 accumulate): a0 / a1 hold row
// g / g + 8 of A at k 2 t, 2 t + 1 (an m16n8 accumulator block rounded to
// bf16 pairs), b holds B at k 2 t, 2 t + 1 of column g.
__device__ __forceinline__ void mma_bf16_k8(float* c, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
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

// Row steps of the online softmax, shared by the forward kernels
// (flash_fwd.cu, mla_fwd.cu), the decode kernel (flash_decode.cu) and the
// MLA decode (mla_decode.cu). A warp owns 16 q rows of an m16n8k16 tile: lane (g, t) =
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

// P of keys 16 kc .. 16 kc + 15 as the A operand of m16n8k16: the
// accumulator layout of two 8-key blocks is the A fragment layout.
template <int NB>
__device__ __forceinline__ void p_operand(const float (&s)[NB][4], int kc, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
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

// The split decode kernels' (B8/B9, B10) cut of T flat key tiles into C
// equal chunks, chunk c holding tiles [c T / C, (c + 1) T / C): the chunk
// that holds tile x.
__device__ __forceinline__ int chunk_of(long long x, long long total, long long chunks) {
  return static_cast<int>(((x + 1) * chunks + total - 1) / total) - 1;
}

}  // namespace lite
