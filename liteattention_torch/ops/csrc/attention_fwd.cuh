// Shared forward mainloop of the dense (B1) and lite (B3) attention kernels.
//
// One CTA owns one 128-row q-tile of one (batch, head): 8 warps, 16 q rows
// each. K and V are walked in 128-key tiles through a two-stage cp.async ring
// in shared memory; QK^T and PV run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate). Scores live in log2 space (s * scale * log2e) so the online
// softmax uses exp2; the lse written out is natural log.
//
// The schedule policy is a template parameter:
//   SPARSE = false: visit every k-tile 0..ceil(Sk/128)-1 (dense forward, B1);
//   SPARSE = true:  visit fidx[0..count) of this (b, h, q-tile) row, the
//                   compacted live fine k-tiles in increasing order (B3).
// CAUSAL (dense only) adds the bottom-right-aligned causal mask: key col is
// valid for q row r iff col <= r + causal_offset (causal_offset = Sk - Sq).
// The walk stops at the last k-tile that the q-tile's last row reaches, so
// tiles above the diagonal cost no load and no math, and q-tiles are taken
// in reverse block order so the longest walks start first. A row with no
// valid key keeps its running max at -inf and ends with out 0, lse -inf.
// VOTES (SPARSE only) adds the skip vote of every visited tile: with m_prev
// the running row max from before the tile's vote step (a step is `gsize`
// consecutive schedule entries), the tile votes "do" (0) iff some valid
// q row has (max_col s - m_prev) > thr, strict, and "skip" (1) otherwise.
// The first schedule entry always votes 0. Votes go straight into the fine
// [B, H, Qt, Kt] int32 array (pre-filled with 1 by the caller).
//
// What bounds it on the H100: at 128x128 tiles each K/V byte loaded feeds
// 128 q rows, so the kernel is bound by tensor-core issue, and mma.sync
// reaches well under the wgmma rate. This first version keeps the design
// simple (no TMA, no warp specialization, no wgmma); skipped tiles cost no
// load and no math, which is what turns sparsity into time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lite {

constexpr int kBlockQ = 128;  // q rows per CTA = one fine q-tile
constexpr int kBlockK = 128;  // keys per k-tile = one fine k-tile
constexpr int kWarps = 8;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdParams {
  const __nv_bfloat16* q;  // [B, H, Sq, D]
  const __nv_bfloat16* k;  // [B, Hk, Sk, D]
  const __nv_bfloat16* v;  // [B, Hk, Sk, D]
  __nv_bfloat16* out;      // [B, H, Sq, D]
  float* lse;              // [B, H, Sq]
  const int* fidx;         // [B, H, Qt, Kt]   (SPARSE)
  const int* count;        // [B, H, Qt]       (SPARSE)
  const uint8_t* mask;     // [B, H, Qt, Kt]   (SPARSE)
  int* votes;              // [B, H, Qt, Kt]   (VOTES)
  int heads, kv_heads, seqlen_q, seqlen_k;
  int qtiles, ktiles, gsize;
  int causal_offset;  // Sk - Sq (CAUSAL)
  float scale_log2;  // softmax scale * log2(e)
  float thr;         // vote threshold, log2 space
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

template <int D, bool SPARSE, bool VOTES, bool CAUSAL = false>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const FwdParams p) {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static_assert(SPARSE || !VOTES, "votes need the sparse schedule");
  static_assert(!(SPARSE && CAUSAL), "causal is a channel of the dense schedule");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kTileElems = kBlockK * (D + 8);

  const int qt = CAUSAL ? p.qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row within an 8-row group
  const int t = lane % 4;  // fragment column pair

  const size_t bh = static_cast<size_t>(b) * p.heads + h;
  const size_t row_id = bh * p.qtiles + qt;  // (b, h, q-tile) schedule row
  const __nv_bfloat16* kbase =
      p.k + (static_cast<size_t>(b) * p.kv_heads + hk) * p.seqlen_k * D;
  const __nv_bfloat16* vbase =
      p.v + (static_cast<size_t>(b) * p.kv_heads + hk) * p.seqlen_k * D;

  // Rows of this thread: r_lo (fragment rows g) and r_hi (g + 8).
  const int r_lo = qt * kBlockQ + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;

  int n_tiles = p.ktiles;
  if constexpr (CAUSAL) {
    // Last key that the q-tile's last (padded) row may see.
    const int last = qt * kBlockQ + kBlockQ - 1 + p.causal_offset;
    n_tiles = last < 0 ? 0 : min(p.ktiles, last / kBlockK + 1);
  }
  const int* sched = nullptr;
  if constexpr (SPARSE) {
    sched = p.fidx + row_id * p.ktiles;
    n_tiles = p.count[row_id];
    // count is max(live, 1): a row with no live tile lists tile fidx[0]
    // as a dead anchor. It contributes nothing (out 0, lse -inf).
    if (!p.mask[row_id * p.ktiles + sched[0]]) n_tiles = 0;
    if constexpr (VOTES) {
      if (threadIdx.x == 0) p.votes[row_id * p.ktiles + sched[0]] = 0;
    }
  }

  // Q fragments straight from global memory (A operand, row-major).
  uint32_t qf[D / 16][4];
  {
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

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
  float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums
  float mv_lo = -INFINITY, mv_hi = -INFINITY;  // row max before the vote step

  auto tile_at = [&](int j) { return SPARSE ? sched[j] : j; };

  if (n_tiles > 0) {
    load_kv_tile<D>(p, kbase, vbase, smem, smem + kTileElems, tile_at(0));
  }
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + (stage ^ 1) * 2 * kTileElems;
      load_kv_tile<D>(p, kbase, vbase, nxt, nxt + kTileElems, tile_at(j + 1));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* ks = smem + stage * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;
    const int tile = tile_at(j);

    // S = Q K^T for this warp's 16 rows x 128 keys.
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

    // Log2-space scores; columns past seqlen_k never contribute.
    const int col0 = tile * kBlockK;
    const bool ragged = col0 + kBlockK > p.seqlen_k;
    // Only tiles that cross the diagonal need the per-element causal test.
    const bool diag =
        CAUSAL && col0 + kBlockK - 1 > qt * kBlockQ + warp * 16 + p.causal_offset;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * p.scale_log2;
        const int col = col0 + nb * 8 + 2 * t + (e & 1);
        if (ragged && col >= p.seqlen_k) x = -INFINITY;
        if (diag && col > (e < 2 ? r_lo : r_hi) + p.causal_offset) x = -INFINITY;
        s[nb][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nb][0], s[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nb][2], s[nb][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));

    if constexpr (VOTES) {
      if (j % p.gsize == 0) {  // a new vote step starts: snapshot m_prev
        mv_lo = m_lo;
        mv_hi = m_hi;
      }
      const bool keep = (lo_valid && mx_lo - mv_lo > p.thr) ||
                        (hi_valid && mx_hi - mv_hi > p.thr);
      // CTA-wide OR over all 128 rows (every warp walks the same tiles).
      const int any_keep = __syncthreads_or(keep);
      if (threadIdx.x == 0 && j > 0) {
        p.votes[row_id * p.ktiles + tile] = any_keep ? 0 : 1;
      }
    }

    // Online softmax update.
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float alpha_lo = fast_exp2(m_lo - base_lo);
    const float alpha_hi = fast_exp2(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      s[nb][0] = fast_exp2(s[nb][0] - base_lo);
      s[nb][1] = fast_exp2(s[nb][1] - base_lo);
      s[nb][2] = fast_exp2(s[nb][2] - base_hi);
      s[nb][3] = fast_exp2(s[nb][3] - base_hi);
      sum_lo += s[nb][0] + s[nb][1];
      sum_hi += s[nb][2] + s[nb][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha_lo;
      acc[i][1] *= alpha_lo;
      acc[i][2] *= alpha_hi;
      acc[i][3] *= alpha_hi;
    }

    // O += P V: P's accumulator layout is reused as the A operand.
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, vs + key * (D + 8) + db * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * db], a, bfrag[0], bfrag[1]);
        mma_bf16(acc[2 * db + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  // Epilogue: full row sums, normalize, natural-log lse.
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const bool empty_lo = !(l_lo > 0.f) || m_lo == -INFINITY;
  const bool empty_hi = !(l_hi > 0.f) || m_hi == -INFINITY;
  const float inv_lo = empty_lo ? 0.f : 1.f / l_lo;
  const float inv_hi = empty_hi ? 0.f : 1.f / l_hi;
  __nv_bfloat16* orow_lo = p.out + (bh * p.seqlen_q + r_lo) * D;
  __nv_bfloat16* orow_hi = p.out + (bh * p.seqlen_q + r_hi) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (lo_valid) {
      *reinterpret_cast<uint32_t*>(orow_lo + c) =
          pack_bf16(acc[i][0] * inv_lo, acc[i][1] * inv_lo);
    }
    if (hi_valid) {
      *reinterpret_cast<uint32_t*>(orow_hi + c) =
          pack_bf16(acc[i][2] * inv_hi, acc[i][3] * inv_hi);
    }
  }
  if (t == 0) {
    if (lo_valid) {
      p.lse[bh * p.seqlen_q + r_lo] =
          empty_lo ? -INFINITY : m_lo * kLn2 + logf(l_lo);
    }
    if (hi_valid) {
      p.lse[bh * p.seqlen_q + r_hi] =
          empty_hi ? -INFINITY : m_hi * kLn2 + logf(l_hi);
    }
  }
}

// Host-side launch of one instantiation on `stream`; returns the CUDA error
// of the launch (0 on success).
template <int D, bool SPARSE, bool VOTES, bool CAUSAL = false>
cudaError_t launch_attention_fwd(const FwdParams& p, int batch,
                                 cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<D, SPARSE, VOTES, CAUSAL>;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.qtiles, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace lite
