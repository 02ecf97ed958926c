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
// col <= r + Sk - Sq), tested in one place (key_masked).
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

// Shared-memory layout (byte offsets from a 1024-byte aligned base).
template <int D>
struct Smem {
  static constexpr int kKV = kKeys * D * 2;   // one K or V tile
  static constexpr int kQ = kRows * D * 2;    // one Q or dO tile
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
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// The mask of one (key, q row) entry: key past Sk, or above the diagonal.
// Later mask channels (segments, window, bounds) add their tests here.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(const Params& p, int key, int row, bool ragged,
                                           bool diag) {
  return (ragged && key >= p.seqlen_k) || (CAUSAL && diag && key > row + p.causal_offset);
}

// ------------------------------------------------------------ (a) pre

template <int D>
__global__ void bwd_pre_kernel(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ lse2,
                               float* __restrict__ delta, float* __restrict__ dq_accum,
                               int seqlen_q, int seqlen_q_pad, int rows) {
  constexpr int kLanes = D / 8;  // threads per row, 8 values each
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kLanes;
  const int part = gid % kLanes;
  const bool live = row < rows;
  const int bh = row / seqlen_q_pad;
  const int r = row % seqlen_q_pad;
  const bool valid = live && r < seqlen_q;
  float acc = 0.f;
  if (valid) {
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
  float4* z = reinterpret_cast<float4*>(dq_accum + static_cast<size_t>(row) * D + part * 8);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (part == 0) {
    delta[row] = valid ? acc : 0.f;
    lse2[row] = valid ? lse_log2(lse[static_cast<size_t>(bh) * seqlen_q + r]) : INFINITY;
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

// K and V of the CTA's k-tile, once.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                        unsigned char* smem, int k0, int kvh) {
  using L = Smem<D>;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  sm90::mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
  for (int a = 0; a < D / 64; ++a) {
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
  for (int a = 0; a < D / 64; ++a) {
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
// refills the ring and adds each step's dQ part to the accumulator.
template <int D, bool CAUSAL>
__device__ __forceinline__ void consume(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                                        const Params& p, unsigned char* smem, const Walk& walk,
                                        int b, int hk, int k0, int n_iter) {
  using L = Smem<D>;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  const int ct = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, ct / 128, 0);  // warp-uniform to the compiler
  const int tw = ct % 128;
  const int warp = tw / 32;
  const int g = (tw % 32) / 4;
  const int t = tw % 4;
  const int key_lo = k0 + 64 * wg + 16 * warp + g;  // this thread's rows: key_lo, key_lo + 8
  const bool ragged = k0 + kKeys > p.seqlen_k;
  const uint32_t k_addr = sm90::smem_u32(smem + L::k);
  // K and V rows of this warpgroup as K-major A operands; dS and K as the
  // MN-major operands of dQ = dS K (K: this warpgroup's D / 2 columns).
  const uint64_t k_desc = desc_sw128(k_addr + 64 * wg * 128, 16, 1024);
  const uint64_t v_desc = desc_sw128(sm90::smem_u32(smem + L::v) + 64 * wg * 128, 16, 1024);
  const uint64_t ds_desc = desc_sw128(sm90::smem_u32(smem + L::ds), kRows * 128, 1024);
  const uint64_t kt_desc =
      desc_sw128(k_addr + (D == 128 ? wg * kKeys * 128 : wg * 64), kKeys * 128, 1024);
  unsigned char* ds_smem = smem + L::ds;
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
    const bool diag = CAUSAL && k0 + 64 * wg + 16 * warp + 15 > row0 + p.causal_offset;
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int e = 8 * k; e < 8 * k + 8; ++e) {
        const int qc = 8 * (e / 4) + 2 * t + (e & 1);
        const int key = key_lo + 8 * ((e >> 1) & 1);
        s[e] = key_masked<CAUSAL>(p, key, row0 + qc, ragged, diag)
                   ? 0.f
                   : ex2(s[e] * p.scale_log2 - lse2[qc]);
        dp[e] = s[e] * (dp[e] - delta[qc]) * p.scale;
      }
      sm90::frag_a(pf[k], s, k);
      sm90::frag_a(dsf[k], dp, k);
    }

    // dV += P^T dO.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sm90::desc_add(dot_desc, kk * 2048);
      if constexpr (D == 128) {
        sm90::wgmma_rs_n128<1>(dv, pf[kk], db, 1);
      } else {
        sm90::wgmma_rs_n64<1>(dv, pf[kk], db, 1);
      }
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
      const uint64_t db = sm90::desc_add(qt_desc, kk * 2048);
      if constexpr (D == 128) {
        sm90::wgmma_rs_n128<1>(dk, dsf[kk], db, 1);
      } else {
        sm90::wgmma_rs_n64<1>(dk, dsf[kk], db, 1);
      }
    }
    sm90::wgmma_commit();
    if (ct == 0) sm90::bulk_wait_read();  // the dQ buffer is free again
    sm90::named_sync(2, kConsumers);      // dS^T complete

    // dQ_part = dS K over the 128 keys: this warpgroup's D / 2 columns.
    float dq[D / 4];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t da = sm90::desc_add(ds_desc, kk * 2048);
      const uint64_t db = sm90::desc_add(kt_desc, kk * 2048);
      if constexpr (D == 128) {
        sm90::wgmma_ss_n64<1, 1>(dq, da, db, kk > 0);
      } else {
        sm90::wgmma_ss_n32<1, 1>(dq, da, db, kk > 0);
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
    // warpgroup wg at (wg * D / 16 + j) * 128 + tw (bwd_post_kernel reads
    // it back in that order).
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dq_smem[(wg * (D / 16) + j) * 128 + tw] =
          make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const Params p) {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
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
  int q_first = 0;
  if constexpr (CAUSAL) {
    // First q-tile whose last row reaches the k-tile's first key.
    const int x = k0 - p.causal_offset;
    q_first = x < 0 ? 0 : min(qtiles, x / kRows);
  }
  const int nq = qtiles - q_first;
  const int ktiles = (p.seqlen_k + kKeys - 1) / kKeys;
  const Walk walk{(b * p.heads + hk * (p.heads / p.kv_heads)), q_first, nq,
                  CAUSAL ? 0 : kt * nq / ktiles};
  const int n_iter = p.heads / p.kv_heads * nq;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_iter > 0) {
    load_kv<D>(tm_k, tm_v, smem, k0, b * p.kv_heads + hk);
    for (int it = 0; it < kStages - 1 && it < n_iter; ++it) {
      load_step<D>(tm_q, tm_do, p, smem, it, walk.bh(it), walk.row0(it));
    }
  }
  consume<D, CAUSAL>(tm_q, tm_do, p, smem, walk, b, hk, k0, n_iter);
}

// ----------------------------------------------------------- (c) post

// One CTA per (64-row block, b * H + h): the accumulator's thread order
// back to rows through shared memory, then rows of bf16 in 16-byte stores.
template <int D>
__global__ void bwd_post_kernel(const float* __restrict__ dq_accum, __nv_bfloat16* __restrict__ dq,
                                int seqlen_q, int seqlen_q_pad) {
  constexpr int kPitch = D + 4;  // floats per row of the tile
  __shared__ float tile[kRows * kPitch];
  const int blk = blockIdx.x;
  const size_t bh = blockIdx.y;
  const float4* src =
      reinterpret_cast<const float4*>(dq_accum + (bh * seqlen_q_pad + blk * kRows) * D);
  for (int f = threadIdx.x; f < kRows * D / 4; f += blockDim.x) {
    const int tw = f % 128;
    const int j = (f / 128) % (D / 16);
    const int wg = f / 128 / (D / 16);
    const float4 x = src[f];
    const int row = 16 * (tw / 32) + (tw % 32) / 4;
    const int col = wg * (D / 2) + 8 * j + 2 * (tw % 4);
    *reinterpret_cast<float2*>(tile + row * kPitch + col) = make_float2(x.x, x.y);
    *reinterpret_cast<float2*>(tile + (row + 8) * kPitch + col) = make_float2(x.z, x.w);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kRows * D / 8; c += blockDim.x) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    if (blk * kRows + row >= seqlen_q) continue;
    const float* x = tile + row * kPitch + col;
    uint4 out;
    out.x = sm90::pack_bf16x2(x[0], x[1]);
    out.y = sm90::pack_bf16x2(x[2], x[3]);
    out.z = sm90::pack_bf16x2(x[4], x[5]);
    out.w = sm90::pack_bf16x2(x[6], x[7]);
    *reinterpret_cast<uint4*>(dq + (bh * seqlen_q + blk * kRows + row) * D + col) = out;
  }
}

// ------------------------------------------------------------------ host

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *dq_accum, *lse2, *delta;
  int batch, heads, kv_heads, seqlen_q, seqlen_k;
  float scale;
};

template <int D, bool CAUSAL>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const int sq_pad = (a.seqlen_q + kRows - 1) / kRows * kRows;
  const int rows = a.batch * a.heads * sq_pad;
  constexpr int kPreThreads = 256;
  const long long pre_threads = static_cast<long long>(rows) * (D / 8);
  bwd_pre_kernel<D><<<static_cast<int>((pre_threads + kPreThreads - 1) / kPreThreads),
                       kPreThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.lse2),
      static_cast<float*>(a.delta), static_cast<float*>(a.dq_accum), a.seqlen_q, sq_pad, rows);
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
  auto kernel = flash_bwd_kernel<D, CAUSAL>;
  constexpr int smem = Smem<D>::bytes + 1024;  // + alignment of the base
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ktiles = (a.seqlen_k + kKeys - 1) / kKeys;
  kernel<<<ktiles * bhk, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_post_kernel<D><<<dim3(sq_pad / kRows, bh), 256, 0, stream>>>(
      static_cast<const float*>(a.dq_accum), static_cast<__nv_bfloat16*>(a.dq), a.seqlen_q,
      sq_pad);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace lite

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
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
