// B1: dense flash-attention forward on Hopper (replaces the Pallas kernel
// liteattention_tpu/ops/flash_fwd.py:_fwd_kernel).
//
// bf16 q/k/v in [B, H, S, D] (D = 64 or 128), GQA by h / group, optionally
// causal (bottom-right aligned, offset Sk - Sq); ragged Sq and Sk are masked
// inside the kernel. Out in bf16, lse fp32 natural log. The mainloop is
// shared with the lite kernel (attention_fwd.cuh) under the dense schedule:
// every k-tile in order (up to the diagonal when causal).
#include "attention_fwd.cuh"

extern "C" int lite_flash_fwd_dense(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int batch, int heads, int kv_heads,
                                    int seqlen_q, int seqlen_k, int head_dim,
                                    float scale, int causal, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lite::FwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.qtiles = (seqlen_q + lite::kBlockQ - 1) / lite::kBlockQ;
  p.ktiles = (seqlen_k + lite::kBlockK - 1) / lite::kBlockK;
  p.gsize = 1;
  p.fold = 1;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.thr = 0.f;
  p.causal_offset = seqlen_k - seqlen_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kDense = lite::kDense;
  if (head_dim == 64) {
    err = causal ? lite::launch_attention_fwd<64, kDense, false, true>(p, batch, s)
                 : lite::launch_attention_fwd<64, kDense, false>(p, batch, s);
  } else if (head_dim == 128) {
    err = causal ? lite::launch_attention_fwd<128, kDense, false, true>(p, batch, s)
                 : lite::launch_attention_fwd<128, kDense, false>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B1's MLA channels (liteattention_tpu/ops/flash_fwd.py:_fwd_kernel with
// has_qv, or V of its own head dim DV != DK): forward only, as in JAX.
//
// The score is q . k (DK channels), plus qv . v (DV channels) with QV; the
// output takes V's head dim. Neither the 128 x DV accumulator (at DV 512: 256
// KB) nor q's fragments at DK 576 fit a CTA's registers, so the walk differs
// from the mainloop above: q (and qv) stay in shared memory for the whole
// walk (in registers when the score channels are at most 256), and each CTA
// produces one 128-wide chunk of V's channels, recomputing S for each chunk.
// That costs (DV / 128 - 1) extra passes of QK^T: at (576, 512) 3 x 2 x 576
// FLOP per (row, key) on top of the 2 x (576 + 512) needed (x2.6); at
// (192, 128), DeepSeek's non-absorbed prefill shape, nothing. With QV the
// ring holds V's whole rows, since S reads them all; the chunk's PV reads its
// columns from the same tile. mma.sync m16n8k16 with ldmatrix fragments, a
// two-stage cp.async ring of BK-key tiles, exp2 online softmax (the row steps
// of attention_fwd.cuh), causal bottom-right (offset Sk - Sq) with the walk
// stopped at the diagonal and the q-tiles in reverse order. Bound on the H100
// by tensor-core issue, as B1.
namespace mla_fwd {

using lite::cp_async16;
using lite::cp_async_commit;
using lite::cp_async_wait;
using lite::finish_rows;
using lite::ldmatrix_x4;
using lite::mask_scores;
using lite::mma_bf16;
using lite::pv_product;
using lite::softmax_update;
using lite::store_rows;

constexpr int kChunk = 128;  // V channels (output columns) per CTA

struct Params {
  const __nv_bfloat16* q;   // [B, H, Sq, DK]
  const __nv_bfloat16* qv;  // [B, H, Sq, DV] (QV)
  const __nv_bfloat16* k;   // [B, Hk, Sk, DK]
  const __nv_bfloat16* v;   // [B, Hk, Sk, DV]
  __nv_bfloat16* out;       // [B, H, Sq, DV]
  float* lse;               // [B, H, Sq]
  int heads, kv_heads, seqlen_q, seqlen_k, qtiles, chunks, causal_offset;
  float scale_log2;
};

template <int DK, int DV, bool QV, int WARPS, int BK>
struct Geometry {
  static constexpr int kRowsQ = 16 * WARPS;        // q rows per CTA
  static constexpr int kDS = DK + (QV ? DV : 0);   // score channels
  static constexpr int kQPitch = kDS + 8;          // shared row pitches: odd
  static constexpr int kKPitch = DK + 8;           // multiples of 16 bytes
  static constexpr int kVW = QV ? DV : kChunk;     // V channels in the ring
  static constexpr int kVPitch = kVW + 8;
  static constexpr bool kQRegs = kDS <= 256;
  static constexpr int kStage = BK * (kKPitch + kVPitch);  // elements
  static constexpr int kSmem = (kRowsQ * kQPitch + 2 * kStage) * 2;
  static_assert(DK % 16 == 0 && DV % kChunk == 0 && BK % 16 == 0, "tile shapes");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

template <int DK, int DV, bool QV, int WARPS, int BK, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32, 1) mla_fwd_kernel(const Params p) {
  using G = Geometry<DK, DV, QV, WARPS, BK>;
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRowsQ][kQPitch]
  __nv_bfloat16* ring = qs + G::kRowsQ * G::kQPitch;                // [2][kStage]

  const int qt = CAUSAL ? p.qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y / p.chunks;
  const int chunk = blockIdx.y % p.chunks;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const size_t bh = static_cast<size_t>(b) * p.heads + h;
  const size_t bhk = static_cast<size_t>(b) * p.kv_heads + hk;
  const __nv_bfloat16* qb = p.q + bh * p.seqlen_q * DK;
  const __nv_bfloat16* qvb = QV ? p.qv + bh * p.seqlen_q * DV : qb;
  const __nv_bfloat16* kb = p.k + bhk * p.seqlen_k * DK;
  const __nv_bfloat16* vb = p.v + bhk * p.seqlen_k * DV + (QV ? 0 : chunk * kChunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * G::kRowsQ;
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int lim_lo = CAUSAL ? min(p.seqlen_k, r_lo + p.causal_offset + 1) : p.seqlen_k;
  const int lim_hi = CAUSAL ? min(p.seqlen_k, r_hi + p.causal_offset + 1) : p.seqlen_k;

  int n = (p.seqlen_k + BK - 1) / BK;
  if constexpr (CAUSAL) {
    const int last = q0 + G::kRowsQ - 1 + p.causal_offset;  // the last row's last key
    n = last < 0 ? 0 : min(n, last / BK + 1);
  }

  // q | qv rows of this tile (rows past Sq zero-fill), in the first group.
  constexpr int kQChunks = G::kDS / 8;
  for (int c = threadIdx.x; c < G::kRowsQ * kQChunks; c += kThreads) {
    const int r = c / kQChunks;
    const int col = (c % kQChunks) * 8;
    const int row = q0 + r;
    const bool valid = row < p.seqlen_q;
    const __nv_bfloat16* src = qb;
    if (valid) src = col < DK ? qb + static_cast<size_t>(row) * DK + col
                              : qvb + static_cast<size_t>(row) * DV + (col - DK);
    cp_async16(qs + r * G::kQPitch + col, src, valid);
  }
  auto load_tile = [&](int j) {
    __nv_bfloat16* ks = ring + (j & 1) * G::kStage;
    __nv_bfloat16* vs = ks + BK * G::kKPitch;
    for (int c = threadIdx.x; c < BK * (DK / 8); c += kThreads) {
      const int r = c / (DK / 8);
      const int col = (c % (DK / 8)) * 8;
      const int pos = j * BK + r;
      const bool valid = pos < p.seqlen_k;
      cp_async16(ks + r * G::kKPitch + col,
                 kb + static_cast<size_t>(valid ? pos : 0) * DK + col, valid);
    }
    for (int c = threadIdx.x; c < BK * (G::kVW / 8); c += kThreads) {
      const int r = c / (G::kVW / 8);
      const int col = (c % (G::kVW / 8)) * 8;
      const int pos = j * BK + r;
      const bool valid = pos < p.seqlen_k;
      cp_async16(vs + r * G::kVPitch + col,
                 vb + static_cast<size_t>(valid ? pos : 0) * DV + col, valid);
    }
  };

  uint32_t qf[G::kQRegs ? G::kDS / 16 : 1][4];
  float acc[kChunk / 8][4];
#pragma unroll
  for (int i = 0; i < kChunk / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
  float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums

  if (n > 0) load_tile(0);
  cp_async_commit();

  const __nv_bfloat16* qa = qs + (warp * 16 + (lane & 15)) * G::kQPitch + (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);  // K (or V) rows as B fragments
  const int b_col = ((lane >> 3) & 1) * 8;
  const int v_col = QV ? chunk * kChunk : 0;  // the chunk's first column in the ring

  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = ring + (j & 1) * G::kStage;
    const __nv_bfloat16* vs = ks + BK * G::kKPitch;
    if constexpr (G::kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < G::kDS / 16; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
      }
    }

    // S = [q | qv] [k | v]^T for this warp's 16 rows x BK keys.
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kDS / 16; ++kk) {
      uint32_t a[4];
      if constexpr (G::kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, qa + kk * 16);
      }
      const bool in_k = kk < DK / 16;
      const __nv_bfloat16* src = in_k ? ks + b_row * G::kKPitch + kk * 16 + b_col
                                      : vs + b_row * G::kVPitch + (kk - DK / 16) * 16 + b_col;
      const int pitch16 = 16 * (in_k ? G::kKPitch : G::kVPitch);
#pragma unroll
      for (int nb2 = 0; nb2 < BK / 16; ++nb2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, src + nb2 * pitch16);
        mma_bf16(s[2 * nb2], a, bk[0], bk[1]);
        mma_bf16(s[2 * nb2 + 1], a, bk[2], bk[3]);
      }
    }

    // Log2-space scores (past Sk, and above the diagonal with CAUSAL, -inf),
    // the online softmax, and O += P V over this CTA's chunk of V's channels.
    const int col0 = j * BK;
    const bool masked = col0 + BK > p.seqlen_k ||
                        (CAUSAL && col0 + BK - 1 > q0 + warp * 16 + p.causal_offset);
    float mx_lo, mx_hi;
    mask_scores(s, p.scale_log2, masked, col0, lim_lo, lim_hi, mx_lo, mx_hi);
    softmax_update(s, acc, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi);
    pv_product(acc, s, vs + v_col, G::kVPitch);
    __syncthreads();  // this stage is refilled next
  }
  cp_async_wait<0>();

  float inv_lo, inv_hi, lse_lo, lse_hi;
  finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;
  store_rows(p.out + (bh * p.seqlen_q + r_lo) * DV + chunk * kChunk,
             p.out + (bh * p.seqlen_q + r_hi) * DV + chunk * kChunk, acc, inv_lo, inv_hi,
             lo_valid, hi_valid);
  if (t == 0 && chunk == 0) {
    if (lo_valid) p.lse[bh * p.seqlen_q + r_lo] = lse_lo;
    if (hi_valid) p.lse[bh * p.seqlen_q + r_hi] = lse_hi;
  }
}

template <int DK, int DV, bool QV, int WARPS, int BK>
cudaError_t launch(Params p, int batch, bool causal, cudaStream_t stream) {
  using G = Geometry<DK, DV, QV, WARPS, BK>;
  auto kernel = causal ? mla_fwd_kernel<DK, DV, QV, WARPS, BK, true>
                       : mla_fwd_kernel<DK, DV, QV, WARPS, BK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  p.qtiles = (p.seqlen_q + G::kRowsQ - 1) / G::kRowsQ;
  p.chunks = DV / kChunk;
  dim3 grid(p.qtiles, p.heads * p.chunks, batch);
  kernel<<<grid, WARPS * 32, G::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mla_fwd

// q [B, H, Sq, DK], qv [B, H, Sq, DV] or null, k [B, Hk, Sk, DK], v [B, Hk,
// Sk, DV], all bf16; out [B, H, Sq, DV] bf16, lse [B, H, Sq] fp32. Built for
// (DK, DV, qv) = (192, 128, no), (576, 512, no) and (64, 512, yes); other
// shapes return cudaErrorInvalidValue. Returns the CUDA error (0 = success).
extern "C" int lite_flash_fwd_mla(const void* q, const void* qv, const void* k,
                                  const void* v, void* out, void* lse, int batch,
                                  int heads, int kv_heads, int seqlen_q, int seqlen_k,
                                  int head_dim, int head_dim_v, float scale, int causal,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_fwd::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.qv = static_cast<const __nv_bfloat16*>(qv);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.causal_offset = seqlen_k - seqlen_q;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_qv = qv != nullptr;
  if (head_dim == 192 && head_dim_v == 128 && !has_qv) {
    err = mla_fwd::launch<192, 128, false, 8, 64>(p, batch, causal, s);
  } else if (head_dim == 576 && head_dim_v == 512 && !has_qv) {
    err = mla_fwd::launch<576, 512, false, 4, 32>(p, batch, causal, s);
  } else if (head_dim == 64 && head_dim_v == 512 && has_qv) {
    err = mla_fwd::launch<64, 512, true, 4, 32>(p, batch, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
