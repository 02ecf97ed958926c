// B7: dense flash-attention backward on Hopper, two kernels (replace the
// Pallas kernels liteattention_tpu/ops/flash_bwd.py:_dq_kernel (B7a) and
// _dkv_kernel (B7b)).
//
// Both recompute P = exp2(s * scale * log2e - lse * log2e) from the forward's
// lse, with delta = rowsum(dO * O) computed by the caller, and
// dS = P * (dP - delta) * scale. As in the JAX kernels, P and dS are rounded
// to bf16 before they feed a product; every product accumulates in fp32
// (mma.sync m16n8k16). Rows with lse -inf (no valid key) and padded rows get
// P = 0. Masks: ragged Sq / Sk and the bottom-right-aligned causal channel
// (key col valid for q row r iff col <= r + Sk - Sq).
//
// B7a, dQ: one CTA per (b, q-head, 128-row q-tile), 8 warps x 16 q rows. Q
// and dO fragments stay in registers; K and V walk in 64-key tiles through
// a two-stage cp.async ring, up to the diagonal when causal.
// B7b, dK/dV: one CTA per (b, kv-head, 128-key k-tile), 8 warps x 16 keys.
// K and V stay in shared memory; the CTA loops over the q-heads of its GQA
// group and, per head, over the 64-row Q/dO tiles from the first one that
// reaches the k-tile's diagonal. The group sum that the TPU kernel carried
// across grid steps is a loop inside one CTA here, because Hopper blocks run
// in no order: no atomics, so the gradients are the same from run to run.
//
// What bounds them on the H100: tensor-core throughput (3 and 4 products per
// tile pair, against 2 in the forward); mma.sync runs below the wgmma rate,
// and the dQ pass recomputes S and dP that the dK/dV pass also computes. A one-pass design with atomic dQ and wgmma is later work.
#include "attention_fwd.cuh"

namespace lite {
namespace bwd {

constexpr int kThreads = 256;  // 8 warps
constexpr int kDqRows = 128;   // q rows per dQ CTA
constexpr int kDqKeys = 64;    // keys per K/V tile of the dQ walk
constexpr int kDkvKeys = 128;  // keys per dK/dV CTA
constexpr int kDkvRows = 64;   // q rows per Q/dO tile of the dK/dV walk
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const __nv_bfloat16* q;     // [B, H, Sq, D]
  const __nv_bfloat16* k;     // [B, Hk, Sk, D]
  const __nv_bfloat16* v;     // [B, Hk, Sk, D]
  const __nv_bfloat16* dout;  // [B, H, Sq, D]
  const float* lse;           // [B, H, Sq], natural log
  const float* delta;         // [B, H, Sq], rowsum(dO * O)
  __nv_bfloat16* dq;          // [B, H, Sq, D]
  __nv_bfloat16* dk;          // [B, Hk, Sk, D]
  __nv_bfloat16* dv;          // [B, Hk, Sk, D]
  int heads, kv_heads, seqlen_q, seqlen_k;
  int causal_offset;  // Sk - Sq
  float scale;        // softmax scale
  float scale_log2;   // scale * log2(e)
};

// lse in log2 units. A row with no valid key (lse -inf) gets +inf, so
// exp2(s - lse2) is 0 on it: the kernel form of "p = 0 where lse is not
// finite" (flash_bwd.py:198-201).
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// cp.async rows [row0, row0 + ROWS) of a [S, D] array into a padded
// [ROWS, D + 8] shared tile; rows at or past `limit` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* base,
                                          __nv_bfloat16* dst, int row0,
                                          int limit) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  constexpr int kChunks = ROWS * kChunksPerRow;
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool valid = row0 + r < limit;
    const size_t src = static_cast<size_t>(valid ? row0 + r : 0) * D + col;
    cp_async16(dst + r * (D + 8) + col, base + src, valid);
  }
}

// A-operand fragment (16 x 16, row-major) of rows row0.. of a padded tile.
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t* a,
                                            const __nv_bfloat16* tile,
                                            int row0, int kk, int g, int t) {
  const __nv_bfloat16* p0 = tile + (row0 + g) * (D + 8) + kk * 16 + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * (D + 8);
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// acc[D/8][4] += A (16 x 16*KC, held as fp32 accumulator fragments x[2*KC][4]
// and rounded to bf16 here) times B (16*KC x D, a padded row-major shared
// tile read with ldmatrix.trans).
template <int D, int KC>
__device__ __forceinline__ void mma_acc_by_tile(float (*acc)[4],
                                                const float (*x)[4],
                                                const __nv_bfloat16* tile,
                                                int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
    const int row = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + row * (D + 8) + db * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * db], a, b[0], b[1]);
      mma_bf16(acc[2 * db + 1], a, b[2], b[3]);
    }
  }
}

// Store a warp's 16 x D fp32 accumulator as bf16 rows r_lo / r_hi.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const float (*acc)[4], int r_lo,
                                           int limit, int t) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (r_lo < limit) {
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r_lo) * D + c) =
          pack_bf16(acc[i][0], acc[i][1]);
    }
    if (r_hi < limit) {
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r_hi) * D + c) =
          pack_bf16(acc[i][2], acc[i][3]);
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return 2 * 2 * kDqKeys * (D + 8) * 2;  // two stages of (K, V)
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 2 * kDkvKeys * (D + 8) * 2       // K, V
         + 2 * 2 * kDkvRows * (D + 8) * 2  // two stages of (Q, dO)
         + 2 * 2 * kDkvRows * 4;           // two stages of (lse2, delta)
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kTileElems = kDqKeys * (D + 8);

  const int qtiles = (p.seqlen_q + kDqRows - 1) / kDqRows;
  const int ktiles = (p.seqlen_k + kDqKeys - 1) / kDqKeys;
  // Causal: the longest walks (last q-tiles) start first.
  const int qt = CAUSAL ? qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t bh = static_cast<size_t>(b) * p.heads + h;
  const size_t kvh = static_cast<size_t>(b) * p.kv_heads + hk;
  const __nv_bfloat16* kbase = p.k + kvh * p.seqlen_k * D;
  const __nv_bfloat16* vbase = p.v + kvh * p.seqlen_k * D;

  const int r_lo = qt * kDqRows + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;

  // Q and dO fragments (A operands) straight from global memory.
  uint32_t qf[D / 16][4], df[D / 16][4];
  {
    const __nv_bfloat16* q_lo = p.q + (bh * p.seqlen_q + r_lo) * D;
    const __nv_bfloat16* q_hi = p.q + (bh * p.seqlen_q + r_hi) * D;
    const __nv_bfloat16* d_lo = p.dout + (bh * p.seqlen_q + r_lo) * D;
    const __nv_bfloat16* d_hi = p.dout + (bh * p.seqlen_q + r_hi) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = c + half * 8;
        qf[kk][2 * half] = lo_valid ? *reinterpret_cast<const uint32_t*>(q_lo + cc) : 0u;
        qf[kk][2 * half + 1] = hi_valid ? *reinterpret_cast<const uint32_t*>(q_hi + cc) : 0u;
        df[kk][2 * half] = lo_valid ? *reinterpret_cast<const uint32_t*>(d_lo + cc) : 0u;
        df[kk][2 * half + 1] = hi_valid ? *reinterpret_cast<const uint32_t*>(d_hi + cc) : 0u;
      }
    }
  }
  const float l2_lo = lo_valid ? lse_log2(p.lse[bh * p.seqlen_q + r_lo]) : INFINITY;
  const float l2_hi = hi_valid ? lse_log2(p.lse[bh * p.seqlen_q + r_hi]) : INFINITY;
  const float dl_lo = lo_valid ? p.delta[bh * p.seqlen_q + r_lo] : 0.f;
  const float dl_hi = hi_valid ? p.delta[bh * p.seqlen_q + r_hi] : 0.f;

  int n_tiles = ktiles;
  if constexpr (CAUSAL) {
    const int last = qt * kDqRows + kDqRows - 1 + p.causal_offset;
    n_tiles = last < 0 ? 0 : min(ktiles, last / kDqKeys + 1);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (n_tiles > 0) {
    load_rows<D, kDqKeys>(kbase, smem, 0, p.seqlen_k);
    load_rows<D, kDqKeys>(vbase, smem + kTileElems, 0, p.seqlen_k);
  }
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + (stage ^ 1) * 2 * kTileElems;
      load_rows<D, kDqKeys>(kbase, nxt, (j + 1) * kDqKeys, p.seqlen_k);
      load_rows<D, kDqKeys>(vbase, nxt + kTileElems, (j + 1) * kDqKeys, p.seqlen_k);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* ks = smem + stage * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;

    // S = Q K^T and dP = dO V^T, this warp's 16 rows x 64 keys.
    float s[kDqKeys / 8][4], dp[kDqKeys / 8][4];
#pragma unroll
    for (int nb = 0; nb < kDqKeys / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kDqKeys / 8; ++nb) {
        const int off = (nb * 8 + g) * (D + 8) + kk * 16 + 2 * t;
        mma_bf16(s[nb], qf[kk], *reinterpret_cast<const uint32_t*>(ks + off),
                 *reinterpret_cast<const uint32_t*>(ks + off + 8));
        mma_bf16(dp[nb], df[kk], *reinterpret_cast<const uint32_t*>(vs + off),
                 *reinterpret_cast<const uint32_t*>(vs + off + 8));
      }
    }

    // dS = P * (dP - delta) * scale, with P recomputed from lse (masked
    // entries give P = 0).
    const int col0 = j * kDqKeys;
    const bool ragged = col0 + kDqKeys > p.seqlen_k;
    const bool diag =
        CAUSAL && col0 + kDqKeys - 1 > qt * kDqRows + warp * 16 + p.causal_offset;
#pragma unroll
    for (int nb = 0; nb < kDqKeys / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + nb * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        const bool masked = (ragged && col >= p.seqlen_k) ||
                            (diag && col > (lo ? r_lo : r_hi) + p.causal_offset);
        const float pv =
            masked ? 0.f : fast_exp2(s[nb][e] * p.scale_log2 - (lo ? l2_lo : l2_hi));
        s[nb][e] = pv * (dp[nb][e] - (lo ? dl_lo : dl_hi)) * p.scale;
      }
    }

    // dQ += dS K (dS's accumulator layout is the A operand).
    mma_acc_by_tile<D, kDqKeys / 16>(acc, s, ks, lane);
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  store_rows<D>(p.dq + bh * p.seqlen_q * D, acc, r_lo, p.seqlen_q, t);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kKVElems = kDkvKeys * (D + 8);
  constexpr int kQElems = kDkvRows * (D + 8);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kKVElems;
  __nv_bfloat16* qring = vs + kKVElems;  // stage s: Q at 2s, dO at 2s + 1
  float* stats = reinterpret_cast<float*>(qring + 4 * kQElems);  // [2][2][rows]

  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int k0 = kt * kDkvKeys;
  const int key_lo = k0 + warp * 16 + g;
  const int key_hi = key_lo + 8;
  const size_t kvh = static_cast<size_t>(b) * p.kv_heads + hk;
  const int qtiles = (p.seqlen_q + kDkvRows - 1) / kDkvRows;
  int q_first = 0;
  if constexpr (CAUSAL) {
    // First q-tile whose last (padded) row reaches the k-tile's first key.
    const int x = k0 - p.causal_offset;
    q_first = x < 0 ? 0 : min(qtiles, x / kDkvRows);
  }
  const int nq = qtiles - q_first;
  const int n_iter = group * nq;

  // Step `it` of the walk: q-head hk * group + it / nq, q-tile q_first + it % nq.
  auto load_step = [&](int it, int stage) {
    const size_t bhq = static_cast<size_t>(b) * p.heads + hk * group + it / nq;
    const int row0 = (q_first + it % nq) * kDkvRows;
    __nv_bfloat16* qs = qring + 2 * stage * kQElems;
    load_rows<D, kDkvRows>(p.q + bhq * p.seqlen_q * D, qs, row0, p.seqlen_q);
    load_rows<D, kDkvRows>(p.dout + bhq * p.seqlen_q * D, qs + kQElems, row0,
                           p.seqlen_q);
    float* st = stats + 2 * stage * kDkvRows;
    const int i = threadIdx.x % kDkvRows;
    const int r = row0 + i;
    if (threadIdx.x < kDkvRows) {
      st[i] = r < p.seqlen_q ? lse_log2(p.lse[bhq * p.seqlen_q + r]) : INFINITY;
    } else if (threadIdx.x < 2 * kDkvRows) {
      st[kDkvRows + i] = r < p.seqlen_q ? p.delta[bhq * p.seqlen_q + r] : 0.f;
    }
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  if (n_iter > 0) {
    load_rows<D, kDkvKeys>(p.k + kvh * p.seqlen_k * D, ks, k0, p.seqlen_k);
    load_rows<D, kDkvKeys>(p.v + kvh * p.seqlen_k * D, vs, k0, p.seqlen_k);
    load_step(0, 0);
  }
  cp_async_commit();

  const bool ragged = k0 + kDkvKeys > p.seqlen_k;
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_step(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* qs = qring + 2 * stage * kQElems;
    const __nv_bfloat16* dos = qs + kQElems;
    const float* lse2 = stats + 2 * stage * kDkvRows;
    const float* delta = lse2 + kDkvRows;
    const int row0 = (q_first + it % nq) * kDkvRows;

    // S^T = K Q^T, this warp's 16 keys x 64 q rows (K rows: A operand).
    float s[kDkvRows / 8][4];
#pragma unroll
    for (int nb = 0; nb < kDkvRows / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a_frag<D>(a, ks, warp * 16, kk, g, t);
#pragma unroll
      for (int nb = 0; nb < kDkvRows / 8; ++nb) {
        const __nv_bfloat16* qp = qs + (nb * 8 + g) * (D + 8) + kk * 16 + 2 * t;
        mma_bf16(s[nb], a, *reinterpret_cast<const uint32_t*>(qp),
                 *reinterpret_cast<const uint32_t*>(qp + 8));
      }
    }

    // P^T from lse; masked entries (key past Sk, or above the diagonal) 0.
    const bool diag = CAUSAL && k0 + warp * 16 + 15 > row0 + p.causal_offset;
#pragma unroll
    for (int nb = 0; nb < kDkvRows / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nb * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        const bool masked = (ragged && key >= p.seqlen_k) ||
                            (diag && key > row0 + qc + p.causal_offset);
        s[nb][e] = masked ? 0.f : fast_exp2(s[nb][e] * p.scale_log2 - lse2[qc]);
      }
    }

    // dV += P^T dO.
    mma_acc_by_tile<D, kDkvRows / 16>(dv, s, dos, lane);

    // dP^T = V dO^T (V rows: A operand).
    float dp[kDkvRows / 8][4];
#pragma unroll
    for (int nb = 0; nb < kDkvRows / 8; ++nb) dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a_frag<D>(a, vs, warp * 16, kk, g, t);
#pragma unroll
      for (int nb = 0; nb < kDkvRows / 8; ++nb) {
        const __nv_bfloat16* dop = dos + (nb * 8 + g) * (D + 8) + kk * 16 + 2 * t;
        mma_bf16(dp[nb], a, *reinterpret_cast<const uint32_t*>(dop),
                 *reinterpret_cast<const uint32_t*>(dop + 8));
      }
    }

    // dS^T = P^T * (dP^T - delta) * scale; dK += dS^T Q.
#pragma unroll
    for (int nb = 0; nb < kDkvRows / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nb * 8 + 2 * t + (e & 1);
        s[nb][e] = s[nb][e] * (dp[nb][e] - delta[qc]) * p.scale;
      }
    }
    mma_acc_by_tile<D, kDkvRows / 16>(dk, s, qs, lane);
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  store_rows<D>(p.dk + kvh * p.seqlen_k * D, dk, key_lo, p.seqlen_k, t);
  store_rows<D>(p.dv + kvh * p.seqlen_k * D, dv, key_lo, p.seqlen_k, t);
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.seqlen_q + kDqRows - 1) / kDqRows, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D, CAUSAL>;
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.seqlen_k + kDkvKeys - 1) / kDkvKeys, p.kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      int heads, int kv_heads, int seqlen_q, int seqlen_k,
                      float scale) {
  BwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.causal_offset = seqlen_k - seqlen_q;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

template <int D>
cudaError_t run_dq(const BwdParams& p, int batch, bool causal, cudaStream_t s) {
  return causal ? launch_dq<D, true>(p, batch, s) : launch_dq<D, false>(p, batch, s);
}

template <int D>
cudaError_t run_dkv(const BwdParams& p, int batch, bool causal, cudaStream_t s) {
  return causal ? launch_dkv<D, true>(p, batch, s) : launch_dkv<D, false>(p, batch, s);
}

}  // namespace bwd
}  // namespace lite

extern "C" int lite_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int batch,
                                 int heads, int kv_heads, int seqlen_q,
                                 int seqlen_k, int head_dim, float scale,
                                 int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lite::bwd::BwdParams p = lite::bwd::make_params(
      q, k, v, dout, lse, delta, heads, kv_heads, seqlen_q, seqlen_k, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = lite::bwd::run_dq<64>(p, batch, causal != 0, s);
  } else if (head_dim == 128) {
    err = lite::bwd::run_dq<128>(p, batch, causal != 0, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int lite_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int batch, int heads, int kv_heads,
                                  int seqlen_q, int seqlen_k, int head_dim,
                                  float scale, int causal, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lite::bwd::BwdParams p = lite::bwd::make_params(
      q, k, v, dout, lse, delta, heads, kv_heads, seqlen_q, seqlen_k, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = lite::bwd::run_dkv<64>(p, batch, causal != 0, s);
  } else if (head_dim == 128) {
    err = lite::bwd::run_dkv<128>(p, batch, causal != 0, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
