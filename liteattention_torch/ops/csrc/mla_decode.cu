// B10: absorbed MLA (multi-head latent attention) decode on Hopper, replacing
// the Pallas kernel liteattention_tpu/ops/mla.py:_mla_kernel.
//
// What it computes. Every q row attends one latent cache: K is the whole row
// of D = 576 channels and V its first DV = 512 channels, shared by all heads.
// The wrapper lays the q rows of a request out as [B, R, D] with R = Sq * Hq
// ordered r = qi * Hq + h; row r sees key col iff col < len, and with causal
// and Sq > 1 iff col < len - Sq + qi + 1 (bottom-right aligned). Scores live
// in log2 space (s * scale * log2e); the lse written out is natural log. A
// row with no valid key gives out 0 and lse -inf, never NaN.
//
// Addressing. Key position pos of request b lives at
//   kv + page * s_page + slot * s_slot   (elements, unit channel stride),
// (page, slot) = (b, pos) for a contiguous cache, (table[b, pos / page_size],
// pos % page_size) for a paged one. A cache wider than D (the TPU's 640-lane
// layout) is read through its row stride and its extra lanes are never read.
// The TPU kernel's lane padding, synthesized identity table and multi-page DMA
// runs are TPU machinery and are not carried over.
//
// Grid and work. One CTA per (KV split, 64-row block, request). A split is
// `split_keys` consecutive keys (a multiple of 64), walked in 64-key tiles --
// one 64-token page, the FlashMLA convention -- through a two-stage cp.async
// ring. Each tile is loaded ONCE into shared memory: QK^T reads all 576
// channels of it and PV the first 512 channels of the same tile, the point of
// the TPU kernel. The CTA's 64 q rows (72 KB) stay in shared memory. 8 warps:
// warp w takes rows 16 (w % 4).. and output columns 256 (w / 4)..; both warps
// of a row group compute the same 16 x 64 scores (S is recomputed once), so
// that each keeps a 16 x 256 fp32 accumulator (128 registers): a 64 x 512
// accumulator does not fit one warp, and 128 x 512 (256 KB) not one SM.
// Budget: 72 KB of q + 2 x 72 KB of ring = 219 KB of the 227 KB a CTA may use.
// With more than one split each split writes (o fp32, lse) and
// decode_merge_kernel (attention_fwd.cuh) combines them
// (ops/combine.py is its plain version); a split past a request's length
// writes lse -inf and nothing else, and the merge skips it. The softmax
// steps, P V and the epilogue are attention_fwd.cuh's row helpers.
//
// What bounds it on the H100: at Hq 128 each cache byte feeds ~242 FLOP of
// needed work (128 rows x 2 x (576 + 512) per 1152 bytes), just under the
// card's ~295 FLOP per byte, so bytes bind but the tensor cores need ~82 % of
// that time. The recomputed S adds 2 x 576 FLOP per (row, key) to the 2 x
// 1088 needed (x1.53), on mma.sync below the wgmma rate: this first version
// is bound by tensor-core issue. wgmma, TMA and sharing P between the two
// column halves through shared memory are later work.
#include "attention_fwd.cuh"

namespace mla {

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

constexpr int kD = 576;
constexpr int kDV = 512;
constexpr int kRows = 64;      // q rows per CTA
constexpr int kWarps = 8;      // 4 row groups x 2 column halves
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;     // keys per ring stage
constexpr int kCols = kDV / 2;  // output columns per warp
constexpr int kPitch = kD + 8;  // elements per shared row (odd multiple of 16 B)
constexpr int kChunks = kD / 8;  // 16-byte copies per row
constexpr int kSmem = (kRows + 2 * kTileK) * kPitch * 2;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;   // [B, R, D]
  const __nv_bfloat16* kv;  // latent cache base
  const int* table;         // [B, table_stride] page table, or null
  const int* lens;          // [B] valid keys
  __nv_bfloat16* out;       // [B, R, DV]    (splits == 1)
  float* lse;               // [B, R]        (splits == 1)
  float* o_part;            // [splits, B, R, DV]
  float* lse_part;          // [splits, B, R]
  long long s_page, s_slot;  // element strides: page (or batch), slot
  int batch, rows, hq, sq, capacity, table_stride, page_size;
  int causal, split_keys, splits;
  float scale_log2;
};

__device__ __forceinline__ int seq_len(const Params& p, int b) {
  return min(max(p.lens[b], 0), p.capacity);
}

__global__ void __launch_bounds__(kThreads, 1) mla_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kPitch]
  __nv_bfloat16* ring = qs + kRows * kPitch;                        // [2][kTileK][kPitch]

  const int split = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int len = seq_len(p, b);
  const int k0 = split * p.split_keys;
  if (p.splits > 1 && k0 >= len) {  // no keys: lse -inf, and the merge skips the split
    float* lse = p.lse_part + (static_cast<size_t>(split) * p.batch + b) * p.rows;
    for (int r = row0 + threadIdx.x; r < min(p.rows, row0 + kRows); r += kThreads) {
      lse[r] = -INFINITY;
    }
    return;
  }
  const int k1 = min(len, k0 + p.split_keys);
  const int n_tiles = k1 > k0 ? (k1 - k0 + kTileK - 1) / kTileK : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp % 4;  // row group: rows rg * 16 .. + 16 of the block
  const int half = warp / 4;  // output columns half * 256 .. + 256
  const int r_lo = row0 + rg * 16 + g;
  const int r_hi = r_lo + 8;
  auto limit = [&](int r) {
    const int lim = p.causal && p.sq > 1 ? len - p.sq + min(r / p.hq, p.sq - 1) + 1 : len;
    return min(lim, k1);
  };
  const int lim_lo = limit(r_lo);
  const int lim_hi = limit(r_hi);

  // q rows of this block (rows past R zero-fill), in the first copy group.
  const __nv_bfloat16* qb = p.q + static_cast<size_t>(b) * p.rows * kD;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < p.rows;
    cp_async16(qs + r * kPitch + col, qb + (valid ? (row0 + r) * kD + col : 0), valid);
  }
  // Copy key tile j into its ring stage (rows past k1 zero-fill, so that the
  // masked columns multiply zeros in PV, never stale bits). A tile starts on
  // a multiple of 64 keys, so with pages of a multiple of 64 tokens (or a
  // contiguous cache) it lies in one page: one table read per tile.
  const int* trow = p.table != nullptr ? p.table + static_cast<size_t>(b) * p.table_stride
                                       : nullptr;
  const bool one_page = trow == nullptr || p.page_size % kTileK == 0;
  auto key_row = [&](int pos) {
    long long page = b, slot = pos;
    if (trow != nullptr) {
      page = trow[pos / p.page_size];
      slot = pos % p.page_size;
    }
    return p.kv + page * p.s_page + slot * p.s_slot;
  };
  auto load_tile = [&](int j) {
    __nv_bfloat16* st = ring + (j & 1) * kTileK * kPitch;
    const int t0 = k0 + j * kTileK;
    const __nv_bfloat16* base = one_page ? key_row(t0) : p.kv;
    for (int c = threadIdx.x; c < kTileK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const bool valid = t0 + r < k1;
      const __nv_bfloat16* src = p.kv;
      if (valid) src = (one_page ? base + r * p.s_slot : key_row(t0 + r)) + col;
      cp_async16(st + r * kPitch + col, src, valid);
    }
  };

  float acc[kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
  float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums

  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  const __nv_bfloat16* qa = qs + (rg * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);  // K rows as B fragments
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kvs = ring + (j & 1) * kTileK * kPitch;

    // S = Q K^T for this warp's 16 rows x the 64 keys, over all D channels.
    float s[kTileK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int nb2 = 0; nb2 < kTileK / 16; ++nb2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kvs + (nb2 * 16 + b_row) * kPitch + kk * 16 + b_col);
        mma_bf16(s[2 * nb2], a, bk[0], bk[1]);
        mma_bf16(s[2 * nb2 + 1], a, bk[2], bk[3]);
      }
    }

    // Log2-space scores, columns past a row's limit -inf; the online
    // softmax; O += P V with V = the first DV channels of the SAME tile
    // (this warp's half of them).
    const int col0 = k0 + j * kTileK;
    float mx_lo, mx_hi;
    mask_scores(s, p.scale_log2, col0 + kTileK > min(lim_lo, lim_hi), col0, lim_lo, lim_hi,
                mx_lo, mx_hi);
    softmax_update(s, acc, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi);
    pv_product(acc, s, kvs + half * kCols, kPitch);
    __syncthreads();  // this stage is refilled next
  }
  cp_async_wait<0>();

  float inv_lo, inv_hi, lse_lo, lse_hi;
  finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
  const bool lo_valid = r_lo < p.rows;
  const bool hi_valid = r_hi < p.rows;
  // One split writes out and lse; more write their partials for the merge.
  const size_t row_lo = (p.splits == 1 ? 0 : static_cast<size_t>(split) * p.batch * p.rows) +
                        static_cast<size_t>(b) * p.rows + r_lo;
  const size_t row_hi = row_lo + 8;
  const int c0 = half * kCols;
  float* lse = p.lse_part;
  if (p.splits == 1) {
    store_rows(p.out + row_lo * kDV + c0, p.out + row_hi * kDV + c0, acc, inv_lo, inv_hi,
               lo_valid, hi_valid);
    lse = p.lse;
  } else {
    store_rows(p.o_part + row_lo * kDV + c0, p.o_part + row_hi * kDV + c0, acc, inv_lo, inv_hi,
               lo_valid, hi_valid);
  }
  if (t == 0 && half == 0) {
    if (lo_valid) lse[row_lo] = lse_lo;
    if (hi_valid) lse[row_hi] = lse_hi;
  }
}

}  // namespace mla

// q [B, R, D] bf16 (R = Sq * Hq rows, r = qi * Hq + h); kv the latent cache
// base with element strides (page or batch, slot); table [B, table_stride]
// int32 or null; lens [B] int32. out [B, R, DV] bf16, lse [B, R] fp32; with
// splits > 1, o_part / lse_part hold the partials of `split_keys` keys each
// and the merge runs after the main kernel. Returns the CUDA error (0 =
// success).
extern "C" int lite_mla_decode(
    const void* q, const void* kv, const void* table, const void* lens, void* out,
    void* lse, void* o_part, void* lse_part, long long s_page, long long s_slot,
    int batch, int rows, int hq, int sq, int head_dim, int head_dim_v, int capacity,
    int table_stride, int page_size, int causal, int split_keys, int splits,
    float scale, int device, void* stream) {
  if (head_dim != mla::kD || head_dim_v != mla::kDV || split_keys % mla::kTileK ||
      splits < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kv = static_cast<const __nv_bfloat16*>(kv);
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.s_page = s_page;
  p.s_slot = s_slot;
  p.batch = batch;
  p.rows = rows;
  p.hq = hq;
  p.sq = sq;
  p.capacity = capacity;
  p.table_stride = table_stride;
  p.page_size = page_size;
  p.causal = causal;
  p.split_keys = split_keys;
  p.splits = splits;
  p.scale_log2 = scale * mla::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(mla::mla_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, mla::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(splits, (rows + mla::kRows - 1) / mla::kRows, batch);
  mla::mla_decode_kernel<<<grid, mla::kThreads, mla::kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  lite::decode_merge_kernel<mla::kDV><<<batch * rows, mla::kDV, 0, s>>>(
      p.o_part, p.lse_part, p.out, p.lse, splits, batch * rows);
  return static_cast<int>(cudaGetLastError());
}
