// B8 / B9a / B9b: split-KV decode attention on Hopper. One kernel serves the
// three Pallas kernels it replaces:
//   liteattention_tpu/ops/flash_fwd.py:_decode_folded_kernel       (B8, contiguous cache)
//   liteattention_tpu/ops/paged_attention.py:_paged_kernel         (B9a, head-major pools)
//   liteattention_tpu/ops/paged_attention.py:_paged_folded_kernel  (B9b, native pools)
// They compute one function: a few q rows per KV head against a cache that is
// reached by strides or through a page table. The TPU kernels' block-diagonal
// q pack, 128-lane padding and pages-per-step DMA batching are TPU machinery
// and are not carried over.
//
// Rows. The wrapper packs the q rows of one KV head as [B, Hk, R, D] with
// R = sq * group ordered (qi, g), so row r is query position r / group.
// Row r sees key col iff low <= col < bound and, when causal,
// col < bound + causal_off + r / group (bottom-right: causal_off = 1 - sq).
//
// Addressing. Key position pos of (b, kv-head h) lives at
//   base + page * s_page + slot * s_slot + h * s_head   (elements),
// with (page, slot) = (b, pos) for a contiguous cache in either layout and
// (table[b, pos / page_size], pos % page_size) for a paged one. The channel
// stride is 1. No cache is ever transposed or copied.
//
// Grid and work. One CTA per (16-row tile, KV split, b * Hk + h). Its key
// range [k0, k1) is its split's share of [low, the tile's last row's bound),
// walked in key tiles through a three-stage cp.async ring (16-byte copies):
// 64 keys of bf16 or 128 keys of int8, so every stage moves the same bytes.
// The 4 warps each take a quarter of every tile and keep their own online
// softmax over the CTA's 16 rows (mma.sync m16n8k16, bf16 in, fp32
// accumulate); at the end the warps merge through shared memory. With more
// than one split, each split writes (o fp32, lse) and decode_merge_kernel
// (attention_fwd.cuh) combines them (ops/combine.py is its plain version). A
// split or a row with no valid key gives weight 0 / out 0 and lse -inf, never
// NaN.
//
// int8 caches: the ring holds the int8 rows (half the bytes of bf16), and
// the values become bf16 (exactly: |x| <= 127) in registers as the mma
// fragments are built, with no second pass over shared memory. The
// per-channel scales are folded outside the kernel by the wrapper (q *
// k_scale before, out * v_scale after), exactly as the JAX package does.
//
// What bounds it on the H100: bytes. Each cache byte feeds about 8 FLOP of
// useful work (4 rows x D products for 2 D bytes), far below the card's ~295
// FLOP per byte, so the kernel is a stream over the cache. The design keeps
// bytes in flight: 16-byte coalesced copies, three stages per CTA, two CTAs
// per SM, and enough splits that the grid fills both CTA slots of the 132
// SMs even at b * Hk = 64. mma.sync with the rows padded to 16 is cheaper in
// issue slots than FMA dot products and stays far from the tensor-core
// limit; wgmma and TMA are later work.
#include "attention_fwd.cuh"

namespace decode {

using lite::cp_async16;
using lite::cp_async_commit;
using lite::cp_async_wait;
using lite::ldmatrix_x4_trans;
using lite::mma_bf16;
using lite::p_operand;
using lite::pack_bf16;
using lite::softmax_update;

constexpr int kRows = 16;  // q rows per CTA (one mma row tile)
constexpr int kWarps = 4;  // a quarter of every key tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;  // [B, Hk, R, D] packed rows
  const void* k;           // cache base (bf16 or int8)
  const void* v;
  const int* table;  // [B, table_stride] page table, or null (contiguous)
  const int* bound;  // [B] total valid length
  const int* low;    // [B] first valid key, or null
  __nv_bfloat16* out;  // [B, Hk, R, D]   (splits == 1)
  float* lse;          // [B, Hk, R]      (splits == 1)
  float* o_part;       // [splits, B, Hk, R, D]
  float* lse_part;     // [splits, B, Hk, R]
  long long k_sp, k_ss, k_sh;  // element strides: page (or batch), slot, head
  long long v_sp, v_ss, v_sh;
  int kv_heads, rows, group, capacity;
  int table_stride, page_size;
  int causal, causal_off, splits;
  float scale_log2;      // scale * log2(e)
  float softcap;         // 0: off
  float scale_over_cap;  // scale / softcap
};

// Keys per stage: 64 bf16 or 128 int8 rows, the same bytes either way.
template <typename T>
constexpr int kTileKeys = sizeof(T) == 1 ? 128 : 64;

template <int D, typename T>
constexpr int smem_bytes() {
  constexpr int ring = kStages * 2 * kTileKeys<T> * (D * (int)sizeof(T) + 16);
  constexpr int merge = (kWarps * kRows * D + 2 * kWarps * kRows) * 4;
  return ring > merge ? ring : merge;
}

// Two int8 values (the low 16 bits of v, lower address first) as bf16x2,
// exactly: x + 128 goes into the mantissa of 2^23 and the float subtraction
// of 2^23 + 128 leaves x, with no integer-to-float conversion.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t v) {
  const uint32_t u = v ^ 0x8080u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | ((u >> 8) & 0xFFu)) - 8388736.f;
  return pack_bf16(lo, hi);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Params p) {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kTileK = kTileKeys<T>;
  constexpr int kKeysW = kTileK / kWarps;        // keys of a tile per warp
  constexpr int kNb = kKeysW / 8;                // 8-key score blocks per warp
  constexpr int kRowBytes = D * (int)sizeof(T);  // one cache row
  constexpr int kChunks = kRowBytes / 16;        // 16-byte copies per row
  constexpr int kRingPitch = kRowBytes + 16;     // bytes per ring row (padded)
  constexpr int kPitch = kRingPitch / (int)sizeof(T);  // elements per ring row
  constexpr int kStageBytes = 2 * kTileK * kRingPitch;
  extern __shared__ __align__(16) unsigned char smem[];

  const int rt = blockIdx.x;
  const int split = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / p.kv_heads;
  const int h = bh % p.kv_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // Key range of this CTA: its split's share of [low, hi), where hi is the
  // bound of the tile's last row, cut into whole key tiles.
  const int bound = p.bound[b];
  const int lo = p.low != nullptr ? max(p.low[b], 0) : 0;
  auto row_limit = [&](int r) {
    return min(p.causal ? bound + p.causal_off + r / p.group : bound, p.capacity);
  };
  const int hi = row_limit(min(p.rows, (rt + 1) * kRows) - 1);
  int per = (max(hi - lo, 0) + p.splits - 1) / p.splits;
  per = (per + kTileK - 1) / kTileK * kTileK;
  const int k0 = lo + split * per;
  const int k1 = min(hi, k0 + per);
  const int n_tiles = k1 > k0 ? (k1 - k0 + kTileK - 1) / kTileK : 0;

  const int r_lo = rt * kRows + g;
  const int r_hi = r_lo + 8;
  const bool lo_valid = r_lo < p.rows;
  const bool hi_valid = r_hi < p.rows;
  const int lim_lo = min(row_limit(r_lo), k1);
  const int lim_hi = min(row_limit(r_hi), k1);

  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* q_lo = p.q + (static_cast<size_t>(bh) * p.rows + r_lo) * D;
    const __nv_bfloat16* q_hi = p.q + (static_cast<size_t>(bh) * p.rows + r_hi) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = lo_valid ? *reinterpret_cast<const uint32_t*>(q_lo + c) : 0u;
      qf[kk][1] = hi_valid ? *reinterpret_cast<const uint32_t*>(q_hi + c) : 0u;
      qf[kk][2] = lo_valid ? *reinterpret_cast<const uint32_t*>(q_lo + c + 8) : 0u;
      qf[kk][3] = hi_valid ? *reinterpret_cast<const uint32_t*>(q_hi + c + 8) : 0u;
    }
  }

  // Copy key tile j of K and V into its ring stage (rows past k1 zero-fill).
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v);
  auto load_tile = [&](int j) {
    unsigned char* kst = smem + (j % kStages) * kStageBytes;
    unsigned char* vst = kst + kTileK * kRingPitch;
    const int t0 = k0 + j * kTileK;
    for (int c = threadIdx.x; c < kTileK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int off = (c % kChunks) * 16;
      const int pos = t0 + r;
      const bool valid = pos < k1;
      const unsigned char* ksrc = kbase;
      const unsigned char* vsrc = vbase;
      if (valid) {
        long long page = b, slot = pos;
        if (p.table != nullptr) {
          page = p.table[static_cast<size_t>(b) * p.table_stride + pos / p.page_size];
          slot = pos % p.page_size;
        }
        ksrc += (page * p.k_sp + slot * p.k_ss + h * p.k_sh) * (long long)sizeof(T) + off;
        vsrc += (page * p.v_sp + slot * p.v_ss + h * p.v_sh) * (long long)sizeof(T) + off;
      }
      cp_async16(kst + r * kRingPitch + off, ksrc, valid);
      cp_async16(vst + r * kRingPitch + off, vsrc, valid);
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
  float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums
  const int kw = warp * kKeysW;              // this warp's keys in a tile

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const T* ks = reinterpret_cast<const T*>(smem + (j % kStages) * kStageBytes);
    const T* vs = ks + kTileK * kPitch;

    // S = Q K^T for the 16 rows x this warp's keys (int8 K becomes bf16 in
    // the B fragments).
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        const T* kp = ks + (kw + nb * 8 + g) * kPitch + kk * 16 + 2 * t;
        if constexpr (kInt8) {
          mma_bf16(s[nb], qf[kk], i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(kp)),
                   i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(kp + 8)));
        } else {
          mma_bf16(s[nb], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
    }

    // Log2-space scores (softcap: cap * tanh(s * scale / cap)); masked -inf.
    const int col0 = k0 + j * kTileK + kw;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e];
        x = p.softcap > 0.f ? p.softcap * kLog2e * tanhf(x * p.scale_over_cap)
                            : x * p.scale_log2;
        const int col = col0 + nb * 8 + 2 * t + (e & 1);
        if (col >= (e < 2 ? lim_lo : lim_hi)) x = -INFINITY;
        s[nb][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nb][0], s[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nb][2], s[nb][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));

    // Online softmax update of this warp's state.
    softmax_update(s, acc, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi);

    // O += P V over this warp's keys, 16 at a time: P's accumulator layout
    // is the A operand; the B fragments of V^T come by ldmatrix.trans
    // (bf16) or byte loads made bf16 in registers (int8).
#pragma unroll
    for (int sb = 0; sb < kNb / 2; ++sb) {
      uint32_t a[4];
      p_operand(s, sb, a);
      const int key0 = kw + sb * 16;
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t bfrag[4];
        if constexpr (kInt8) {
          const uint8_t* vp = reinterpret_cast<const uint8_t*>(vs) +
                              (key0 + 2 * t) * kRingPitch + db * 16 + g;
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {  // columns db*16 + h8*8 + g
            const uint8_t* c = vp + h8 * 8;
            bfrag[2 * h8] = i8x2_to_bf16x2(c[0] | (c[kRingPitch] << 8));
            bfrag[2 * h8 + 1] = i8x2_to_bf16x2(c[8 * kRingPitch] | (c[9 * kRingPitch] << 8));
          }
        } else {
          const int key = key0 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(bfrag, vs + key * kPitch + db * 16 + (lane >> 4) * 8);
        }
        mma_bf16(acc[2 * db], a, bfrag[0], bfrag[1]);
        mma_bf16(acc[2 * db + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // this stage is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // Merge the 4 warps' states through shared memory.
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  float* sm_acc = reinterpret_cast<float*>(smem);  // [kWarps][kRows][D]
  float* sm_m = sm_acc + kWarps * kRows * D;       // [kWarps][kRows]
  float* sm_l = sm_m + kWarps * kRows;
  float* my_lo = sm_acc + (warp * kRows + g) * D;
  float* my_hi = my_lo + 8 * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
    my_lo[c] = acc[i][0];
    my_lo[c + 1] = acc[i][1];
    my_hi[c] = acc[i][2];
    my_hi[c + 1] = acc[i][3];
  }
  if (t == 0) {
    sm_m[warp * kRows + g] = m_lo;
    sm_m[warp * kRows + g + 8] = m_hi;
    sm_l[warp * kRows + g] = l_lo;
    sm_l[warp * kRows + g + 8] = l_hi;
  }
  __syncthreads();

  const size_t n_rows = static_cast<size_t>(gridDim.z) * p.rows;
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    const int row = rt * kRows + r;
    if (row >= p.rows) break;  // rows grow with e
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kRows + r]);
    float l = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float sc = exp2f(sm_m[w * kRows + r] - mx);
        l += sm_l[w * kRows + r] * sc;
        o += sm_acc[(w * kRows + r) * D + d] * sc;
      }
    }
    const bool empty = !(l > 0.f);
    const float val = empty ? 0.f : o / l;
    const float lse = empty ? -INFINITY : mx * kLn2 + logf(l);
    const size_t idx = static_cast<size_t>(bh) * p.rows + row;
    if (p.splits == 1) {
      p.out[idx * D + d] = __float2bfloat16_rn(val);
      if (d == 0) p.lse[idx] = lse;
    } else {
      const size_t pidx = static_cast<size_t>(split) * n_rows + idx;
      p.o_part[pidx * D + d] = val;
      if (d == 0) p.lse_part[pidx] = lse;
    }
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<D, T>;
  constexpr int smem = smem_bytes<D, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.rows + kRows - 1) / kRows, p.splits, batch * p.kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int n_rows = batch * p.kv_heads * p.rows;
  lite::decode_merge_kernel<D><<<n_rows, D, 0, stream>>>(p.o_part, p.lse_part, p.out, p.lse,
                                                   p.splits, n_rows);
  return cudaGetLastError();
}

}  // namespace decode

// q [B, Hk, R, D] bf16; k/v cache bases (bf16, or int8 when int8 != 0) with
// element strides (page, slot, head); table [B, table_stride] int32 or null;
// bound/low [B] int32 (low may be null). out [B, Hk, R, D] bf16, lse
// [B, Hk, R] fp32; with splits > 1 o_part/lse_part hold the partials and the
// merge kernel runs after the main one. Returns the CUDA error (0 = success).
extern "C" int lite_flash_decode(
    const void* q, const void* k, const void* v, const void* table,
    const void* bound, const void* low, void* out, void* lse, void* o_part,
    void* lse_part, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, int batch, int kv_heads,
    int rows, int group, int head_dim, int capacity, int table_stride,
    int page_size, int causal, int causal_off, int splits, int int8,
    float scale, float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.table = static_cast<const int*>(table);
  p.bound = static_cast<const int*>(bound);
  p.low = static_cast<const int*>(low);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.k_sp = k_sp;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sp = v_sp;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.kv_heads = kv_heads;
  p.rows = rows;
  p.group = group;
  p.capacity = capacity;
  p.table_stride = table_stride;
  p.page_size = page_size;
  p.causal = causal;
  p.causal_off = causal_off;
  p.splits = splits;
  p.scale_log2 = scale * decode::kLog2e;
  p.softcap = softcap;
  p.scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = int8 ? decode::launch<64, int8_t>(p, batch, s)
               : decode::launch<64, __nv_bfloat16>(p, batch, s);
  } else if (head_dim == 128) {
    err = int8 ? decode::launch<128, int8_t>(p, batch, s)
               : decode::launch<128, __nv_bfloat16>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
