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
// What bounds it on the H100: bytes. Each cache byte feeds about 8 FLOP of
// useful work (4 rows x D products for 2 D bytes), far below the card's ~295
// FLOP per byte, so the kernel is a stream over the cache. The design:
//
// * One CTA per SM, 8 warps (two per SM sub-partition, 255 registers each:
//   with a ninth, producer warp ptxas caps them at 168 and spills). Each
//   warp takes 16 keys of every 128-key tile and keeps its own online
//   softmax over the unit's 16 q rows.
// * Loads by TMA into an mbarrier ring (3 stages of bf16, 6 of int8: 192 KB
//   at D 128). The cache is one 4-D tensor map, (channel, slot, head, page
//   or batch) in the order of its strides, so a contiguous cache, a native
//   pool and a head-major pool share one load. Warp 0's lanes issue each K
//   and V tile as boxes that never cross a page (one box per page where
//   pages are smaller than a tile, the lanes looking the pages up in
//   parallel), refilling tile i - 1's stage with tile i + 2 at the top of
//   step i; the next tile's geometry and pages are read while the ring is
//   full. Boxes wholly outside a unit's keys are not loaded; each warp
//   zeroes the V rows outside the keys of the tiles at a unit's edge, so
//   that stale or uninitialised rows never reach P V (P is 0 there, but
//   0 x NaN is not).
// * Splits balanced over the keys actually present, with no host sync. A
//   unit is one (b, kv head, 16-row tile); its keys run from low to the
//   bound of its last row, in key tiles aligned to absolute positions. Every
//   CTA derives the tile count of every unit from bound/low (a prefix over
//   the (b, row tile) pairs in shared memory, with each pair's key range)
//   and takes the c-th of G equal chunks of the flat sequence of all units'
//   tiles. G is the grid rounded down to a whole multiple of the units (at
//   uniform lengths a unit then splits evenly, or not at all: a split costs
//   a merge, and 64 CTAs of one unit each already stream 2.7 TB/s on the
//   H100), at least one per unit and min_tiles tiles each. A chunk may span
//   units and a unit chunks; the ring runs across unit boundaries.
// * The merge folded in. A unit whose tiles all lie in one chunk writes out
//   and lse directly. Otherwise each piece writes (o fp32, lse) to its slot
//   (unit + chunk, unique) and thread 0 adds its tile count to the unit's
//   ticket (a release atomic after a CTA barrier); the answer is read after
//   the walk, so the atomic's round trip stays off it (a chunk holds at most
//   two pieces, its first and last unit's). The piece that completes the
//   count merges every piece of the unit into out and lse (weights per row
//   in shared memory, every piece's loads in flight together) and puts the
//   ticket back to 0 for the next launch (the wrapper keeps the ticket
//   buffer per device and stream, so no memset runs per call). A split or
//   a row with no valid key gives weight 0 / out 0 and lse -inf, never NaN;
//   a unit with no key at all is written by CTA (pair % grid).
//
// Products: mma.sync m16n8k16 (bf16 in, fp32 accumulate), the 16 q rows of
// a unit padded from the 4 real ones at the API shape: at 4 real rows
// wgmma's 64-row minimum would only add issue slots to a stream bound by
// bytes. At a unit's end the warps merge through the stage they just read
// (8 x 16 rows x D fp32 is one bf16 stage; int8 stages hold half, so int8
// merges rows 0-7, then 8-15 where they exist), the scratch columns swizzled
// by row against bank conflicts. O is rescaled only when a row's max moved.
// Tiles are stored with TMA's 128-byte swizzle (64-byte for 64-byte rows),
// which keeps the fragment reads free of bank conflicts. S = Q K^T reads K
// with the channels of each 16-wide step permuted (logical k pairs 2t,
// 2t + 8 are channels 4t .. 4t + 3, and q is loaded the same way), so one
// 8-byte (bf16) or 4-byte (int8) load gives both B fragments.
//
// Head dim 256 (GPT-J-6B): a 128-key bf16 stage would be 128 KB, so the
// tiles are 64 keys (8 per warp) and the ring keeps its 192 KB (3 stages of
// 64 KB in bf16, 6 of 32 KB in int8). P V takes one m16n8k8 step a tile
// (mma_bf16_k8: the warp's 8 scores are its A operand). The merge scratch
// no longer fits one stage: the warps' 16 rows x 256 fp32 merge in two
// rounds of 8 rows through a bf16 stage and four of 4 through an int8 one
// (Layout::kMergeRows). O is 128 registers a thread; q's fragments (64
// more) sit in shared memory in fragment order, one 16-byte read a lane a
// k-step (Layout::qs: in registers ptxas spilled ~350 bytes a thread).
//
// int8 caches: the ring holds the int8 rows (half the bytes of bf16), and
// the values become bf16 (exactly: |x| <= 127) in registers as the mma
// fragments are built, with no second pass over shared memory: a byte
// permute puts x + 128 into the mantissa of 2^23 and one float subtraction
// leaves x. For P V the output channels of each n-block are permuted (block
// 4 q + r, column n is channel 4 (n + 8 q) + r), so that one 4-byte load of
// a V row feeds four blocks. The per-channel scales are folded outside the
// kernel by the wrapper (q * k_scale before, out * v_scale after), exactly
// as the JAX package does.
//
// int8_mma (Q8; the JAX kernels' int8_mma, int8 caches only): the wrapper
// quantizes each packed q row to int8 on the device as JAX does (after the
// k_scale fold, scale max(|q|, 1e-30) / 127, round half to even), and S =
// Q K^T runs as mma.sync m16n8k32 s8 x s8 -> s32 on the int8 K rows as they
// sit in the ring, with no conversion; the int32 score (exact: |s| <= 127 x
// 127 x D < 2^24) becomes fp32 and takes the row's scale. Each 32-wide step
// reads K with the channels permuted (logical k 4t .. 4t + 3 and 16 + 4t ..
// 16 + 4t + 3 are channels 8t .. 8t + 7, q loaded the same way), one 8-byte
// load a key. P V stays on the dequant path in bf16, as in JAX (quantizing P
// is unbounded on diffuse rows). q's int8 fragments take half the registers
// of bf16 ones (at D 256, half the shared memory).
//
// Head dims 80 (Pythia) and 96 (GPT-NeoX-20B): two-atom rows, as in B1 at
// these dims. A stored row is kDp = 128 channels (Layout): two 128-byte
// atoms of bf16 or one of int8. The tensor maps' inner extent is D, so TMA
// fills the rest of the row with zeros, and the tile, the ring, the
// swizzle and the merge scratch are D 128's. S = Q K^T runs D / 16 k-steps
// (5 or 6) and P V D / 8 n-blocks (10 or 12). No product reads the padding
// but P V over int8 at D 80, whose permuted n-blocks (block 4 q + r holds
// channels 32 q + 4 n + r) take 12 blocks, two of them half padding, never
// written out. The merge scratch keeps D 128's pitch of 128 floats a row
// (scratch_col's XOR stays inside it), and the merge of a split unit's
// pieces covers D with kThreads / D whole rows a pass. int8_mma is not
// built at 80 or 96: JAX's asserts d % 128 == 0.
//
// cache_batch_idx (IDX; contiguous bf16 caches): batch row b of q reads the
// cache's row batch_idx[b], read by warp 0 as it enters each unit's tiles and
// used as the TMA batch coordinate: the cache is read in place, never
// gathered. A template flag, since the read alone cost the kernel without it
// 4-8 registers (254 -> 250 at D 128, 198 -> 206 at D 64).
#include <numeric>

#include "attention_fwd.cuh"
#include "sm90.cuh"

namespace decode {

using lite::ldmatrix_x4_trans;
using lite::mask_scores;
using lite::mma_bf16;
using lite::p_operand;
using lite::pack_bf16;
using lite::rescale_rows;
using lite::softmax_rows;

constexpr int kRows = 16;   // q rows per unit (one mma row tile)
constexpr int kWarps = 8;   // an eighth of every key tile each; warp 0 also feeds the ring
constexpr int kThreads = kWarps * 32;
constexpr int kMergeBar = 1;  // named barrier of the merges
constexpr int kMaxPieces = 512;  // pieces of one unit: the grid's most chunks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;  // [B, Hk, R, D] packed rows
  const int* table;        // [B, table_stride] page table, or null (contiguous)
  const int* bound;        // [B] total valid length
  const int* low;          // [B] first valid key, or null
  __nv_bfloat16* out;      // [B, Hk, R, D]
  float* lse;              // [B, Hk, R]
  float* o_part;           // [units + grid][kRows][D] pieces of split units
  float* lse_part;         // [units + grid][kRows]
  int* tickets;            // [units] tiles done per unit; 0 between launches
  int batch, kv_heads, rows, rtiles, group, capacity;
  int table_stride, page_size, num_pages, box;  // box: rows per TMA box (divides the tile)
  int causal, causal_off, min_tiles;
  int k_dims, v_dims;  // tensor-map dim (1-3) of slot, head, page: 2 bits each
  float scale_log2;    // scale * log2(e)
  float softcap;       // 0: off
  float scale_over_cap;  // scale / softcap
  const int* batch_idx;  // [B] the cache's batch row of each q batch row, or null (b)
  const float* q_scale;  // [B, Hk, R] q's row scales with Q8 (q is int8), else null
};

constexpr int kTileKeys = 128;  // keys per ring tile: 16 per warp (64 at D 256: 8 per warp)

// Shared memory (byte offsets from a 1024-byte aligned base). A tile of kT
// rows is stored as atoms of kT rows x kAtom bytes (128, or 64 for 64-byte
// rows) in TMA's swizzle; a bf16 row of D 128 spans two atoms, of D 256
// four. At D 80 and 96 a row is stored as kDp = 128 channels, TMA's zeros
// past D, so the layout is D 128's.
template <int D, typename T>
struct Layout {
  static constexpr int kStages = sizeof(T) == 1 ? 6 : 3;  // a ring of 192 KB at D 128 and 256
  static constexpr int kT = D == 256 ? 64 : kTileKeys;
  static constexpr int kDp = D == 80 || D == 96 ? 128 : D;  // channels of a stored row
  static constexpr int kRowBytes = kDp * static_cast<int>(sizeof(T));
  static constexpr int kAtom = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kTile = kT * kRowBytes;  // one K or V tile
  static constexpr int kStage = 2 * kTile;      // K, then V
  static constexpr int bars = kStages * kStage;  // full[kStages], empty[kStages]
  static constexpr int ml = bars + 2 * kStages * 8;  // per warp: m[kRows], l[kRows]
  static constexpr int flag = ml + kWarps * 2 * kRows * 4;
  // D 256: q's fragments of the unit being walked, [D / 16][32 lanes] x 16
  // bytes (in registers they took 64 a thread beside O's 128, and spilled).
  static constexpr bool kQShared = D == 256;
  static constexpr int qs = flag + 16;
  static constexpr int prefix = qs + (kQShared ? D / 16 * 32 * 16 : 0);  // [pairs + 1] tiles
                                // before each pair, then [pairs][3] their lo, hi and bound
  // Accumulator rows of every warp that one stage holds (rows of kDp
  // floats): the merge runs in kRows / kMergeRows rounds (one at D <= 128
  // in bf16, two in int8; two and four at D 256).
  static constexpr int kMergeRows = kStage / (kWarps * kDp * 4);
  static_assert(kMergeRows == 4 || kMergeRows == 8 || kMergeRows == kRows,
                "a stage holds 4, 8 or 16 rows of the warps' accumulators");
  static_assert((kMaxPieces + 1) * kRows * 4 <= kStages * kStage, "the ring holds the weights");
};

// Byte offset of byte `byte` of row `row` in a swizzled tile.
template <int D, typename T>
__device__ __forceinline__ int tile_off(int row, int byte) {
  using L = Layout<D, T>;
  const int atom = byte / L::kAtom;
  const int lin = row * L::kAtom + byte % L::kAtom;
  const int swz = (lin >> 7) & (L::kAtom == 128 ? 7 : 3);
  return atom * (L::kT * L::kAtom) + (lin ^ (swz << 4));
}

// Column `col` of row `row` of the warps' accumulators in the merge scratch:
// pairs of columns XOR-ed with the row, so that a warp's stores of its
// rows (8 rows, 4 column pairs at once) hit each bank pair twice, not eight
// times.
__device__ __forceinline__ int scratch_col(int row, int col) {
  return ((col >> 1) ^ ((row & 7) << 2)) << 1 | (col & 1);
}

// Byte `r` of u (int8 values already XORed with 0x80) as a float, exactly.
__device__ __forceinline__ float i8_byte(uint32_t u, int r) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | r)) - 8388736.f;
}

// The limit of row r: keys col < limit are visible (with low <= col).
__device__ __forceinline__ int row_limit(const Params& p, int bound, int r) {
  return min(p.causal ? bound + p.causal_off + r / p.group : bound, p.capacity);
}

// Keys [lo, hi) of pair (b, rt), the bound of batch row b, and its key
// tiles (aligned to absolute positions): n of them from tile lo / kT.
template <int KT>
__device__ __forceinline__ int pair_range(const Params& p, int pair, int& lo, int& hi,
                                          int& bound) {
  const int b = pair / p.rtiles;
  const int rt = pair % p.rtiles;
  bound = p.bound[b];
  lo = p.low != nullptr ? max(p.low[b], 0) : 0;
  hi = row_limit(p, bound, min(p.rows, (rt + 1) * kRows) - 1);
  return hi > lo ? (hi + KT - 1) / KT - lo / KT : 0;
}

// Position in the flat sequence of all units' tiles: unit (pair, h), tile j
// of its n. Units run pair by pair, the KV heads of a pair in turn.
struct Cursor {
  int pair, h, j, n;

  __device__ __forceinline__ int tiles(const int* prefix, int kv_heads, int pr) const {
    return (prefix[pr + 1] - prefix[pr]) / kv_heads;
  }

  // The position of flat tile x < total (prefix[pairs]).
  __device__ __forceinline__ void seek(const int* prefix, int pairs, int kv_heads, int x) {
    int a = 0, z = pairs - 1;  // the last pair with prefix <= x: it holds x
    while (a < z) {
      const int mid = (a + z + 1) / 2;
      if (prefix[mid] <= x) a = mid; else z = mid - 1;
    }
    pair = a;
    n = tiles(prefix, kv_heads, a);
    const int off = x - prefix[a];
    h = off / n;
    j = off % n;
  }

  // The next flat tile (there must be one).
  __device__ __forceinline__ void next(const int* prefix, int kv_heads) {
    if (++j < n) return;
    j = 0;
    if (++h < kv_heads) return;
    h = 0;
    do {
      n = tiles(prefix, kv_heads, ++pair);
    } while (n == 0);
  }
};

// c += A B, mma.sync m16n8k32 (s8 in, s32 accumulate): a0 / a1 hold row g /
// g + 8 of A at k 4 t .. 4 t + 3, a2 / a3 at k 16 + 4 t .., b0 / b1 B at k 4 t
// .. and 16 + 4 t .. of column g.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tensor-map coordinate `which` (1-3) of (slot, head, page) under `dims`.
__device__ __forceinline__ int coord(int dims, int which, int slot, int head, int page) {
  return (dims & 3) == which ? slot : ((dims >> 2) & 3) == which ? head : page;
}

template <int D, typename T, bool Q8 = false, bool IDX = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128 || D == 256,
                "head dim must be 64, 80, 96, 128 or 256");
  using L = Layout<D, T>;
  constexpr bool kInt8 = sizeof(T) == 1;
  static_assert(!Q8 || kInt8, "int8_mma reads int8 caches");
  static_assert(!Q8 || L::kDp == D, "int8_mma at D 64, 128 and 256");
  static_assert(!IDX || !kInt8, "cache_batch_idx reads bf16 caches");
  constexpr int kKStep = Q8 ? 32 : 16;  // channels of one S product step
  constexpr int kT = L::kT;
  constexpr int kStages = L::kStages;
  constexpr int kMergeRows = L::kMergeRows;  // accumulator rows a stage holds
  constexpr int kKeysW = kT / kWarps;  // keys of a tile per warp
  constexpr int kNb = kKeysW / 8;      // 8-key score blocks per warp
  constexpr int kDp = L::kDp;          // the merge scratch's row pitch
  // O's n-blocks: D / 8, but int8 P V takes blocks of 32 channels at once
  // (12 at D 80: channels 80-95 are padding, never written out).
  constexpr int kAccN = kInt8 ? (D + 31) / 32 * 4 : D / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  float* sm_ml = reinterpret_cast<float*>(smem + L::ml);
  int* sm_flag = reinterpret_cast<int*>(smem + L::flag);
  int* prefix = reinterpret_cast<int*>(smem + L::prefix);
  const int pairs = p.batch * p.rtiles;
  int* ranges = prefix + pairs + 1;
  __shared__ int warp_sums[kWarps];

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int hk = p.kv_heads;

  // The prefix of the tiles of every pair's units, over all threads.
  {
    const int per = (pairs + kThreads - 1) / kThreads;
    const int i0 = min(pairs, tid * per);
    const int i1 = min(pairs, i0 + per);
    int local = 0;
    for (int i = i0; i < i1; ++i) {
      int* r = ranges + 3 * i;
      local += pair_range<kT>(p, i, r[0], r[1], r[2]) * hk;
    }
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    if (tid == 0) {
      lite::sm90::prefetch_tensormap(&tm_k);
      lite::sm90::prefetch_tensormap(&tm_v);
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        lite::sm90::mbar_init(&full[s], 1);
        lite::sm90::mbar_init(&empty[s], kWarps);
      }
      lite::sm90::mbar_fence_init();
    }
    __syncthreads();
    int run = incl - local;
    for (int w = 0; w < warp; ++w) run += warp_sums[w];
    for (int i = i0; i < i1; ++i) {
      prefix[i] = run;
      const int* r = ranges + 3 * i;
      if (r[1] > r[0]) run += ((r[1] + kT - 1) / kT - r[0] / kT) * hk;
    }
    if (tid == kThreads - 1) prefix[pairs] = run;
    __syncthreads();
  }
  const int total = prefix[pairs];
  // Chunks: the grid's CTAs in whole multiples of the units (at uniform
  // lengths a unit then splits evenly, or not at all), at least one per
  // unit, at least min_tiles tiles each.
  const int units = pairs * hk;
  const int grid = gridDim.x;
  const int chunks = min(units > grid ? grid : units * (grid / units),
                         max(units, total / p.min_tiles));
  const int c = blockIdx.x;
  const int x0 = c < chunks ? static_cast<int>(static_cast<long long>(c) * total / chunks) : 0;
  const int x1 = c < chunks ? static_cast<int>(static_cast<long long>(c + 1) * total / chunks) : 0;

  // The loads: warp 0's lanes issue K and V of the chunk's tiles in order,
  // one box each (several where pages are smaller than a tile), kStages
  // ahead of the walk. The next tile's unit geometry and each lane's page
  // are read right after the previous tile's boxes are issued, while the
  // ring is full, so no global load sits between a freed stage and its
  // loads.
  const int nbox = kT / p.box;
  const uint32_t box_bytes = p.box * L::kAtom;
  Cursor feed{};
  int fed = x0;  // the next flat tile to load
  int f_pair = -1, f_lo = 0, f_hi = 0, f_b = 0, f_page = 0;
  auto fetch = [&]() {
    if (feed.pair != f_pair) {
      f_pair = feed.pair;
      f_lo = ranges[3 * f_pair];
      f_hi = ranges[3 * f_pair + 1];
      f_b = f_pair / p.rtiles;
      if constexpr (IDX) f_b = p.batch_idx[f_b];  // the cache's row (no page table)
    }
    const int pos = (f_lo / kT + feed.j) * kT + lane * p.box;
    if (p.table != nullptr && lane < nbox && pos < f_hi) {
      f_page = p.table[static_cast<size_t>(f_b) * p.table_stride + pos / p.page_size];
    }
  };
  auto load = [&](int stage) {  // warp 0: tile `fed` into `stage`
    const int pos = (f_lo / kT + feed.j) * kT + lane * p.box;
    const bool want = lane < nbox && pos < f_hi && pos + p.box > f_lo;
    const int issued = __popc(__ballot_sync(0xffffffffu, want));
    if (lane == 0) {
      lite::sm90::mbar_expect_tx(&full[stage], issued * 2 * (L::kRowBytes / L::kAtom) * box_bytes);
    }
    __syncwarp();
    if (want) {
      const int pg = p.table != nullptr ? min(max(f_page, 0), p.num_pages - 1) : f_b;
      const int slot = p.table != nullptr ? pos % p.page_size : pos;
      unsigned char* dst = smem + stage * L::kStage + lane * box_bytes;
#pragma unroll
      for (int a = 0; a < L::kRowBytes / L::kAtom; ++a) {
        const int ch = a * L::kAtom / static_cast<int>(sizeof(T));
        lite::sm90::tma_load_4d(dst + a * kT * L::kAtom, &tm_k, &full[stage], ch,
                                coord(p.k_dims, 1, slot, feed.h, pg),
                                coord(p.k_dims, 2, slot, feed.h, pg),
                                coord(p.k_dims, 3, slot, feed.h, pg));
        lite::sm90::tma_load_4d(dst + L::kTile + a * kT * L::kAtom, &tm_v, &full[stage], ch,
                                coord(p.v_dims, 1, slot, feed.h, pg),
                                coord(p.v_dims, 2, slot, feed.h, pg),
                                coord(p.v_dims, 3, slot, feed.h, pg));
      }
    }
    if (++fed < x1) {
      feed.next(prefix, hk);
      fetch();
    }
  };
  if (warp == 0 && x0 < x1) {
    feed.seek(prefix, pairs, hk, x0);
    fetch();
    for (int st = 0; st < kStages && fed < x1; ++st) load(st);
  }

  // The units with no key at all of this CTA's pairs.
  const int ct = tid;
  for (int pr = c; pr < pairs; pr += gridDim.x) {
    if (prefix[pr + 1] != prefix[pr]) continue;
    const int b = pr / p.rtiles;
    const int rt = pr % p.rtiles;
    const int nrows = min(kRows, p.rows - rt * kRows);
    for (int e = ct; e < hk * nrows * D; e += kThreads) {
      const int h = e / (nrows * D);
      const int r = e / D % nrows;
      const size_t row = (static_cast<size_t>(b) * hk + h) * p.rows + rt * kRows + r;
      p.out[row * D + e % D] = __float2bfloat16_rn(0.f);
      if (e % D == 0) p.lse[row] = -INFINITY;
    }
  }
  if (x0 == x1) return;

  const int g = lane / 4;
  const int t = lane % 4;
  const int kw = warp * kKeysW;  // this warp's keys in a tile
  Cursor cur;
  cur.seek(prefix, pairs, hk, x0);

  // The unit being walked: its rows, keys and q fragments (at D 256 in
  // shared memory, qs[kk][lane], written by the whole CTA as it enters a
  // unit: every thread enters each unit at the same point).
  constexpr bool kQShared = L::kQShared;
  int lo = 0, hi = 0, lim_lo = 0, lim_hi = 0, j0 = 0;
  uint32_t qf[kQShared ? 1 : D / kKStep][4];
  float qsc_lo = 0.f, qsc_hi = 0.f;  // Q8: the rows' q scales
  uint4* qs = reinterpret_cast<uint4*>(smem + L::qs);
  float acc[kAccN][4];
  float m_lo, m_hi, l_lo, l_hi;
  auto enter = [&]() {
    lo = ranges[3 * cur.pair];
    hi = ranges[3 * cur.pair + 1];
    const int bound = ranges[3 * cur.pair + 2];
    const int b = cur.pair / p.rtiles;
    const int rt = cur.pair % p.rtiles;
    const int r_lo = rt * kRows + g;
    const int r_hi = r_lo + 8;
    lim_lo = r_lo < p.rows ? row_limit(p, bound, r_lo) : hi;
    lim_hi = r_hi < p.rows ? row_limit(p, bound, r_hi) : hi;
    j0 = cur.j;
    const size_t bh = static_cast<size_t>(b) * hk + cur.h;
    if constexpr (kQShared) {
      // Fragment e = (kk, lane) of the unit's rows, two a thread; the
      // walk's last reads of the previous unit's came before the merge's
      // barriers, its first of these come after this one.
      for (int e = tid; e < D / kKStep * 32; e += kThreads) {
        const int rl = rt * kRows + (e % 32) / 4;
        const int rh = rl + 8;
        if constexpr (Q8) {  // channels 8t .. 8t + 7 of each 32-wide step
          const int8_t* q8 = reinterpret_cast<const int8_t*>(p.q);
          const int col = (e / 32) * 32 + 8 * (e % 4);
          auto words = [&](int r) {
            return r < p.rows ? *reinterpret_cast<const uint2*>(q8 + (bh * p.rows + r) * D + col)
                              : make_uint2(0u, 0u);
          };
          const uint2 wl = words(rl), wh = words(rh);
          qs[e] = make_uint4(wl.x, wh.x, wl.y, wh.y);
        } else {
          const int col = (e / 32) * 16 + 4 * (e % 4);
          const __nv_bfloat16* ql = p.q + (bh * p.rows + rl) * D + col;
          const __nv_bfloat16* qh = p.q + (bh * p.rows + rh) * D + col;
          auto word = [](bool live, const __nv_bfloat16* x) {
            return live ? *reinterpret_cast<const uint32_t*>(x) : 0u;
          };
          qs[e] = make_uint4(word(rl < p.rows, ql), word(rh < p.rows, qh),
                             word(rl < p.rows, ql + 2), word(rh < p.rows, qh + 2));
        }
      }
      lite::sm90::named_sync(kMergeBar, kThreads);
    } else if constexpr (Q8) {
      const int8_t* q8 = reinterpret_cast<const int8_t*>(p.q);
      auto words = [&](int r, int col) {
        return r < p.rows ? *reinterpret_cast<const uint2*>(q8 + (bh * p.rows + r) * D + col)
                          : make_uint2(0u, 0u);
      };
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {  // channels 8t .. 8t + 7 of each 32-wide step
        const uint2 wl = words(r_lo, kk * 32 + 8 * t), wh = words(r_hi, kk * 32 + 8 * t);
        qf[kk][0] = wl.x;
        qf[kk][1] = wh.x;
        qf[kk][2] = wl.y;
        qf[kk][3] = wh.y;
      }
    } else {
      const __nv_bfloat16* q_lo = p.q + (bh * p.rows + r_lo) * D;
      const __nv_bfloat16* q_hi = p.q + (bh * p.rows + r_hi) * D;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // channels 4t .. 4t + 3 of each 16-wide step
        const int col = kk * 16 + 4 * t;
        qf[kk][0] = r_lo < p.rows ? *reinterpret_cast<const uint32_t*>(q_lo + col) : 0u;
        qf[kk][1] = r_hi < p.rows ? *reinterpret_cast<const uint32_t*>(q_hi + col) : 0u;
        qf[kk][2] = r_lo < p.rows ? *reinterpret_cast<const uint32_t*>(q_lo + col + 2) : 0u;
        qf[kk][3] = r_hi < p.rows ? *reinterpret_cast<const uint32_t*>(q_hi + col + 2) : 0u;
      }
    }
    if constexpr (Q8) {
      qsc_lo = r_lo < p.rows ? p.q_scale[bh * p.rows + r_lo] : 0.f;
      qsc_hi = r_hi < p.rows ? p.q_scale[bh * p.rows + r_hi] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAccN; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    m_lo = m_hi = -INFINITY;  // running row max (log2 space)
    l_lo = l_hi = 0.f;        // per-thread partial row sums
  };
  enter();
  // This chunk's pieces of split units (their units in sm_flag[2 + k]) and,
  // in thread 0, their units' tickets after each piece (16 bits each).
  int pieces = 0;
  uint32_t dones = 0;

  for (int i = 0, x = x0; x < x1; ++i, ++x) {
    const int stage = i % kStages;
    if (warp == 0 && i > 0 && fed < x1) {
      // Refill tile i - 1's stage (every warp released it at the end of
      // its step i - 1) with tile i - 1 + kStages.
      const int free = (i - 1) % kStages;
      lite::sm90::mbar_wait(&empty[free], ((i - 1) / kStages) & 1);
      load(free);
    }
    lite::sm90::mbar_wait(&full[stage], (i / kStages) & 1);
    const unsigned char* ks = smem + stage * L::kStage;
    unsigned char* vs = smem + stage * L::kStage + L::kTile;
    const int col0 = (lo / kT + cur.j) * kT + kw;  // this warp's first key

    // V rows outside [lo, hi) become 0 (they may be stale or unloaded).
    if (col0 < lo || col0 + kKeysW > hi) {
      constexpr int kChunks = L::kRowBytes / 16;
      for (int e = lane; e < kKeysW * kChunks; e += 32) {
        const int key = e / kChunks;
        if (col0 + key >= lo && col0 + key < hi) continue;
        const int byte = (e % kChunks) * 16;
        *reinterpret_cast<uint4*>(vs + tile_off<D, T>(kw + key, byte)) = make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
    }

    // S = Q K^T for the 16 rows x this warp's keys.
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    if constexpr (Q8) {  // s8 x s8 -> s32, then fp32 times the row's q scale
      int si[kNb][4];
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) si[nb][0] = si[nb][1] = si[nb][2] = si[nb][3] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t qk[4];
        if constexpr (kQShared) {
          const uint4 w4 = qs[kk * 32 + lane];
          qk[0] = w4.x;
          qk[1] = w4.y;
          qk[2] = w4.z;
          qk[3] = w4.w;
        }
        const uint32_t* qa = kQShared ? qk : qf[kk];
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb) {
          const uint2 w = *reinterpret_cast<const uint2*>(
              ks + tile_off<D, T>(kw + nb * 8 + g, kk * 32 + 8 * t));
          mma_s8(si[nb], qa, w.x, w.y);
        }
      }
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        s[nb][0] = static_cast<float>(si[nb][0]) * qsc_lo;
        s[nb][1] = static_cast<float>(si[nb][1]) * qsc_lo;
        s[nb][2] = static_cast<float>(si[nb][2]) * qsc_hi;
        s[nb][3] = static_cast<float>(si[nb][3]) * qsc_hi;
      }
    }
#pragma unroll
    for (int kk = 0; kk < (Q8 ? 0 : D / 16); ++kk) {
      uint32_t qk[4];
      if constexpr (kQShared) {
        const uint4 w4 = qs[kk * 32 + lane];
        qk[0] = w4.x;
        qk[1] = w4.y;
        qk[2] = w4.z;
        qk[3] = w4.w;
      }
      const uint32_t* qa = kQShared ? qk : qf[kk];
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        const int key = kw + nb * 8 + g;
        if constexpr (kInt8) {
          const uint32_t u =
              *reinterpret_cast<const uint32_t*>(ks + tile_off<D, T>(key, kk * 16 + 4 * t)) ^
              0x80808080u;
          mma_bf16(s[nb], qa, pack_bf16(i8_byte(u, 0), i8_byte(u, 1)),
                   pack_bf16(i8_byte(u, 2), i8_byte(u, 3)));
        } else {
          const uint2 w =
              *reinterpret_cast<const uint2*>(ks + tile_off<D, T>(key, kk * 32 + 8 * t));
          mma_bf16(s[nb], qa, w.x, w.y);
        }
      }
    }

    // Log2-space scores (softcap: cap * tanh(s * scale / cap)); keys a row
    // may not see -inf (only tiles at a row's edge test them).
    float scale = p.scale_log2;
    if (p.softcap > 0.f) {
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = p.softcap * kLog2e * tanhf(s[nb][e] * p.scale_over_cap);
      }
      scale = 1.f;
    }
    float mx_lo, mx_hi;
    mask_scores(
        s, scale, col0 < lo || col0 + kKeysW > lim_lo, col0,
        [&](int col, bool hi_row) { return col < lo || col >= (hi_row ? lim_hi : lim_lo); }, mx_lo,
        mx_hi);
    float alpha_lo, alpha_hi;
    softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi);
    // Rescale O only where a row's max moved (after the first tiles, rarely).
    if (__any_sync(0xffffffffu, alpha_lo != 1.f || alpha_hi != 1.f)) {
      rescale_rows(acc, alpha_lo, alpha_hi);
    }

    // O += P V over this warp's keys, 16 at a time: P's accumulator layout
    // is the A operand. At D 256 a warp has 8 keys of a tile: one m16n8k8
    // step, its V fragments by ldmatrix.trans over 4 n-blocks at once (bf16)
    // or from two 4-byte loads of keys 2t, 2t + 1 (int8).
    if constexpr (kNb == 1) {
      const uint32_t a0 = pack_bf16(s[0][0], s[0][1]);
      const uint32_t a1 = pack_bf16(s[0][2], s[0][3]);
      if constexpr (kInt8) {
        const int key = kw + 2 * t;
#pragma unroll
        for (int qd = 0; qd < D / 32; ++qd) {
          const int byte = 4 * g + 32 * qd;
          const uint32_t u0 =
              *reinterpret_cast<const uint32_t*>(vs + tile_off<D, T>(key, byte)) ^ 0x80808080u;
          const uint32_t u1 =
              *reinterpret_cast<const uint32_t*>(vs + tile_off<D, T>(key + 1, byte)) ^ 0x80808080u;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            lite::mma_bf16_k8(acc[4 * qd + r], a0, a1, pack_bf16(i8_byte(u0, r), i8_byte(u1, r)));
          }
        }
      } else {
        const int key = kw + (lane & 7);
#pragma unroll
        for (int db = 0; db < D / 32; ++db) {
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag, vs + tile_off<D, T>(key, (db * 32 + (lane >> 3) * 8) * 2));
#pragma unroll
          for (int r = 0; r < 4; ++r) lite::mma_bf16_k8(acc[4 * db + r], a0, a1, bfrag[r]);
        }
      }
    }
#pragma unroll
    for (int sb = 0; sb < kNb / 2; ++sb) {
      uint32_t a[4];
      p_operand(s, sb, a);
      if constexpr (kInt8) {
        const int key = kw + sb * 16 + 2 * t;
#pragma unroll
        for (int qd = 0; qd < kAccN / 4; ++qd) {
          const int byte = 4 * g + 32 * qd;
          auto word = [&](int k) {
            return *reinterpret_cast<const uint32_t*>(vs + tile_off<D, T>(key + k, byte)) ^
                   0x80808080u;
          };
          const uint32_t u0 = word(0), u1 = word(1), u8 = word(8), u9 = word(9);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            mma_bf16(acc[4 * qd + r], a, pack_bf16(i8_byte(u0, r), i8_byte(u1, r)),
                     pack_bf16(i8_byte(u8, r), i8_byte(u9, r)));
          }
        }
      } else {
        const int key = kw + sb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int db = 0; db < D / 16; ++db) {
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag, vs + tile_off<D, T>(key, (db * 16 + (lane >> 4) * 8) * 2));
          mma_bf16(acc[2 * db], a, bfrag[0], bfrag[1]);
          mma_bf16(acc[2 * db + 1], a, bfrag[2], bfrag[3]);
        }
      }
    }

    if (cur.j == cur.n - 1 || x + 1 == x1) {
      // The end of this CTA's piece of the unit: merge the warps through
      // the stage just read (in two rounds of 8 rows, lo then hi, where the
      // stage holds half the accumulators), then write out and lse, or the
      // piece.
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      if (t == 0) {
        sm_ml[warp * kRows + g] = m_lo;
        sm_ml[warp * kRows + g + 8] = m_hi;
        sm_ml[(kWarps + warp) * kRows + g] = l_lo;
        sm_ml[(kWarps + warp) * kRows + g + 8] = l_hi;
      }
      const int rt = cur.pair % p.rtiles;
      const int nrows = min(kRows, p.rows - rt * kRows);
      const int u = cur.pair * hk + cur.h;
      const bool whole = j0 == 0 && cur.j == cur.n - 1;
      const size_t row0 = (static_cast<size_t>(cur.pair / p.rtiles) * hk + cur.h) * p.rows +
                          rt * kRows;
      const size_t slot = static_cast<size_t>(u) + c;
      float* sm_o = reinterpret_cast<float*>(smem + stage * L::kStage);  // [warps][rows][kDp]
#pragma unroll 1
      for (int half = 0; half < kRows / kMergeRows; ++half) {
        const int r0 = half * kMergeRows;  // the round's first row
        if (r0 >= nrows) break;
        lite::sm90::named_sync(kMergeBar, kThreads);  // the stage (or the last round) is read
        float* my = sm_o + warp * kMergeRows * kDp;
        if constexpr (kMergeRows == 4) {  // int8 at D 256: the round holds one of g, g + 8, or none
          const bool hi_row = half >= 2;
          const int rr = g + (hi_row ? 8 : 0);
          if (rr / kMergeRows == half) {
            float* row = my + (rr - r0) * kDp;
#pragma unroll
            for (int jb = 0; jb < kAccN; ++jb) {
              const int col = 4 * (2 * t + 8 * (jb / 4)) + jb % 4;
              row[scratch_col(g, col)] = hi_row ? acc[jb][2] : acc[jb][0];
              row[scratch_col(g, col + 4)] = hi_row ? acc[jb][3] : acc[jb][1];
            }
          }
        }
#pragma unroll
        for (int hr = 0; hr < kMergeRows / 8; ++hr) {  // this thread's rows g and g + 8
          const bool hi_row = kMergeRows == 8 ? half == 1 : hr == 1;
          float* row = my + (g + (hi_row ? 8 : 0) - r0) * kDp;
#pragma unroll
          for (int jb = 0; jb < kAccN; ++jb) {
            const float v0 = hi_row ? acc[jb][2] : acc[jb][0];
            const float v1 = hi_row ? acc[jb][3] : acc[jb][1];
            if constexpr (kInt8) {  // the block's columns 2t and 2t + 1
              const int col = 4 * (2 * t + 8 * (jb / 4)) + jb % 4;
              row[scratch_col(g, col)] = v0;
              row[scratch_col(g, col + 4)] = v1;
            } else {
              *reinterpret_cast<float2*>(row + scratch_col(g, 8 * jb + 2 * t)) =
                  make_float2(v0, v1);
            }
          }
        }
        lite::sm90::named_sync(kMergeBar, kThreads);
        for (int e = ct; e < min(kMergeRows, nrows - r0) * D; e += kThreads) {
          const int r = r0 + e / D;
          const int d = e % D;
          float mx = -INFINITY;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_ml[w * kRows + r]);
          float l = 0.f, o = 0.f;
          if (mx != -INFINITY) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              const float sc = exp2f(sm_ml[w * kRows + r] - mx);
              l += sm_ml[(kWarps + w) * kRows + r] * sc;
              o += sm_o[(w * kMergeRows + r - r0) * kDp + scratch_col(r, d)] * sc;
            }
          }
          const bool none = !(l > 0.f);
          const float val = none ? 0.f : o / l;
          const float lse = none ? -INFINITY : mx * kLn2 + logf(l);
          if (whole) {
            p.out[(row0 + r) * D + d] = __float2bfloat16_rn(val);
            if (d == 0) p.lse[row0 + r] = lse;
          } else {
            p.o_part[(slot * kRows + r) * D + d] = val;
            if (d == 0) p.lse_part[slot * kRows + r] = lse;
          }
        }
      }
      if (!whole) {
        // Take the unit's ticket: add this piece's tiles (release: the
        // barrier orders every thread's piece before thread 0's atomic).
        // The answer -- whether this piece completed the unit -- is read
        // after the walk, so the atomic's round trip stays off its path. A
        // chunk holds at most two pieces: its first unit and its last.
        lite::sm90::named_sync(kMergeBar, kThreads);
        if (ct == 0) {
          const int done = lite::sm90::atomic_add_release(p.tickets + u, cur.j - j0 + 1);
          dones |= static_cast<uint32_t>(done + cur.j - j0 + 1) << (16 * pieces);
          sm_flag[2 + pieces] = u;
        }
        ++pieces;
      }
      lite::sm90::fence_proxy_async();  // the scratch writes before TMA refills the stage
      lite::sm90::named_sync(kMergeBar, kThreads);
      if (lane == 0) lite::sm90::mbar_arrive(&empty[stage]);
      if (x + 1 < x1) {
        cur.next(prefix, hk);
        enter();
      }
      continue;
    }
    if (col0 < lo || col0 + kKeysW > hi) lite::sm90::fence_proxy_async();  // the zeroed rows
    __syncwarp();
    if (lane == 0) lite::sm90::mbar_arrive(&empty[stage]);  // this warp is done with the stage
    cur.next(prefix, hk);
  }

  // The pieces that completed their unit merge all of its pieces (each
  // piece normalised, with its lse) into out and lse, and put the ticket
  // back to 0 for the next launch.
  if (pieces == 0) return;
  if (ct == 0) {
    __threadfence();  // acquire: the other pieces' writes before the reads below
    for (int k = 0; k < pieces; ++k) {
      const int u = sm_flag[2 + k];
      const int pr = u / hk;
      const bool last = ((dones >> (16 * k)) & 0xffffu) == (prefix[pr + 1] - prefix[pr]) / hk;
      if (last) p.tickets[u] = 0;
      sm_flag[k] = last;
    }
  }
  lite::sm90::named_sync(kMergeBar, kThreads);
  // The ring is free now: it holds the pieces' weights, [piece][row].
  float* wts = reinterpret_cast<float*>(smem);
  float* lse_u = wts + kMaxPieces * kRows;
  constexpr int kStep = kThreads / D;  // rows a pass of the threads covers
  constexpr int kPer = (kRows + kStep - 1) / kStep;  // passes
  const int d = ct % D;
  // This thread's first row; at D 80 and 96 the threads past the last
  // whole pass (kStep * D) idle.
  const int r_first = kThreads % D == 0 || ct < kStep * D ? ct / D : kRows;
  for (int k = 0; k < pieces; ++k) {
    if (!sm_flag[k]) continue;
    const int u = sm_flag[2 + k];
    const int pr = u / hk;
    const int h = u % hk;
    const int n = (prefix[pr + 1] - prefix[pr]) / hk;
    const int start = prefix[pr] + h * n;
    const int c0 = lite::chunk_of(start, total, chunks);
    const int np = lite::chunk_of(start + n - 1, total, chunks) - c0 + 1;
    const int rt_u = pr % p.rtiles;
    const int nrows = min(kRows, p.rows - rt_u * kRows);
    const size_t row0 = (static_cast<size_t>(pr / p.rtiles) * hk + h) * p.rows + rt_u * kRows;
    const size_t slot0 = static_cast<size_t>(u) + c0;
    // The pieces' lse (all loads in flight at once), then per row the
    // weights w = exp(lse - max) / sum and the unit's lse.
    for (int e = ct; e < np * kRows; e += kThreads) {
      wts[e] = __ldcg(p.lse_part + slot0 * kRows + e);
    }
    lite::sm90::named_sync(kMergeBar, kThreads);
    if (ct < nrows) {
      float mx = -INFINITY;
      for (int cc = 0; cc < np; ++cc) mx = fmaxf(mx, wts[cc * kRows + ct]);
      float l = 0.f;
      if (mx != -INFINITY) {
        for (int cc = 0; cc < np; ++cc) l += expf(wts[cc * kRows + ct] - mx);
      }
      const bool none = !(l > 0.f);
      for (int cc = 0; cc < np; ++cc) {
        wts[cc * kRows + ct] = none ? 0.f : expf(wts[cc * kRows + ct] - mx) / l;
      }
      lse_u[ct] = none ? -INFINITY : mx + logf(l);
    }
    lite::sm90::named_sync(kMergeBar, kThreads);
    // out = sum of w o over the pieces: this thread's channel d of rows
    // ct / D + kStep k, every piece's loads of a row in flight together.
    float o[kPer];
#pragma unroll
    for (int k2 = 0; k2 < kPer; ++k2) o[k2] = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < np; ++cc) {
#pragma unroll
      for (int k2 = 0; k2 < kPer; ++k2) {
        const int r = r_first + kStep * k2;
        const float w = r < nrows ? wts[cc * kRows + r] : 0.f;
        if (w != 0.f) o[k2] += w * __ldcg(p.o_part + ((slot0 + cc) * kRows + r) * D + d);
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < kPer; ++k2) {
      const int r = r_first + kStep * k2;
      if (r >= nrows) continue;
      p.out[(row0 + r) * D + d] = __float2bfloat16_rn(o[k2]);
      if (d == 0) p.lse[row0 + r] = lse_u[r];
    }
    lite::sm90::named_sync(kMergeBar, kThreads);  // the weights are read
  }
}

// Tensor map of a cache: dims (channel, then slot, head and page in the order
// of their strides, given by the wrapper as sizes n[] and element strides
// st[]), boxes of `box` rows and one swizzle atom of channels.
template <int D, typename T>
cudaError_t cache_map(CUtensorMap* map, const void* base, const int* n, const long long* st,
                      int dims, int box) {
  using L = Layout<D, T>;
  const uint64_t size[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(n[0]),
                            static_cast<uint64_t>(n[1]), static_cast<uint64_t>(n[2])};
  const uint64_t stride[3] = {st[0] * sizeof(T), st[1] * sizeof(T), st[2] * sizeof(T)};
  uint32_t bx[4] = {static_cast<uint32_t>(L::kAtom / sizeof(T)), 1, 1, 1};
  bx[dims & 3] = box;  // the slot dim
  return lite::sm90::make_tensor_map(
      map, sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      base, size, stride, bx, L::kAtom == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int D, typename T, bool Q8 = false, bool IDX = false>
cudaError_t launch(Params p, const void* k, const void* v, const int* kn, const long long* kst,
                   const int* vn, const long long* vst, int grid, cudaStream_t stream) {
  using L = Layout<D, T>;
  const int gcd = p.page_size > 0 ? std::gcd(p.page_size, L::kT) : L::kT;
  if (gcd < 8) return cudaErrorInvalidValue;  // a box of fewer than 8 rows breaks the swizzle
  p.box = gcd;
  CUtensorMap tm_k, tm_v;
  cudaError_t err;
  if ((err = cache_map<D, T>(&tm_k, k, kn, kst, p.k_dims, p.box)) ||
      (err = cache_map<D, T>(&tm_v, v, vn, vst, p.v_dims, p.box))) {
    return err;
  }
  const int smem = L::prefix + (4 * p.batch * p.rtiles + 1) * 4 + 1024;  // + alignment of the base
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<D, T, Q8, IDX>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(tm_k, tm_v, p);
  return cudaGetLastError();
}

// Head dim 256 (bf16 or int8 caches, int8_mma with q8, cache_batch_idx
// with idx), instantiated in flash_decode_d256.cu, whose nvcc runs beside
// this file's.
cudaError_t launch_d256(bool int8, bool q8, bool idx, const Params& p, const void* k,
                        const void* v, const int* kn, const long long* kst, const int* vn,
                        const long long* vst, int grid, cudaStream_t stream);

// Head dims 80 and 96 (bf16 or int8 caches, cache_batch_idx with idx; no
// int8_mma), instantiated in flash_decode_hd.cu, whose nvcc runs beside
// this file's.
cudaError_t launch_hd(int head_dim, bool int8, bool idx, const Params& p, const void* k,
                      const void* v, const int* kn, const long long* kst, const int* vn,
                      const long long* vst, int grid, cudaStream_t stream);

}  // namespace decode

// flash_decode_d256.cu and flash_decode_hd.cu include the kernel above and
// not the entry below.
#ifndef LITE_DECODE_TEMPLATES_ONLY

// q [B, Hk, R, D] bf16, D 64, 80, 96, 128 or 256 (int8 with q_scale [B,
// Hk, R] fp32: int8_mma, int8 caches only, not at D 80 or 96); k/v cache
// bases (bf16, or int8 when int8 != 0), each described by the sizes and
// element strides of its three outer dims in increasing stride (kn/kst,
// vn/vst) and where slot, head and page sit among them (k_dims/v_dims: 2
// bits each, dims 1-3); the channel stride is 1.
// table [B, table_stride] int32 or null; bound/low [B] int32 (low may be
// null); batch_idx [B] int32, the cache's batch row of each q batch row, or
// null (contiguous bf16 caches only). out [B, Hk, R, D] bf16, lse [B, Hk, R]
// fp32; o_part [units + grid, 16, D] and lse_part [units + grid, 16] fp32
// scratch; tickets [units] int32,
// zero before the launch and after it. `grid` CTAs, chunks of at least
// min_tiles key tiles. Returns the CUDA error (0 = success).
extern "C" int lite_flash_decode(
    const void* q, const void* k, const void* v, const void* table, const void* bound,
    const void* low, const void* batch_idx, const void* q_scale, void* out, void* lse,
    void* o_part, void* lse_part, void* tickets,
    int kn1, int kn2, int kn3, long long kst1, long long kst2, long long kst3, int k_dims,
    int vn1, int vn2, int vn3, long long vst1, long long vst2, long long vst3, int v_dims,
    int batch, int kv_heads, int rows, int group, int head_dim, int capacity, int table_stride,
    int page_size, int num_pages, int causal, int causal_off, int grid, int min_tiles, int int8,
    float scale, float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.table = static_cast<const int*>(table);
  p.bound = static_cast<const int*>(bound);
  p.low = static_cast<const int*>(low);
  p.batch_idx = static_cast<const int*>(batch_idx);
  p.q_scale = static_cast<const float*>(q_scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.tickets = static_cast<int*>(tickets);
  p.batch = batch;
  p.kv_heads = kv_heads;
  p.rows = rows;
  p.rtiles = (rows + decode::kRows - 1) / decode::kRows;
  p.group = group;
  p.capacity = capacity;
  p.table_stride = table_stride;
  p.page_size = page_size;
  p.num_pages = num_pages;
  p.causal = causal;
  p.causal_off = causal_off;
  p.min_tiles = max(min_tiles, 1);
  p.k_dims = k_dims;
  p.v_dims = v_dims;
  p.scale_log2 = scale * decode::kLog2e;
  p.softcap = softcap;
  p.scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
  const int kn[3] = {kn1, kn2, kn3}, vn[3] = {vn1, vn2, vn3};
  const long long kst[3] = {kst1, kst2, kst3}, vst[3] = {vst1, vst2, vst3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || grid > decode::kMaxPieces) return static_cast<int>(cudaErrorInvalidValue);
  const bool q8 = q_scale != nullptr;
  const bool idx = batch_idx != nullptr;
  if ((q8 && !int8) || (idx && (int8 || table != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf16 = __nv_bfloat16;
  if (head_dim == 64) {
    err = q8     ? decode::launch<64, uint8_t, true>(p, k, v, kn, kst, vn, vst, grid, s)
          : int8 ? decode::launch<64, uint8_t>(p, k, v, kn, kst, vn, vst, grid, s)
          : idx  ? decode::launch<64, bf16, false, true>(p, k, v, kn, kst, vn, vst, grid, s)
                 : decode::launch<64, bf16>(p, k, v, kn, kst, vn, vst, grid, s);
  } else if (head_dim == 128) {
    err = q8     ? decode::launch<128, uint8_t, true>(p, k, v, kn, kst, vn, vst, grid, s)
          : int8 ? decode::launch<128, uint8_t>(p, k, v, kn, kst, vn, vst, grid, s)
          : idx  ? decode::launch<128, bf16, false, true>(p, k, v, kn, kst, vn, vst, grid, s)
                 : decode::launch<128, bf16>(p, k, v, kn, kst, vn, vst, grid, s);
  } else if (head_dim == 256) {
    err = decode::launch_d256(int8 != 0, q8, idx, p, k, v, kn, kst, vn, vst, grid, s);
  } else if ((head_dim == 80 || head_dim == 96) && !q8) {
    err = decode::launch_hd(head_dim, int8 != 0, idx, p, k, v, kn, kst, vn, vst, grid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Keys per tile of the kernel's ring at head_dim (0: not built). The wrapper
// sizes its checks of the page gcd and the 16-bit tile count, and the
// chunks' least tiles, by it.
extern "C" int lite_flash_decode_tile_keys(int head_dim) {
  switch (head_dim) {
    case 64: return decode::Layout<64, __nv_bfloat16>::kT;
    case 80: return decode::Layout<80, __nv_bfloat16>::kT;
    case 96: return decode::Layout<96, __nv_bfloat16>::kT;
    case 128: return decode::Layout<128, __nv_bfloat16>::kT;
    case 256: return decode::Layout<256, __nv_bfloat16>::kT;
    default: return 0;
  }
}

#endif  // LITE_DECODE_TEMPLATES_ONLY
