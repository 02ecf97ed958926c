// B2: fine skip mask -> compacted gather schedule on Hopper (replaces the
// Pallas kernel liteattention_tpu/ops/schedule_pack.py:_pack_kernel).
//
// Contract (the compact_mask one): for each (b, h, q-tile) row of the mask
// [rows, Kt], fidx lists the live k-tile indices in increasing order and
// repeats the last live index in the tail; count = max(live, 1); a row
// with no live tile lists tile 0. With a kv_map (the union-compaction map
// of the row's kv-head, [B, Hk, Kt]) the kernel also writes cidx =
// kv_map[fidx], each entry's tile in the union-compacted K/V buffer (0
// throughout for a row with no live tile, as in JAX). At qsubs = 1 the
// TPU kernel's qbits and step flags are not needed.
//
// What bounds it: bytes. It reads the mask once (1 byte a tile) and writes
// fidx once (4 bytes a tile; cidx 4 more), ~13 MB at [1, 40, 256, 256]:
// ~4 us at the HBM rate, so the design is about keeping the writes wide
// and every row in flight at once:
// - one warp per row, 8 rows a CTA, as many CTAs as the rows need (a grid
//   sized to the SMs with a loop over rows, and loading the next row's
//   mask under this row's stores, were no faster on an H100);
// - reads: 16-byte vector loads of the mask row (16 tiles a lane, 512 a
//   warp-wide pass), byte loads where a row's chunk is not 16-byte aligned
//   (Kt % 16 != 0) or at the row's ragged end;
// - offsets: each lane packs its 16 tiles into a bit mask; a popcount and
//   a warp scan (__shfl_up_sync) give each lane its output offset;
// - the live list goes into the warp's slice of shared memory, shifted so
//   that its slots line up with fidx's 16-byte boundaries, and the whole
//   row (tail fill included) is written from there with int4 stores, a
//   scalar head and tail where the row does not start or end on one;
// - with kv_map every CTA serves the rows of one kv-head (they are
//   contiguous: row / (Qt * group) is the kv-head row), so it loads that
//   kv_map row into shared memory once and gathers cidx from there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kChunk = 512;             // tiles a warp-wide pass reads: 32 lanes x 16
constexpr int kSmemBudget = 48 * 1024;  // the default dynamic shared memory of a CTA

// Bit k of the result: byte k of w is not 0 (k = 0..3).
__device__ __forceinline__ uint32_t live_nibble(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  w &= 0x01010101u;
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xFu;
}

// Live bits of tiles [t0, t0 + 16) of mask row m (bit j: tile t0 + j).
__device__ __forceinline__ uint32_t load_bits(const uint8_t* __restrict__ m, int t0, int kt) {
  if (t0 >= kt) return 0;
  const uint8_t* p = m + t0;
  if (t0 + 16 <= kt && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    return live_nibble(w.x) | live_nibble(w.y) << 4 | live_nibble(w.z) << 8 |
           live_nibble(w.w) << 12;
  }
  const int n = min(16, kt - t0);
  uint32_t bits = 0;
  for (int j = 0; j < n; ++j) bits |= static_cast<uint32_t>(__ldg(p + j) != 0) << j;
  return bits;
}

// stride: ints of shared memory per warp (Kt + 3 rounded up to 4).
// rows_per_kv / ctas_per_kv: with kMap, rows of one kv-head and CTAs per
// kv-head (the grid is kv-heads x ctas_per_kv).
template <bool kMap>
__global__ void __launch_bounds__(kMaxWarps * 32)
    pack_schedule_kernel(const uint8_t* __restrict__ mask, int* __restrict__ fidx,
                         int* __restrict__ count, const int* __restrict__ kv_map,
                         int* __restrict__ cidx, int rows, int kt, int stride,
                         int rows_per_kv, int ctas_per_kv) {
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* list = smem + warp * stride;
  const int* kmap = nullptr;
  int row, end;
  if constexpr (kMap) {
    int* map_s = smem + warps * stride;
    const int kv = blockIdx.x / ctas_per_kv;
    const int* src = kv_map + static_cast<size_t>(kv) * kt;
    for (int i = threadIdx.x; i < kt; i += blockDim.x) map_s[i] = __ldg(src + i);
    __syncthreads();
    kmap = map_s;
    row = kv * rows_per_kv + (blockIdx.x % ctas_per_kv) * warps + warp;
    end = min(rows, (kv + 1) * rows_per_kv);
  } else {
    row = blockIdx.x * warps + warp;
    end = rows;
  }
  if (row >= end) return;
  const uint8_t* m = mask + static_cast<size_t>(row) * kt;
  int* f = fidx + static_cast<size_t>(row) * kt;
  // f's elements before its first 16-byte boundary are (4 - shift) & 3;
  // list slot shift + p holds entry p, so f + p and list + shift + p are
  // 16-byte aligned together.
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(f) >> 2) & 3;
  int n = 0;
  int last = 0;
  for (int base = 0; base < kt; base += kChunk) {
    const uint32_t bits = load_bits(m, base + lane * 16, kt);
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int pos = shift + n + incl - c;
    for (uint32_t b = bits; b; b &= b - 1) list[pos++] = base + lane * 16 + __ffs(b) - 1;
    const unsigned any = __ballot_sync(0xffffffffu, bits != 0);
    if (any) {
      const int hl = 31 - __clz(any);
      const uint32_t hb = __shfl_sync(0xffffffffu, bits, hl);
      last = base + hl * 16 + 31 - __clz(hb);
    }
    n += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  if (lane == 0) count[row] = n > 1 ? n : 1;
  int* c = kMap ? cidx + static_cast<size_t>(row) * kt : nullptr;
  const int last_c = kMap && n > 0 ? kmap[last] : 0;
  const int head = min((4 - shift) & 3, kt);
  const int body_end = head + ((kt - head) & ~3);
  // Scalar head and tail: at most 3 entries each.
  const int p_s = lane < head ? lane : body_end + lane - 4;
  if (lane < head || (lane >= 4 && p_s < kt)) {
    const bool live = p_s < n;
    const int v = live ? list[shift + p_s] : last;
    f[p_s] = v;
    if constexpr (kMap) c[p_s] = live ? kmap[v] : last_c;
  }
  for (int p = head + lane * 4; p < body_end; p += 128) {
    const int4 v = *reinterpret_cast<const int4*>(list + shift + p);
    int4 o;
    o.x = p < n ? v.x : last;
    o.y = p + 1 < n ? v.y : last;
    o.z = p + 2 < n ? v.z : last;
    o.w = p + 3 < n ? v.w : last;
    *reinterpret_cast<int4*>(f + p) = o;
    if constexpr (kMap) {
      int4 oc;
      oc.x = p < n ? kmap[o.x] : last_c;
      oc.y = p + 1 < n ? kmap[o.y] : last_c;
      oc.z = p + 2 < n ? kmap[o.z] : last_c;
      oc.w = p + 3 < n ? kmap[o.w] : last_c;
      *reinterpret_cast<int4*>(c + p) = oc;
    }
  }
}

__global__ void noop_kernel() {}

template <bool kMap>
int launch(const uint8_t* mask, int* fidx, int* count, const int* kv_map, int* cidx, int rows,
           int kt, int rows_per_kv, cudaStream_t stream) {
  // One warp's list takes 4 (Kt + 4) bytes: up to ~12k tiles a row fit
  // (~6k with kv_map): 1.5M (0.8M) tokens at 128 a tile.
  const int stride = (kt + 3 + 3) & ~3;
  const int map_ints = kMap ? kt : 0;
  const int warps = min(kMaxWarps, (kSmemBudget / 4 - map_ints) / stride);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (warps * stride + map_ints) * 4;
  int blocks, ctas_per_kv = 1;
  if (kMap) {
    ctas_per_kv = (rows_per_kv + warps - 1) / warps;
    blocks = rows / rows_per_kv * ctas_per_kv;
  } else {
    blocks = (rows + warps - 1) / warps;
  }
  pack_schedule_kernel<kMap><<<blocks, warps * 32, smem, stream>>>(
      mask, fidx, count, kv_map, cidx, rows, kt, stride, rows_per_kv, ctas_per_kv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_map/cidx null: fidx and count only. rows_per_kv = Qt * group rows
// share one kv_map row. fidx and cidx must start on the same offset
// modulo 16 bytes (the wrapper allocates both). The device is made current
// only when it is not already.
extern "C" int lite_pack_schedule(const void* mask, void* fidx, void* count,
                                  const void* kv_map, void* cidx, int rows,
                                  int ktiles, int rows_per_kv, int device, void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<const uint8_t*>(mask);
  if (kv_map == nullptr)
    return launch<false>(m, static_cast<int*>(fidx), static_cast<int*>(count), nullptr, nullptr,
                         rows, ktiles, rows_per_kv, s);
  if (rows_per_kv <= 0 || rows % rows_per_kv ||
      (reinterpret_cast<uintptr_t>(fidx) - reinterpret_cast<uintptr_t>(cidx)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(m, static_cast<int*>(fidx), static_cast<int*>(count),
                      static_cast<const int*>(kv_map), static_cast<int*>(cidx), rows, ktiles,
                      rows_per_kv, s);
}

// An empty kernel through the same ctypes path: what a launch costs the
// host, beside B2's call time (chip_smoke.py times it).
extern "C" int lite_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
