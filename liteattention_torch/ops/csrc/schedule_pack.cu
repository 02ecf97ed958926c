// B2: fine skip mask -> compacted gather schedule on Hopper (replaces the
// Pallas kernel liteattention_tpu/ops/schedule_pack.py:_pack_kernel).
//
// One warp per (b, h, q-tile) mask row: a ballot over 32 tiles at a time
// and a popc prefix give each live tile its output slot, so fidx lists the
// live k-tile indices in increasing order; the tail repeats the last live
// index and count = max(live, 1) (the compact_mask contract; a row with no
// live tile lists tile 0). At qsubs = 1 the TPU kernel's qbits and step
// flags are not needed. With a kv_map (the union-compaction map of the
// row's kv-head, [B, Hk, Kt]) the kernel also writes cidx = kv_map[fidx],
// each entry's tile in the union-compacted K/V buffer (0 throughout for a
// row with no live tile, as in JAX).
//
// What bounds it: it reads the mask once and writes fidx once (a few bytes
// per tile), so it is a memory-bound pass over ~5 bytes per tile (~9 with
// cidx) and finishes in microseconds; one warp per row keeps every access
// coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void pack_schedule_kernel(const uint8_t* __restrict__ mask,
                                     int* __restrict__ fidx,
                                     int* __restrict__ count,
                                     const int* __restrict__ kv_map,
                                     int* __restrict__ cidx, int rows,
                                     int ktiles, int qtiles, int group) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint8_t* m = mask + static_cast<size_t>(row) * ktiles;
  int* f = fidx + static_cast<size_t>(row) * ktiles;
  // kv-head row of the map: (b * H + h) / group = b * Hk + h / group.
  const int* km = kv_map ? kv_map + static_cast<size_t>(row / qtiles / group) * ktiles
                         : nullptr;
  int* c = cidx ? cidx + static_cast<size_t>(row) * ktiles : nullptr;
  int n = 0;
  int last = 0;
  for (int base = 0; base < ktiles; base += 32) {
    const int kt = base + lane;
    const bool live = kt < ktiles && m[kt] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int pos = n + __popc(bal & ((1u << lane) - 1u));
      f[pos] = kt;
      if (km) c[pos] = km[kt];
    }
    if (bal) last = base + 31 - __clz(bal);
    n += __popc(bal);
  }
  const int last_c = km && n > 0 ? km[last] : 0;
  for (int pos = n + lane; pos < ktiles; pos += 32) {
    f[pos] = last;
    if (km) c[pos] = last_c;
  }
  if (lane == 0) count[row] = n > 1 ? n : 1;
}

}  // namespace

// kv_map/cidx null: fidx and count only. qtiles and group locate a row's
// kv-head in kv_map.
extern "C" int lite_pack_schedule(const void* mask, void* fidx, void* count,
                                  const void* kv_map, void* cidx, int rows,
                                  int ktiles, int qtiles, int group, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pack_schedule_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int*>(fidx),
      static_cast<int*>(count), static_cast<const int*>(kv_map),
      static_cast<int*>(cidx), rows, ktiles, qtiles, group);
  return static_cast<int>(cudaGetLastError());
}
