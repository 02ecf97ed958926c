// B6: union-compacted K/V staging on Hopper (replaces the Pallas kernel
// liteattention_tpu/ops/kv_compact.py:_copy_kernel).
//
// out[b, hk, c] = in[b, hk, inv[b, hk, c]] over 128-row tiles, for K and V
// together. Every position is copied, the dead tail after the union count
// too (the output keeps the input's full shape, as in JAX). The TPU's K|V
// lane interleave is not carried over: K and V stay separate [B, Hk, S, D]
// tensors, where each tile is one contiguous block (32 KB at D 128 bf16).
//
// What bounds it: memory. It reads each tile once and writes it once (4
// bytes moved per bf16 element of K and V), with no arithmetic. So nothing
// passes through registers: the copy engine moves every byte. One CTA per
// SM (persistent) walks the flat list of copies -- (tile, K or V, part of
// at most kChunk bytes) -- in steps of the grid, and one thread drives it:
// cp.async.bulk global -> shared into a ring of stages, each tracked by an
// mbarrier (expect-tx bytes), then cp.async.bulk shared -> global. A stage
// takes the copy `stages` ahead as soon as its store has read it
// (wait_group.read), so every other stage's load stays in flight under each
// store (refilling a stage one step behind its store, with one load fewer
// in flight, was slower on the H100).
#include <algorithm>

#include "sm90.cuh"

namespace {

using lite::sm90::bulk_commit;
using lite::sm90::bulk_load;
using lite::sm90::bulk_store;

constexpr int kRows = 128;          // rows per tile = one fine k-tile
constexpr int kChunk = 32768;       // bytes per copy (a tile, or a part of a wide one)
constexpr int kRingBytes = 196608;  // the stages together
constexpr int kMaxStages = 16;

struct Params {
  const unsigned char* src[2];  // K, V
  unsigned char* dst[2];
  const int* inv;  // [B * Hk, ktiles]
  long long tile_bytes;
  int ktiles, parts, chunk, stages;
  long long copies;  // B * Hk * ktiles * 2 * parts
};

__global__ void __launch_bounds__(32, 1) kv_compact_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  if (threadIdx.x != 0) return;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const long long first = blockIdx.x;
  const long long step = gridDim.x;
  const long long n = first < p.copies ? (p.copies - first + step - 1) / step : 0;
  for (int s = 0; s < p.stages; ++s) lite::sm90::mbar_init(&full[s], 1);
  lite::sm90::mbar_fence_init();

  // Copy i of this CTA: its source and destination and its bytes.
  auto locate = [&](long long i, const unsigned char*& from, unsigned char*& to) {
    const long long u = first + i * step;
    const int part = static_cast<int>(u % p.parts);
    const long long rest = u / p.parts;
    const int kv = static_cast<int>(rest % 2);
    const long long t = rest / 2;  // (b, hk) * ktiles + c
    const long long row0 = t - t % p.ktiles;
    const long long off = static_cast<long long>(part) * p.chunk;
    from = (kv ? p.src[1] : p.src[0]) + (row0 + __ldg(p.inv + t)) * p.tile_bytes + off;
    to = (kv ? p.dst[1] : p.dst[0]) + t * p.tile_bytes + off;
    return static_cast<uint32_t>(min(static_cast<long long>(p.chunk), p.tile_bytes - off));
  };
  auto load = [&](long long i) {
    const int s = static_cast<int>(i % p.stages);
    const unsigned char* from;
    unsigned char* to;
    const uint32_t bytes = locate(i, from, to);
    lite::sm90::mbar_expect_tx(&full[s], bytes);
    bulk_load(ring + static_cast<size_t>(s) * p.chunk, from, bytes, &full[s]);
  };

  for (long long i = 0; i < p.stages && i < n; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int s = static_cast<int>(i % p.stages);
    lite::sm90::mbar_wait(&full[s], static_cast<uint32_t>(i / p.stages) & 1);
    lite::sm90::fence_proxy_async();
    const unsigned char* from;
    unsigned char* to;
    const uint32_t bytes = locate(i, from, to);
    bulk_store(to, ring + static_cast<size_t>(s) * p.chunk, bytes);
    bulk_commit();
    if (i + p.stages < n) {  // the stage takes copy i + stages once the store has read it
      lite::sm90::bulk_wait_read();
      load(i + p.stages);
    }
  }
  lite::sm90::bulk_wait();
}

}  // namespace

// row_bytes = D * element size, a multiple of 16; every buffer 16-byte aligned.
extern "C" int lite_kv_compact(const void* k, const void* v, void* kc, void* vc,
                               const void* inv, int batch, int kv_heads,
                               int ktiles, int row_bytes, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_bytes % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || kv_heads == 0 || ktiles == 0) return 0;
  Params p{};
  p.src[0] = static_cast<const unsigned char*>(k);
  p.src[1] = static_cast<const unsigned char*>(v);
  p.dst[0] = static_cast<unsigned char*>(kc);
  p.dst[1] = static_cast<unsigned char*>(vc);
  p.inv = static_cast<const int*>(inv);
  p.tile_bytes = static_cast<long long>(kRows) * row_bytes;
  p.ktiles = ktiles;
  p.chunk = static_cast<int>(std::min(p.tile_bytes, static_cast<long long>(kChunk)));
  p.parts = static_cast<int>((p.tile_bytes + p.chunk - 1) / p.chunk);
  p.stages = std::min(kMaxStages, kRingBytes / p.chunk);
  p.copies = static_cast<long long>(batch) * kv_heads * ktiles * 2 * p.parts;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int smem = p.stages * p.chunk + 128;  // + alignment of the ring
  err = cudaFuncSetAttribute(kv_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(std::min(p.copies, static_cast<long long>(sms)));
  kv_compact_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
