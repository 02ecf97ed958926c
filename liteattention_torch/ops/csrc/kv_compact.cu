// B6: union-compacted K/V staging on Hopper (replaces the Pallas kernel
// liteattention_tpu/ops/kv_compact.py:_copy_kernel).
//
// out[b, hk, c] = in[b, hk, inv[b, hk, c]] over 128-row tiles, for K and V
// together: one CTA per (compact position, kv-head, batch) copies the two
// tiles in 16-byte chunks, neighbouring threads on neighbouring addresses.
// Every position is copied, the dead tail after the union count too (the
// output keeps the input's full shape, as in JAX). The TPU's K|V lane
// interleave is not carried over: K and V stay separate [B, Hk, S, D]
// tensors.
//
// What bounds it: memory. It reads each tile once and writes it once (4
// bytes moved per bf16 element of K and V), with no arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows per tile = one fine k-tile
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    kv_compact_kernel(const int4* __restrict__ k, const int4* __restrict__ v,
                      int4* __restrict__ kc, int4* __restrict__ vc,
                      const int* __restrict__ inv, int ktiles, int chunks) {
  const size_t bhk = blockIdx.y + static_cast<size_t>(blockIdx.z) * gridDim.y;
  const int c = blockIdx.x;
  const int src = inv[bhk * ktiles + c];
  const size_t in0 = (bhk * ktiles + src) * chunks;
  const size_t out0 = (bhk * ktiles + c) * chunks;
#pragma unroll 4
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int4 kx = k[in0 + i];
    const int4 vx = v[in0 + i];
    kc[out0 + i] = kx;
    vc[out0 + i] = vx;
  }
}

}  // namespace

// row_bytes = D * element size, a multiple of 16.
extern "C" int lite_kv_compact(const void* k, const void* v, void* kc, void* vc,
                               const void* inv, int batch, int kv_heads,
                               int ktiles, int row_bytes, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_bytes % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || kv_heads == 0 || ktiles == 0) return 0;
  const int chunks = kRows * row_bytes / 16;
  dim3 grid(ktiles, kv_heads, batch);
  kv_compact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(k), static_cast<const int4*>(v),
      static_cast<int4*>(kc), static_cast<int4*>(vc),
      static_cast<const int*>(inv), ktiles, chunks);
  return static_cast<int>(cudaGetLastError());
}
