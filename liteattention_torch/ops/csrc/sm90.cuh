// Hopper (sm_90a) building blocks: mbarriers, TMA loads (3-D and 4-D), stores, bulk copies both ways,
// the bulk reduce-add, a release atomic, and wgmma with its shared-memory descriptors.
//
// Every tile that wgmma reads from shared memory here is stored with the
// 128-byte swizzle, the layout a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: a tile of 16-bit values is cut into atoms of 8 rows x 64 values
// (8 x 128 bytes, 1024-byte aligned), and the 16-byte chunk c of row r is
// stored at chunk c ^ (r % 8). A descriptor names such a tile by its start
// address and two strides:
//
// * K-major (the reduced dimension contiguous, each 128-byte row one row
//   of the operand): SBO is the stride between 8-row groups (1024 bytes for
//   a tile 64 values wide); a 16-deep step along K advances the start by
//   32 bytes inside the atom, and by the atom's size past 64 values.
// * MN-major (the M or N dimension contiguous, each 128-byte row one step
//   of K holding 64 values of M or N; wgmma's "transpose" flag): SBO is the
//   stride between 8-row groups of K (1024 bytes), LBO the stride between
//   64-value atoms along M or N; a 16-deep step along K advances the start
//   by 16 rows (2048 bytes).
//
// A tile whose width is not a multiple of 64 (head dims 80 and 96) takes
// ceil(width / 64) atoms, the last partly filled: a TMA load whose box
// crosses the tensor's inner extent fills the rest with zeros, a store
// clips there. An MN-major operand of N = 80 or 96 spans a whole atom and
// the first 16 or 32 values of the next, LBO apart; a K-major one is read
// only as deep as its K steps go.
//
// The accumulator of an m64nN wgmma is spread over the warpgroup as
// mma.sync's m16n8 fragments stacked over its four warps: thread (warp w,
// lane l) holds d[4 j + 2 i + c] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + c].
// Rounded to bf16 pairs, columns 16 k .. 16 k + 15 of it are the register A
// operand of a wgmma whose K step is k (frag_a).
//
// The host helper fetches cuTensorMapEncodeTiled through the runtime's
// driver entry point, so the library links without -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lite {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival (no transaction bytes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// never ends (a fault in the pipeline) traps after 2^28 tries, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bar.sync on a named barrier shared by `threads` threads (id 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on a named barrier without waiting (the other side bar.syncs).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -------------------------------------------------------- TMA and bulk

// Fetch a tensor map (a __grid_constant__ kernel parameter) into the cache
// ahead of its first load.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Tile of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Tile of a 4-D tensor map at coordinates (c0 innermost, ..., c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The shared-memory tile at `src` (laid out as a load of the same box
// writes it) to the 3-D tensor map at (c0, c1, c2); parts of the box past
// the map's dimensions are not written. Completes in this thread's bulk
// group (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Contiguous copy of `bytes` from shared memory to global memory (a
// multiple of 16, both ends 16-byte aligned); completes in this thread's
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// dst[i] += src[i] in fp32 over `bytes`, done by the TMA unit as atomics.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed bulk operations have read their source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's committed bulk operations are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// *addr += v at GPU scope with release semantics; returns the old value.
__device__ __forceinline__ int atomic_add_release(int* addr, int v) {
  int old;
  asm volatile("atom.release.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(addr), "r"(v)
               : "memory");
  return old;
}

// Orders this thread's ordinary shared-memory writes before later reads
// by the async proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a 128-byte-swizzled tile (layout type 1) starting at `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The descriptor of the tile `bytes` further on (within the same 256 KB).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma writes (accumulators) or reads (A
// fragments) to this point of the program, so that the compiler neither
// reads them early nor reuses them before the wgmma_wait that precedes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Register A operand for K step k from an accumulator (rounded to bf16).
template <int R>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&d)[R], int k) {
  a[0] = pack_bf16x2(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16x2(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16x2(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16x2(d[8 * k + 6], d[8 * k + 7]);
}

#define LITE_WG_OUT8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define LITE_WG_OUT16(d) LITE_WG_OUT8(d, 0), LITE_WG_OUT8(d, 8)
#define LITE_WG_OUT32(d) LITE_WG_OUT16(d), LITE_WG_OUT8(d, 16), LITE_WG_OUT8(d, 24)
#define LITE_WG_OUT64(d) \
  LITE_WG_OUT32(d), LITE_WG_OUT8(d, 32), LITE_WG_OUT8(d, 40), LITE_WG_OUT8(d, 48), LITE_WG_OUT8(d, 56)

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : LITE_WG_OUT16(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : LITE_WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : LITE_WG_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (a[4], the
// accumulator layout rounded to bf16 pairs), B in shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LITE_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (a[4], the
// accumulator layout rounded to bf16 pairs), B in shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : LITE_WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 80] (+)= A[64 x 16] B[16 x 80], A in registers (a[4], the
// accumulator layout rounded to bf16 pairs), B in shared memory.
#define LITE_WG_OUT40(d) LITE_WG_OUT32(d), LITE_WG_OUT8(d, 32)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : LITE_WG_OUT40(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 96] (+)= A[64 x 16] B[16 x 96], A in registers, B in shared memory.
#define LITE_WG_OUT48(d) LITE_WG_OUT40(d), LITE_WG_OUT8(d, 40)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : LITE_WG_OUT48(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// 64-value atoms of a tile `width` values wide (the last partly filled
// when width is not a multiple of 64).
__host__ __device__ constexpr int atoms(int width) { return (width + 63) / 64; }

#define LITE_WG_OUT128(d) \
  LITE_WG_OUT64(d), LITE_WG_OUT8(d, 64), LITE_WG_OUT8(d, 72), LITE_WG_OUT8(d, 80), \
      LITE_WG_OUT8(d, 88), LITE_WG_OUT8(d, 96), LITE_WG_OUT8(d, 104), LITE_WG_OUT8(d, 112), \
      LITE_WG_OUT8(d, 120)

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : LITE_WG_OUT128(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A in registers (a[4], the
// accumulator layout rounded to bf16 pairs), B in shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : LITE_WG_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x N] (+)= A B at the head dims the attention kernels take (N 64,
// 80, 96, 128 or 256), A in registers, B in shared memory.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128 || N == 256, "no wgmma wrapper at this N");
  if constexpr (N == 64) {
    wgmma_rs_n64<TB>(d, a, db, accumulate);
  } else if constexpr (N == 80) {
    wgmma_rs_n80<TB>(d, a, db, accumulate);
  } else if constexpr (N == 96) {
    wgmma_rs_n96<TB>(d, a, db, accumulate);
  } else if constexpr (N == 128) {
    wgmma_rs_n128<TB>(d, a, db, accumulate);
  } else {
    wgmma_rs_n256<TB>(d, a, db, accumulate);
  }
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, fetched once through the runtime's driver entry
// point (so the library links without -lcuda); null if the driver lacks it.
using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TensorMapEncode tensor_map_encoder() {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  return encode;
}

// A tiled tensor map of `rank` dims (dims[0] contiguous; strides in bytes of
// dims 1 .. rank - 1, each a multiple of 16) with boxes of box[] values;
// reads past a dimension fill zeros. Returns a CUDA error code (0 = success).
inline cudaError_t make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                   const void* base, const uint64_t* dims,
                                   const uint64_t* strides, const uint32_t* box,
                                   CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    elem[i] = 1;
    if (i > 0) st[i - 1] = strides[i - 1];
  }
  CUresult res = encode(map, type, rank, const_cast<void*>(base), d, st, bx, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D bf16 tensor map over [dim2][dim1][dim0] (dim0 contiguous) with
// boxes of box1 x box0 values (box0 * 2 = 128 bytes), 128-byte swizzle;
// reads past dim1 fill zeros. Returns a CUDA error code (0 = success).
inline cudaError_t make_tensor_map_3d(CUtensorMap* map, const void* base, uint64_t dim0,
                                      uint64_t dim1, uint64_t dim2, uint32_t box0,
                                      uint32_t box1) {
  const uint64_t dims[3] = {dim0, dim1, dim2};
  const uint64_t strides[2] = {dim0 * 2, dim0 * dim1 * 2};  // bytes, dims 1 and 2
  const uint32_t box[3] = {box0, box1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
}  // namespace lite
