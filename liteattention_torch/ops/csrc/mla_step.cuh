// The split-O tile step of the MLA kernels on Hopper, shared by the MLA
// decode B10 (mla_decode.cu) and B1's forward at V 512 (mla_fwd.cu).
//
// A CTA holds 64 q rows (a row block) in two warpgroups of 128 threads.
// Per 64-key tile, warpgroup 0 computes S = Q K^T once over 9 atoms of 64
// channels (the 576 score channels: the latent row, or [q | qv] against
// [k | v]), runs the online softmax and O[:, 0:256] += P V[:, 0:256] with P
// from registers; it hands P (bf16, 8 KB, 128-byte swizzle) and each row's
// rescale factor to warpgroup 1 through shared memory, which runs
// O[:, 256:512] += P V[:, 256:512] with both operands in shared memory.
// Each accumulator is 64 x 256 fp32, 128 registers a thread. Two named
// barriers hand P over (kPFull, kPEmpty): warpgroup 1 arrives on kPEmpty
// once before its first tile, then each side alternates sync and arrive.
//
// Every tile here is 64 rows of 128-byte rows in TMA's 128-byte swizzle
// (sm90.cuh), atom a (channels 64 a .. 64 a + 63) at a * kAtom.
#pragma once

#include "attention_fwd.cuh"
#include "sm90.cuh"

namespace lite {
namespace mla_step {

using sm90::desc_add;
using sm90::desc_sw128;

constexpr int kRows = 64;           // q rows per CTA (a row block)
constexpr int kKeys = 64;           // keys per tile
constexpr int kAtom = kKeys * 128;  // bytes of one 64-channel atom of a tile (kRows == kKeys rows)
constexpr int kSAtoms = 9;          // atoms of the score's 576 channels
constexpr int kHalf = 256;          // output channels per warpgroup
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Named barriers (0 is __syncthreads): P handed over, P read, and one per
// warpgroup (kWgBar + wg).
constexpr int kPFull = 1;
constexpr int kPEmpty = 2;
constexpr int kWgBar = 3;

// S[64 x 64] = Q K^T over the 9 atoms of Q (q_desc) and of the K tile at
// k_addr, both K-major; returns once S is in registers. Each of the 36
// 16-deep steps moves the last descriptors on behind an empty asm, opaque to
// the compiler, so that it does not compute all 72 ahead into the registers
// O needs (unrolled that way, B10 spilled at 255; a loop over the atoms
// instead made ptxas serialise the wgmmas).
__device__ __forceinline__ void score(float (&sd)[kKeys / 2], uint64_t q_desc, uint32_t k_addr) {
  uint64_t qd = q_desc;
  uint64_t kd = desc_sw128(k_addr, 16, 1024);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSAtoms * 4; ++kk) {
    sm90::wgmma_ss_n64<0, 0>(sd, qd, kd, kk > 0);
    const uint32_t step = kk % 4 == 3 ? kAtom - 3 * 32 : 32;  // the next atom, or 16 deeper
    qd = desc_add(qd, step);
    kd = desc_add(kd, step);
    asm volatile("" : "+l"(qd), "+l"(kd));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sd);
}

// Warpgroup 0: P (bf16 pairs in the A-operand layout, rows r_lo / r_hi of
// the block) and the rows' rescale factors to shared memory, once
// warpgroup 1 is done with the last P.
__device__ __forceinline__ void hand_p(unsigned char* pb, float* rowv,
                                       const uint32_t (&pf)[kKeys / 16][4], float alpha_lo,
                                       float alpha_hi, int r_lo, int r_hi) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  sm90::named_sync(kPEmpty, kThreads);
#pragma unroll
  for (int k = 0; k < kKeys / 16; ++k) {  // keys 16 k .. 16 k + 15: chunks 2 k, 2 k + 1
    *reinterpret_cast<uint32_t*>(pb + r_lo * 128 + (((2 * k) ^ g) << 4) + 4 * t) = pf[k][0];
    *reinterpret_cast<uint32_t*>(pb + r_hi * 128 + (((2 * k) ^ g) << 4) + 4 * t) = pf[k][1];
    *reinterpret_cast<uint32_t*>(pb + r_lo * 128 + (((2 * k + 1) ^ g) << 4) + 4 * t) = pf[k][2];
    *reinterpret_cast<uint32_t*>(pb + r_hi * 128 + (((2 * k + 1) ^ g) << 4) + 4 * t) = pf[k][3];
  }
  if (t == 0) {
    rowv[r_lo] = alpha_lo;
    rowv[r_hi] = alpha_hi;
  }
  sm90::fence_proxy_async();
  sm90::named_arrive(kPFull, kThreads);
}

// Warpgroup 0: O[:, 0:256] += P V[:, 0:256], P from registers, V's first 4
// atoms at v_addr read MN-major; returns once the product has retired.
__device__ __forceinline__ void pv_regs(float (&od)[kHalf / 2], uint32_t (&pf)[kKeys / 16][4],
                                        uint32_t v_addr) {
  const uint64_t v_desc = desc_sw128(v_addr, kAtom, 1024);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    sm90::wgmma_rs_n256<1>(od, pf[kk], desc_add(v_desc, kk * 2048), 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(od);
  sm90::fence_regs(pf);
}

// Warpgroup 1: waits for P, rescales O by the rows' factors, then O += P V
// over the 4 atoms of V at v_addr (P from shared memory at p_addr) and
// releases P once the product has retired.
__device__ __forceinline__ void pv_smem(float (&o)[kHalf / 8][4], const float* rowv, int r_lo,
                                        int r_hi, uint32_t p_addr, uint32_t v_addr) {
  float(&od)[kHalf / 2] = reinterpret_cast<float(&)[kHalf / 2]>(o);
  sm90::named_sync(kPFull, kThreads);
  rescale_rows(o, rowv[r_lo], rowv[r_hi]);
  const uint64_t p_desc = desc_sw128(p_addr, 16, 1024);
  const uint64_t v_desc = desc_sw128(v_addr, kAtom, 1024);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    sm90::wgmma_ss_n256<0, 1>(od, desc_add(p_desc, kk * 32), desc_add(v_desc, kk * 2048), 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(od);
  sm90::named_arrive(kPEmpty, kThreads);
}

}  // namespace mla_step
}  // namespace lite
