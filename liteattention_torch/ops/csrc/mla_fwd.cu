// B1's MLA channels at V 512 (mla_fwd_kernel): the Pallas kernel
// liteattention_tpu/ops/flash_fwd.py:_fwd_kernel with has_qv or V of its own
// head dim, at DeepSeek's absorbed widths (DK, DV) = (576, 512) and (64,
// 512) + qv; forward only, as in JAX. (192, 128), the non-absorbed prefill,
// runs on B1's own mainloop: flash_fwd.cu, lite_flash_fwd_mla.
//
// bf16 q [B, H, Sq, DK] (and qv [B, H, Sq, 512]), k [B, Hk, Sk, DK], v [B,
// Hk, Sk, 512]; GQA by h / group, optionally causal (bottom-right aligned,
// offset Sk - Sq); ragged Sq and Sk. The score is q . k, plus qv . v with
// qv: 576 channels either way. Out [B, H, Sq, 512] bf16, lse fp32 natural
// log; a row with no valid key gets out 0, lse -inf.
//
// What bounds it on the H100: tensor-core issue, 2 (576 + 512) FLOPs per
// (q row, key) pair. Neither a 128 x 512 fp32 accumulator (256 KB) nor q's
// 576 channels fit a CTA's registers, so the design is B10's (mla_step.cuh):
// one CTA per 64 q rows of one head, 256 threads; warpgroup 0 computes S =
// [q | qv] [k | v]^T once per 64-key tile (no recompute per chunk of V),
// runs the softmax and O[:, 0:256]; warpgroup 1 runs O[:, 256:512] from the
// P it is handed through shared memory. Q | qv (72 KB) stays in shared
// memory for the walk; thread 0 loads it and the first tiles by TMA
// (128-byte swizzle; 3-D tensor maps over [B * H(k), S, channels], so a
// ragged tail reads zeros, never the next head's rows).
//
// * With qv, S reads k's one atom and all 8 of v's, and P V v's 8 again: one
//   tile is 72 KB, and a ring of two stages (Q 72 + 2 x 72 + P 8 KB) fills
//   shared memory. Each stage has a full barrier (expect-tx bytes) and an
//   empty barrier that all eight warps arrive on once their P V has
//   retired; thread 128 (warpgroup 1, which waits for P anyway) then
//   refills it with tile j + 2.
// * At (576, 512), K (72 KB) and V (64 KB, a tensor of its own) of a tile
//   do not fit twice beside Q, so they take one buffer each with their own
//   barriers: K of tile j + 1 loads as soon as warpgroup 0's S has read K
//   (thread 0, after a barrier of its warpgroup), under the softmax and
//   both P V; V of tile j + 1 loads once both P V have read V (thread 128),
//   under the next S.
// Causal walks stop at the q-block's diagonal, and the q-blocks run in
// reverse order so the longest walks start first; a block whose rows see no
// key loads nothing.
//
// B1's key range (RANGE; the JAX kernel's has_bound, bound_causal and
// has_low at these shapes, which flash_attn_with_kvcache's qv and Dv != D
// steps reach): the keys of batch b are [kv_low[b], min(Sk, kv_bound[b])),
// with bound_causal the diagonal at kv_bound[b] - Sq (the smaller of the two
// offsets when causal too). Runtime data, read once per CTA into
// key_mask.cuh's KeyRange as B1 reads it; the walk runs from tile low / 64
// to the last tile the limit and the diagonal reach, and only the tiles
// that cross the start, the limit or a row's diagonal are masked per
// element. The RANGE instantiations are CAUSAL ones (a range without a
// diagonal takes key_mask.cuh's kNoDiag), so the four without it keep
// their code and their bits (the channels are a kernel argument of their
// own: as a field of Params they cost the causal instantiations 5-6
// registers, 222 -> 217 and 224 -> 218). Epilogue: each warpgroup writes its normalised 256
// channels into the Q buffer in the 128-byte swizzle and stores them by TMA
// (rows >= Sq are clipped); lse from each quad's first lane.
#include "attention_fwd.cuh"
#include "mla_step.cuh"
#include "sm90.cuh"

namespace lite {
namespace mla_fwd {

using mla_step::kAtom;
using mla_step::kHalf;
using mla_step::kKeys;
using mla_step::kPEmpty;
using mla_step::kPFull;
using mla_step::kRows;
using mla_step::kSAtoms;
using mla_step::kThreads;
using mla_step::kWarps;
using mla_step::kWgBar;
using sm90::desc_sw128;
using sm90::tma_load_3d;

constexpr int kDV = 512;
constexpr int kVAtoms = kDV / 64;

struct Params {
  float* lse;  // [B, H, Sq]
  int heads, kv_heads, seqlen_q, seqlen_k, ktiles, causal_offset;
  float scale_log2;  // softmax scale * log2(e)
};

// Shared memory (byte offsets from a 1024-byte aligned base): Q | qv as 9
// atoms; QV: two ring stages of 9 atoms, k's atom then v's 8; otherwise a K
// buffer of 9 atoms and a V buffer of 8; then P (one atom) and the rows'
// factors. Barriers: full[2] and empty[2] (QV: per stage; otherwise [0] K,
// [1] V), q_full.
template <bool QV>
struct Smem {
  static constexpr int kTile = kSAtoms * kAtom;  // 72 KB
  static constexpr int q = 0;
  static constexpr int k = kTile;
  static constexpr int v = QV ? k + kAtom : 2 * kTile;  // QV: in stage 0, after k's atom
  static constexpr int p = QV ? 3 * kTile : v + kVAtoms * kAtom;
  static constexpr int rowv = p + kAtom;         // float[kRows]: rescale factors, then 1 / l
  static constexpr int bars = rowv + kRows * 4;  // full[2], empty[2], q_full
  static constexpr int bytes = bars + 5 * 8;
};
static_assert(Smem<true>::bytes + 1024 <= 232448 && Smem<false>::bytes + 1024 <= 232448,
              "shared memory of one CTA");

template <bool QV, bool CAUSAL, bool RANGE = false>
__global__ void __launch_bounds__(kThreads, 1)
    mla_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_qv,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, const Params p,
                   const Channels ch) {
  using L = Smem<QV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + 2;
  uint64_t* q_full = empty + 2;
  float* rowv = reinterpret_cast<float*>(smem + L::rowv);

  const int qt = CAUSAL ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int bhk = b * p.kv_heads + h / (p.heads / p.kv_heads);
  const int q0 = qt * kRows;
  // The keys [low, lim) and the diagonal offset: without RANGE [0, Sk) at
  // Sk - Sq.
  int low = 0, lim = p.seqlen_k, diag = p.causal_offset;
  if constexpr (RANGE) {
    const KeyRange r = key_range(ch, b, p.seqlen_q, p.seqlen_k, p.causal_offset);
    low = r.low;
    lim = r.lim;
    diag = r.diag;
  }
  const int j0 = RANGE ? low / kKeys : 0;  // the walk's first tile
  // Tiles walked: to the diagonal when causal.
  int n = RANGE ? (lim + kKeys - 1) / kKeys : p.ktiles;
  if constexpr (CAUSAL) {
    const int last = q0 + kRows - 1 + (RANGE ? diag : p.causal_offset);  // the last row's last key
    n = last < 0 ? 0 : min(n, last / kKeys + 1);
  }
  if constexpr (RANGE) n = max(n - j0, 0);

  // Step j's K (and with QV its V), tile j0 + j, into the K buffer or stage
  // j % 2; V of step j into the V buffer (not QV). Thread 0 or 128.
  auto load_k = [&](int j) {
    uint64_t* bar = &full[QV ? j & 1 : 0];
    unsigned char* dst = smem + L::k + (QV ? (j & 1) * L::kTile : 0);
    sm90::mbar_expect_tx(bar, kSAtoms * kAtom);
    if constexpr (QV) {
      tma_load_3d(dst, &tm_k, bar, 0, (j0 + j) * kKeys, bhk);
#pragma unroll
      for (int a = 0; a < kVAtoms; ++a) {
        tma_load_3d(dst + (1 + a) * kAtom, &tm_v, bar, 64 * a, (j0 + j) * kKeys, bhk);
      }
    } else {
#pragma unroll
      for (int a = 0; a < kSAtoms; ++a) {
        tma_load_3d(dst + a * kAtom, &tm_k, bar, 64 * a, (j0 + j) * kKeys, bhk);
      }
    }
  };
  auto load_v = [&](int j) {
    sm90::mbar_expect_tx(&full[1], kVAtoms * kAtom);
#pragma unroll
    for (int a = 0; a < kVAtoms; ++a) {
      tma_load_3d(smem + L::v + a * kAtom, &tm_v, &full[1], 64 * a, (j0 + j) * kKeys, bhk);
    }
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    sm90::mbar_expect_tx(q_full, kSAtoms * kAtom);
    if constexpr (QV) {
      tma_load_3d(smem + L::q, &tm_q, q_full, 0, q0, bh);
#pragma unroll
      for (int a = 0; a < kVAtoms; ++a) {
        tma_load_3d(smem + L::q + (1 + a) * kAtom, &tm_qv, q_full, 64 * a, q0, bh);
      }
      load_k(0);
      if (n > 1) load_k(1);
    } else {
#pragma unroll
      for (int a = 0; a < kSAtoms; ++a) tma_load_3d(smem + L::q + a * kAtom, &tm_q, q_full, 64 * a, q0, bh);
      load_k(0);
      load_v(0);
    }
  }

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // warp-uniform to the compiler
  const int wg = warp / 4;
  const int tw = tid % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r_lo = 16 * (warp % 4) + g;  // this thread's rows of the block: r_lo, r_lo + 8
  const int r_hi = r_lo + 8;
  auto limit = [&](int r) {  // keys below it (and from low) are valid for block row r
    if constexpr (RANGE) return CAUSAL ? min(lim, q0 + r + diag + 1) : lim;
    return CAUSAL ? min(p.seqlen_k, q0 + r + p.causal_offset + 1) : p.seqlen_k;
  };
  const int lim_lo = limit(r_lo);
  const int lim_hi = limit(r_hi);
  const uint64_t q_desc = desc_sw128(sm90::smem_u32(smem + L::q), 16, 1024);
  const uint32_t k_addr = sm90::smem_u32(smem + L::k);
  const uint32_t v_addr = sm90::smem_u32(smem + L::v);
  const uint32_t p_addr = sm90::smem_u32(smem + L::p);
  // O (this warpgroup's 256 channels) in the accumulator layout (sm90.cuh).
  float o[kHalf / 8][4];
  float(&od)[kHalf / 2] = reinterpret_cast<float(&)[kHalf / 2]>(o);
#pragma unroll
  for (int k = 0; k < kHalf / 2; ++k) od[k] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
  float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums

  if (wg == 1) sm90::named_arrive(kPEmpty, kThreads);  // P's buffer starts free
  for (int j = 0; j < n; ++j) {
    const int stage = QV ? j & 1 : 1;  // the barriers V of tile j completes and is released on
    const uint32_t stage_off = QV ? (j & 1) * L::kTile : 0;
    const uint32_t parity = QV ? (j >> 1) & 1 : j & 1;
    if (QV || wg == 0) sm90::mbar_wait(&full[QV ? stage : 0], parity);
    if (wg == 0) {
      // S = [q | qv] [k | v]^T over 576 channels, masked; the online
      // softmax; P to warpgroup 1; O[:, 0:256] += P V[:, 0:256].
      if (j == 0) sm90::mbar_wait(q_full, 0);
      float s[kKeys / 8][4];
      float(&sd)[kKeys / 2] = reinterpret_cast<float(&)[kKeys / 2]>(s);
      mla_step::score(sd, q_desc, k_addr + stage_off);
      if (!QV && j + 1 < n) {
        // Every warp's S has read K: the next tile's K loads under this
        // tile's softmax and P V.
        sm90::named_sync(kWgBar, 128);
        if (tw == 0) load_k(j + 1);
      }
      const int t0 = (j0 + j) * kKeys;
      float mx_lo, mx_hi, alpha_lo, alpha_hi;
      mask_scores(
          s, 1.f, t0 + kKeys > min(lim_lo, lim_hi) || (RANGE && t0 < low), t0,
          [&](int col, bool hi) { return col >= (hi ? lim_hi : lim_lo) || (RANGE && col < low); },
          mx_lo, mx_hi);
      softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, p.scale_log2);
      rescale_rows(o, alpha_lo, alpha_hi);
      uint32_t pf[kKeys / 16][4];
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) sm90::frag_a(pf[k], sd, k);
      mla_step::hand_p(smem + L::p, rowv, pf, alpha_lo, alpha_hi, r_lo, r_hi);
      if constexpr (!QV) sm90::mbar_wait(&full[1], parity);
      mla_step::pv_regs(od, pf, v_addr + stage_off);
    } else {
      // O[:, 256:512] rescaled, then += P V[:, 256:512] (P from shared memory).
      if constexpr (!QV) sm90::mbar_wait(&full[1], parity);
      mla_step::pv_smem(o, rowv, r_lo, r_hi, p_addr, v_addr + stage_off + 4 * kAtom);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[stage]);  // this warp is done with V (QV: the stage)
    if (tid == 128 && j + (QV ? 2 : 1) < n) {
      // Every warp released it: the stage takes tile j + 2 (QV), the V
      // buffer tile j + 1.
      sm90::mbar_wait(&empty[stage], parity);
      if constexpr (QV) {
        load_k(j + 2);
      } else {
        load_v(j + 1);
      }
    }
  }

  // 1 / l and lse from warpgroup 0 (to warpgroup 1 through rowv), then each
  // warpgroup's rows, bf16, into its half of the Q buffer and out by TMA.
  float inv_lo, inv_hi;
  if (wg == 0) {
    float lse_lo, lse_hi;
    finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
    sm90::named_sync(kPEmpty, kThreads);  // warpgroup 1 is done with the last factors
    if (t == 0) {
      rowv[r_lo] = inv_lo;
      rowv[r_hi] = inv_hi;
      float* lse = p.lse + static_cast<size_t>(bh) * p.seqlen_q + q0;
      if (q0 + r_lo < p.seqlen_q) lse[r_lo] = lse_lo;
      if (q0 + r_hi < p.seqlen_q) lse[r_hi] = lse_hi;
    }
    sm90::named_arrive(kPFull, kThreads);
  } else {
    sm90::named_sync(kPFull, kThreads);
    inv_lo = rowv[r_lo];
    inv_hi = rowv[r_hi];
  }
  unsigned char* ob = smem + L::q;
#pragma unroll
  for (int jb = 0; jb < kHalf / 8; ++jb) {
    unsigned char* chunk = ob + (4 * wg + jb / 8) * kAtom + (((jb % 8) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(chunk + r_lo * 128) =
        sm90::pack_bf16x2(o[jb][0] * inv_lo, o[jb][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(chunk + r_hi * 128) =
        sm90::pack_bf16x2(o[jb][2] * inv_hi, o[jb][3] * inv_hi);
  }
  sm90::fence_proxy_async();
  sm90::named_sync(kWgBar + wg, 128);
  if (tw == 0) {
#pragma unroll
    for (int a = 4 * wg; a < 4 * wg + 4; ++a) sm90::tma_store_3d(&tm_o, ob + a * kAtom, 64 * a, q0, bh);
    sm90::bulk_commit();
    sm90::bulk_wait_read();  // the Q buffer stays until the stores have read it
  }
}

// Tensor maps of q (and qv), k, v and out, then one launch over (q-blocks,
// heads, batch).
template <bool QV, bool CAUSAL, bool RANGE = false>
cudaError_t launch(const void* q, const void* qv, const void* k, const void* v, void* out,
                   Params p, int batch, int head_dim, cudaStream_t stream,
                   const Channels& ch = Channels{}) {
  CUtensorMap tm_q, tm_qv, tm_k, tm_v, tm_o;
  const int bh = batch * p.heads, bhk = batch * p.kv_heads;
  cudaError_t err;
  if ((err = sm90::make_tensor_map_3d(&tm_q, q, head_dim, p.seqlen_q, bh, 64, kRows)) ||
      (err = sm90::make_tensor_map_3d(&tm_qv, QV ? qv : q, QV ? kDV : head_dim, p.seqlen_q, bh,
                                      64, kRows)) ||
      (err = sm90::make_tensor_map_3d(&tm_k, k, head_dim, p.seqlen_k, bhk, 64, kKeys)) ||
      (err = sm90::make_tensor_map_3d(&tm_v, v, kDV, p.seqlen_k, bhk, 64, kKeys)) ||
      (err = sm90::make_tensor_map_3d(&tm_o, out, kDV, p.seqlen_q, bh, 64, kRows))) {
    return err;
  }
  auto kernel = mla_fwd_kernel<QV, CAUSAL, RANGE>;
  constexpr int smem = Smem<QV>::bytes + 1024;  // + alignment of the base
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seqlen_q + kRows - 1) / kRows, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_qv, tm_k, tm_v, tm_o, p, ch);
  return cudaGetLastError();
}

}  // namespace mla_fwd
}  // namespace lite

// (576, 512) with qv null, or (64, 512) with qv [B, H, Sq, 512]: the rest as
// lite_flash_fwd_mla (flash_fwd.cu), which calls this for V 512; kv_bound
// and kv_low [B] int32 or null (with either, the RANGE instantiations).
cudaError_t lite_mla_fwd_v512(const void* q, const void* qv, const void* k, const void* v,
                              void* out, void* lse, const void* kv_bound, const void* kv_low,
                              bool bound_causal, int batch, int heads, int kv_heads,
                              int seqlen_q, int seqlen_k, int head_dim, float scale, bool causal,
                              cudaStream_t stream) {
  using namespace lite::mla_fwd;
  if ((qv != nullptr) != (head_dim == 64) || (head_dim != 64 && head_dim != 576)) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.ktiles = (seqlen_k + kKeys - 1) / kKeys;
  p.causal_offset = seqlen_k - seqlen_q;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (kv_bound != nullptr || kv_low != nullptr) {
    lite::Channels ch{};
    ch.kv_bound = static_cast<const int*>(kv_bound);
    ch.kv_low = static_cast<const int*>(kv_low);
    ch.bound_causal = bound_causal && kv_bound != nullptr;
    ch.bound_only = !causal;  // no diagonal but bound_causal's (kNoDiag without it)
    return qv != nullptr
               ? launch<true, true, true>(q, qv, k, v, out, p, batch, head_dim, stream, ch)
               : launch<false, true, true>(q, qv, k, v, out, p, batch, head_dim, stream, ch);
  }
  if (qv != nullptr) {
    return causal ? launch<true, true>(q, qv, k, v, out, p, batch, head_dim, stream)
                  : launch<true, false>(q, qv, k, v, out, p, batch, head_dim, stream);
  }
  return causal ? launch<false, true>(q, qv, k, v, out, p, batch, head_dim, stream)
                : launch<false, false>(q, qv, k, v, out, p, batch, head_dim, stream);
}
