// B7 (flash_bwd.cu) at head dim 256 (GPT-J-6B, Gemma): a main kernel of its
// own, flash_bwd_d256_kernel, in a source of its own so that nvcc compiles
// it beside flash_bwd.cu's (one nvcc per source, all started together). The
// delta and dQ passes are flash_bwd.cu's, and the function is B7's one
// pass: dQ (B7a, _dq_kernel) and dK / dV (B7b, _dkv_kernel, the GQA group
// summed), causal or not. The channels are flash_bwd_d256_channels_kernel,
// the same body (d256_cta) with template flags: B1's key range (RANGE, this
// file), the window / softcap over the range (flash_bwd_d256_window.cu), and
// the segment walk alone or with them (flash_bwd_d256_segments.cu): what
// flash_bwd.cu's RANGE / WINDOW / SOFTCAP / segment instantiations take at D
// 64 and 128, but ALiBi and dropout.
//
// Why a kernel of its own. flash_bwd.cu's CTA owns 128 keys, 64 per
// warpgroup, and each warpgroup keeps its keys' dK and dV over every column
// in registers: at D 256 that is 64 x 256 x 2 fp32 a warpgroup, 256
// registers a thread, and its shared memory (K, V, a three-stage Q / dO
// ring, dS^T, the fp32 dQ tile) would come to ~330 KB. Here:
//
// * A CTA owns 64 keys. Both warpgroups hold dK and dV of all 64 keys,
//   warpgroup wg the columns 128 wg .. 128 wg + 127 (64 + 64 registers a
//   thread).
// * Per 64-row step of the walk each warpgroup computes S^T = K Q^T and
//   dP^T = V dO^T for its 32 of the step's rows (m64n32 over 16 k-steps, so
//   no product is computed twice), P^T = exp2(S^T scale log2e - lse2)
//   (masked entries 0) and dS^T = P^T (dP^T - delta) scale, and writes both
//   as bf16 into shared memory ([key][row], 128-byte swizzle). After a CTA
//   barrier each warpgroup runs on its 128 columns dV += P^T dO and dK +=
//   dS^T Q (A from shared memory, K-major) and dQ_part = dS K (the same dS^T
//   tile as the MN-major A operand).
// * dQ_part, 64 rows x 128 columns a warpgroup in fp32, is added to the
//   fp32 accumulator by float4 atomics straight from registers, in the
//   accumulator's thread order (flash_bwd.cu's dq_accum layout): its 64 KB
//   staging tile would not fit beside the rest.
// * Shared memory: K and V 32 KB each, a two-stage ring of Q and dO (32 KB
//   each a stage), P^T and dS^T 8 KB each: 208 KB. Thread 0 loads step
//   it + 1 at the top of step it, once both warpgroups are past step
//   it - 1.
// As in flash_bwd.cu P and dS are rounded to bf16 before they feed a
// product, every product accumulates in fp32, dK and dV are bit-stable (the
// group sum stays in one CTA's registers) and dQ's last bits may change
// from run to run. Rows with lse -inf (no valid key) add 0.
//
// What bounds it on the H100: tensor-core throughput over the pairs (10 D
// FLOPs each), with each step's 64 KB of Q and dO feeding 10.5 MFLOP, 160
// FLOP a byte, under the card's ~295: the loads come mostly from L2 (the
// 64-key CTAs of a head read the same Q and dO), and the products of a
// step wait on its softmax (no overlap across steps).
//
// The channels, as flash_bwd.cu's bwd_cta takes them. RANGE: the CTA reads
// its batch's KeyRange once (key_mask.cuh:key_range), starts a causal walk
// at the range's diagonal, walks nothing when its 64 keys lie wholly past
// the limit or below the low key, and tests the limit and the low key per
// element only where its keys cross them. WINDOW: only the 64-row steps
// whose rows' windows reach the CTA's keys (bwd_cta's rows, mirrored from
// B1's window_range, at 64 keys), and the per-element test only where a
// warp's 16 keys and the warpgroup's 32 rows are not all inside each other's
// windows. SOFTCAP: B1's capped scores t = tanh(s scale / cap)
// (key_mask.cuh:softcap_tanh), P = exp2(cap t log2(e) - lse2), dS = P (dP -
// delta) (1 - t^2) scale. SEG (batch 1): ops/segments.py's row range and id
// span are per 128 keys, so a 64-key CTA walks the q rows of the 128-key
// tile that holds it and tests its keys against that tile's span (both
// supersets: sound, at most a few steps more); each 64-row step's span is
// its own. Each channel's state is a few registers (the range, the window's
// two bounds, the cap's two constants, the keys' ids); no shared memory is
// added, and the channel-free kernel keeps its code.
#define LITE_BWD_TEMPLATES_ONLY
#include "flash_bwd.cu"

namespace lite {
namespace bwd {
namespace d256 {

constexpr int D = 256;
constexpr int kAtoms = D / 64;
constexpr int kKeys = 64;           // keys per CTA
constexpr int kSpanKeys = 128;      // keys of the segment walk's row ranges and id spans
constexpr int kStages = 2;          // Q / dO ring depth
constexpr int kCols = D / 2;        // dK, dV and dQ columns of each warpgroup
constexpr int kWgRows = kRows / 2;  // a step's rows whose S^T and dP^T each warpgroup computes

// Shared-memory layout (byte offsets from a 1024-byte aligned base); tiles
// in 64-value atoms of 128-byte rows.
struct Smem {
  static constexpr int kKV = kKeys * kAtoms * 128;  // one K or V tile
  static constexpr int kQ = kRows * kAtoms * 128;   // one Q or dO tile
  static constexpr int kP = kKeys * kRows * 2;      // P^T or dS^T, bf16 [64 keys][64 rows]
  static constexpr int k = 0;
  static constexpr int v = k + kKV;
  static constexpr int q = v + kKV;              // [kStages]
  static constexpr int dout = q + kStages * kQ;  // [kStages]
  static constexpr int pt = dout + kStages * kQ;
  static constexpr int dst = pt + kP;
  static constexpr int lse2 = dst + kP;  // [kStages][64]
  static constexpr int delta = lse2 + kStages * kRows * 4;
  static constexpr int bars = delta + kStages * kRows * 4;  // kv, full[kStages]
  static constexpr int bytes = bars + (1 + kStages) * 8;
};
static_assert(Smem::bytes + 1024 <= 232448, "227 KB of shared memory a block");

// K and V of the CTA's 64 keys, once.
__device__ __forceinline__ void load_kv(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                        unsigned char* smem, int k0, int kvh) {
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  sm90::mbar_expect_tx(kv_full, 2 * Smem::kKV);
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
    sm90::tma_load_3d(smem + Smem::k + a * kKeys * 128, &tm_k, kv_full, 64 * a, k0, kvh);
    sm90::tma_load_3d(smem + Smem::v + a * kKeys * 128, &tm_v, kv_full, 64 * a, k0, kvh);
  }
}

// Step (q-head bh, rows row0..): Q and dO (TMA) and their lse2 and delta
// rows (bulk copies) into ring stage `stage`.
__device__ __forceinline__ void load_step(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                                          const Params& p, unsigned char* smem, int stage, int bh,
                                          int row0) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::bars) + 1 + stage;
  sm90::mbar_expect_tx(full, 2 * Smem::kQ + 2 * kRows * 4);
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
    sm90::tma_load_3d(smem + Smem::q + stage * Smem::kQ + a * kRows * 128, &tm_q, full, 64 * a,
                      row0, bh);
    sm90::tma_load_3d(smem + Smem::dout + stage * Smem::kQ + a * kRows * 128, &tm_do, full,
                      64 * a, row0, bh);
  }
  const size_t stat = static_cast<size_t>(bh) * p.seqlen_q_pad + row0;
  sm90::bulk_load(smem + Smem::lse2 + stage * kRows * 4, p.lse2 + stat, kRows * 4, full);
  sm90::bulk_load(smem + Smem::delta + stage * kRows * 4, p.delta + stat, kRows * 4, full);
}

// One CTA per (64-key tile, b, kv-head), k-tile slowest (the longest causal
// walks start first); the walk is flash_bwd.cu's (Walk: the group's q-heads
// in turn, 64-row steps from the k-tile's diagonal, or non-causal from a
// q-tile that moves with the k-tile), narrowed by the channels: RANGE the
// key range of `c`, SEG its segment ids, WINDOW its window, SOFTCAP its cap.
template <bool CAUSAL, bool RANGE, bool SEG, bool WINDOW, bool SOFTCAP>
__device__ __forceinline__ void d256_cta(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                         const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                         const Params& p, const Channels& c) {
  static_assert(!SEG || !RANGE, "segments without the key range");
  static_assert(!(WINDOW || SOFTCAP) || RANGE || SEG,
                "window and softcap run in the RANGE and segment instantiations");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  uint64_t* full = kv_full + 1;

  const int bhk = p.batch * p.kv_heads;
  const int kt = blockIdx.x / bhk;
  const int b = (blockIdx.x % bhk) / p.kv_heads;
  const int hk = blockIdx.x % p.kv_heads;
  const int k0 = kt * kKeys;
  const int group = p.heads / p.kv_heads;
  const KeyRange range = RANGE ? key_range(c, b, p.seqlen_q, p.seqlen_k, p.causal_offset)
                               : KeyRange{0, p.seqlen_k, p.causal_offset, 0};
  // flash_bwd.cu's walk at 64 keys; SEG: the q rows of the 128-key tile
  // that holds them.
  Window wnd{};
  const int2 rows =
      walk_rows<kKeys, CAUSAL, RANGE, SEG, WINDOW>(p, c, range, wnd, b, k0, k0 / kSpanKeys);
  const int q_first = rows.x, nq = rows.y;
  const int ktiles = (p.seqlen_k + kKeys - 1) / kKeys;
  const Walk walk{b * p.heads + hk * group, q_first, nq, CAUSAL ? 0 : kt * nq / ktiles};
  const int n_iter = group * nq;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_iter > 0) {
    load_kv(tm_k, tm_v, smem, k0, b * p.kv_heads + hk);
    load_step(tm_q, tm_do, p, smem, 0, walk.bh(0), walk.row0(0));
  }

  const int ct = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, ct / 128, 0);  // warp-uniform to the compiler
  const int tw = ct % 128;
  const int warp = tw / 32;
  const int g = (tw % 32) / 4;
  const int t = tw % 4;
  const int key_lo = k0 + 16 * warp + g;  // this thread's keys: key_lo, key_lo + 8
  // Keys that cross the range's limit (or, RANGE, its low key) test it per
  // element; the diagonal is the range's (the bound's with bound_causal).
  const bool ragged = RANGE ? k0 + kKeys > range.lim || k0 < range.low : k0 + kKeys > p.seqlen_k;
  const int diag_off = RANGE ? range.diag : p.causal_offset;
  // SEG: this thread's keys' ids and the 128-key tile's least and largest
  // (the ids are padded to whole 128-key tiles).
  int kid_lo = 0, kid_hi = 0;
  int2 k_span{};
  if constexpr (SEG) {
    kid_lo = __ldg(c.k_seg + key_lo);
    kid_hi = __ldg(c.k_seg + key_lo + 8);
    k_span = __ldg(c.k_span + k0 / kSpanKeys);
  }
  // WINDOW: key - row must lie in [win_lo, win_hi] (the row's window about
  // pos = row + wnd.off). SOFTCAP: tanh's exp2 argument per raw score and
  // cap log2(e), as B1's.
  int win_lo = -kNoBound, win_hi = kNoBound;
  if constexpr (WINDOW) {
    if (wnd.left >= 0) win_lo = wnd.off - wnd.left;
    if (wnd.right >= 0) win_hi = wnd.off + wnd.right;
  }
  float cap_k = 0.f, cap_log2 = 0.f;
  if constexpr (SOFTCAP) {
    cap_k = 2.f * p.scale_log2 / c.cap;
    cap_log2 = c.cap * kLog2e;
  }
  const uint32_t k_addr = sm90::smem_u32(smem + Smem::k);
  const uint32_t pt_addr = sm90::smem_u32(smem + Smem::pt);
  const uint32_t dst_addr = sm90::smem_u32(smem + Smem::dst);
  // K and V, all 64 keys, as the K-major A operands of S^T and dP^T; P^T and
  // dS^T as the K-major A operands of dV and dK; dS^T as the MN-major A
  // operand of dQ = dS K, and this warpgroup's columns of K as its MN-major
  // B operand (two atoms, kKeys * 128 bytes apart).
  const uint64_t k_desc = desc_sw128(k_addr, 16, 1024);
  const uint64_t v_desc = desc_sw128(sm90::smem_u32(smem + Smem::v), 16, 1024);
  const uint64_t pt_desc = desc_sw128(pt_addr, 16, 1024);
  const uint64_t dst_desc = desc_sw128(dst_addr, 16, 1024);
  const uint64_t ds_desc = desc_sw128(dst_addr, kRows * 128, 1024);
  const uint64_t kt_desc = desc_sw128(k_addr + 2 * wg * kKeys * 128, kKeys * 128, 1024);
  unsigned char* pt_smem = smem + Smem::pt;
  unsigned char* dst_smem = smem + Smem::dst;

  float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_iter > 0) sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % kStages;
    const int bh = walk.bh(it);
    const int row0 = walk.row0(it);
    // Both warpgroups are past step it - 1 (its wgmmas retired): its ring
    // stage, P^T and dS^T are free. Step it + 1 loads into that stage.
    sm90::named_sync(1, kThreads);
    if (ct == 0 && it + 1 < n_iter) {
      load_step(tm_q, tm_do, p, smem, (it + 1) % kStages, walk.bh(it + 1), walk.row0(it + 1));
    }
    const uint32_t q_addr = sm90::smem_u32(smem + Smem::q + stage * Smem::kQ);
    const uint32_t do_addr = sm90::smem_u32(smem + Smem::dout + stage * Smem::kQ);
    // This warpgroup's 32 rows of Q and dO as K-major B operands (S^T,
    // dP^T); its 128 columns of Q and dO as MN-major B operands (dK, dV:
    // rows of 64 values, atoms kRows * 128 bytes apart).
    const uint64_t q_desc = desc_sw128(q_addr + wg * kWgRows * 128, 16, 1024);
    const uint64_t do_desc = desc_sw128(do_addr + wg * kWgRows * 128, 16, 1024);
    const uint64_t qt_desc = desc_sw128(q_addr + 2 * wg * kRows * 128, kRows * 128, 1024);
    const uint64_t dot_desc = desc_sw128(do_addr + 2 * wg * kRows * 128, kRows * 128, 1024);
    const float* lse2 = reinterpret_cast<const float*>(smem + Smem::lse2) + stage * kRows;
    const float* delta = reinterpret_cast<const float*>(smem + Smem::delta) + stage * kRows;
    sm90::mbar_wait(&full[stage], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's rows: [64 keys x
    // 32 rows] each, K-major.
    float s[kWgRows / 2], dp[kWgRows / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      sm90::wgmma_ss_n32<0, 0>(s, sm90::desc_add(k_desc, koff), sm90::desc_add(q_desc, qoff),
                               kk > 0);
    }
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      sm90::wgmma_ss_n32<0, 0>(dp, sm90::desc_add(v_desc, koff), sm90::desc_add(do_desc, qoff),
                               kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T (masked entries 0) and dS^T; off the ragged tile and the tiles
    // that cross this warp's diagonal the test's bounds move out of reach.
    // s[4 j + 2 i + c] is key key_lo + 8 i, row 32 wg + 8 j + 2 t + c.
    const bool diag = CAUSAL && k0 + 16 * warp + 15 > row0 + wg * kWgRows + diag_off;
    // SEG: the step's rows and the 128-key tile's keys are not all of one
    // segment.
    const bool seg_test = SEG && !one_segment(k_span, __ldg(c.q_span + row0 / kRows));
    // WINDOW: this warp's 16 keys and the warpgroup's 32 rows are not all
    // inside each other's windows (key - row spans [k - r - 31, k + 15 - r]
    // from the warp's first key k and the warpgroup's first row r).
    const int kr0 = k0 + 16 * warp - (row0 + wg * kWgRows);
    const bool win_test = WINDOW && (kr0 - (kWgRows - 1) < win_lo || kr0 + 15 > win_hi);
#pragma unroll
    for (int e = 0; e < kWgRows / 2; ++e) {
      const int qc = wg * kWgRows + 8 * (e / 4) + 2 * t + (e & 1);
      const int key = key_lo + 8 * ((e >> 1) & 1);
      const bool masked = entry_masked<CAUSAL, RANGE, SEG, WINDOW>(
          p, c, range, diag_off, key, row0 + qc, ragged, diag, seg_test,
          (e >> 1) & 1 ? kid_hi : kid_lo, win_test, win_lo, win_hi);
      if constexpr (SOFTCAP) {
        // The cap's derivative 1 - tanh^2, taken before the mask as JAX
        // takes it, times the scale.
        const float tc = softcap_tanh(s[e] * cap_k);
        s[e] = masked ? 0.f : ex2(fmaf(cap_log2, tc, -lse2[qc]));
        dp[e] = s[e] * (dp[e] - delta[qc]) * (p.scale * fmaf(-tc, tc, 1.f));
      } else {
        s[e] = masked ? 0.f : ex2(s[e] * p.scale_log2 - lse2[qc]);
        dp[e] = s[e] * (dp[e] - delta[qc]) * p.scale;
      }
    }
    // Both as bf16 into shared memory, [key][row], 128-byte swizzle.
#pragma unroll
    for (int j = 0; j < kWgRows / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = 16 * warp + g + 8 * i;
        const int row = wg * kWgRows + 8 * j + 2 * t;
        const int off = key * 128 + (((row >> 3) ^ (key & 7)) << 4) + (row & 7) * 2;
        *reinterpret_cast<uint32_t*>(pt_smem + off) =
            sm90::pack_bf16x2(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dst_smem + off) =
            sm90::pack_bf16x2(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_sync(2, kThreads);  // P^T and dS^T complete

    // On this warpgroup's columns: dV += P^T dO, dK += dS^T Q, dQ_part = dS K.
    float dq[kCols / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      sm90::wgmma_ss_n128<0, 1>(dv, sm90::desc_add(pt_desc, kk * 32),
                                sm90::desc_add(dot_desc, kk * 2048), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      sm90::wgmma_ss_n128<0, 1>(dk, sm90::desc_add(dst_desc, kk * 32),
                                sm90::desc_add(qt_desc, kk * 2048), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      sm90::wgmma_ss_n128<1, 1>(dq, sm90::desc_add(ds_desc, kk * 2048),
                                sm90::desc_add(kt_desc, kk * 2048), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);

    // dQ_part into the accumulator, float4 j of thread tw at chunk c * 128 +
    // tw (columns 8 c .., rows 16 warp + g and + 8), as bwd_post reads it.
    float4* acc = reinterpret_cast<float4*>(
        p.dq_accum + (static_cast<size_t>(bh) * p.seqlen_q_pad + row0) * D);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int c = wg * (kCols / 8) + j;
      atomicAdd(acc + c * 128 + tw, make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2],
                                                dq[4 * j + 3]));
    }
  }

  // dK, dV (the group's sum) as bf16: rows key_lo and key_lo + 8, this
  // warpgroup's columns.
  const size_t kvh = static_cast<size_t>(b) * p.kv_heads + hk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= p.seqlen_k) continue;
    __nv_bfloat16* dk_row = p.dk + (kvh * p.seqlen_k + key) * D + wg * kCols;
    __nv_bfloat16* dv_row = p.dv + (kvh * p.seqlen_k + key) * D + wg * kCols;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_row + col) =
          sm90::pack_bf16x2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + col) =
          sm90::pack_bf16x2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// The channel-free main kernel (GPT-J's).
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const Params p) {
  d256_cta<CAUSAL, false, false, false, false>(tm_q, tm_k, tm_v, tm_do, p, Channels{});
}

// The channels: B1's key range (this file), the window / softcap over it
// (flash_bwd_d256_window.cu), the segment walk alone or with them
// (flash_bwd_d256_segments.cu).
template <bool CAUSAL, bool RANGE, bool SEG, bool WINDOW, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_d256_channels_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do, const Params p,
                                   const Channels c) {
  d256_cta<CAUSAL, RANGE, SEG, WINDOW, SOFTCAP>(tm_q, tm_k, tm_v, tm_do, p, c);
}

// The three launches: delta (flash_bwd.cu's bwd_pre_kernel), the main
// kernel (channel-free, or the instantiation of the channels in `c`), dQ to
// bf16 (flash_bwd.cu's bwd_post_kernel).
template <bool CAUSAL, bool RANGE = false, bool SEG = false, bool WINDOW = false,
          bool SOFTCAP = false>
cudaError_t run(const Args& a, cudaStream_t stream, const Channels& c = Channels{}) {
  const int sq_pad = (a.seqlen_q + kRows - 1) / kRows * kRows;
  const int rows = a.batch * a.heads * sq_pad;
  constexpr int kPreThreads = 256;
  const long long pre_threads = static_cast<long long>(rows) * pre_lanes(D);
  const int pre_blocks = static_cast<int>((pre_threads + kPreThreads - 1) / kPreThreads);
  bwd_pre_kernel<D, false><<<pre_blocks, kPreThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.lse2),
      static_cast<float*>(a.delta), static_cast<float*>(a.dq_accum), a.seqlen_q, sq_pad, rows,
      LseShift{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int bh = a.batch * a.heads, bhk = a.batch * a.kv_heads;
  if ((err = sm90::make_tensor_map_3d(&tm_q, a.q, D, a.seqlen_q, bh, 64, kRows)) ||
      (err = sm90::make_tensor_map_3d(&tm_do, a.dout, D, a.seqlen_q, bh, 64, kRows)) ||
      (err = sm90::make_tensor_map_3d(&tm_k, a.k, D, a.seqlen_k, bhk, 64, kKeys)) ||
      (err = sm90::make_tensor_map_3d(&tm_v, a.v, D, a.seqlen_k, bhk, 64, kKeys))) {
    return err;
  }
  Params p{};
  p.dq_accum = static_cast<float*>(a.dq_accum);
  p.lse2 = static_cast<const float*>(a.lse2);
  p.delta = static_cast<const float*>(a.delta);
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.batch = a.batch;
  p.heads = a.heads;
  p.kv_heads = a.kv_heads;
  p.seqlen_q = a.seqlen_q;
  p.seqlen_k = a.seqlen_k;
  p.seqlen_q_pad = sq_pad;
  p.causal_offset = a.seqlen_k - a.seqlen_q;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  constexpr int smem = Smem::bytes + 1024;  // + alignment of the base
  const int ktiles = (a.seqlen_k + kKeys - 1) / kKeys;
  if constexpr (RANGE || SEG || WINDOW || SOFTCAP) {
    auto kernel = flash_bwd_d256_channels_kernel<CAUSAL, RANGE, SEG, WINDOW, SOFTCAP>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<ktiles * bhk, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p, c);
  } else {
    auto kernel = flash_bwd_d256_kernel<CAUSAL>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<ktiles * bhk, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_post_kernel<D><<<dim3(sq_pad / kRows, bh), 256, 0, stream>>>(
      static_cast<const float*>(a.dq_accum), static_cast<__nv_bfloat16*>(a.dq), a.seqlen_q,
      sq_pad);
  return cudaGetLastError();
}

}  // namespace d256

// flash_bwd_d256_window.cu and flash_bwd_d256_segments.cu include the
// templates above and none of the functions below.
#ifndef LITE_BWD_D256_TEMPLATES_ONLY

cudaError_t run_d256(bool causal, const Args& a, cudaStream_t stream) {
  return causal ? d256::run<true>(a, stream) : d256::run<false>(a, stream);
}

// B1's key range (kv_bound, kv_low, bound_causal; the RANGE instantiations,
// CAUSAL when `diag`); no ALiBi at 256.
cudaError_t run_masked_d256(bool diag, const Args& a, const Channels& c, cudaStream_t stream) {
  if (c.alibi != nullptr) return cudaErrorInvalidValue;
  return diag ? d256::run<true, true>(a, stream, c) : d256::run<false, true>(a, stream, c);
}

#endif  // LITE_BWD_D256_TEMPLATES_ONLY

}  // namespace bwd
}  // namespace lite
