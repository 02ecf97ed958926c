// B1: dense flash-attention forward on Hopper (flash_fwd_kernel), replacing
// the Pallas kernel liteattention_tpu/ops/flash_fwd.py:_fwd_kernel. The same
// kernel, walking a list of live k-tiles, is B3 (lite_flash_fwd_gather),
// replacing liteattention_tpu/ops/lite_flash_fwd.py:_lite_gather_kernel, and
// with `fold` heads per CTA B5, replacing _lite_gather_kernel_hfold; walking
// a coarse schedule's entries it is B4 (lite_flash_fwd_coarse), replacing
// _lite_kernel. Below it, B1's MLA channels (mla_fwd_kernel).
//
// bf16 q/k/v in [B, H, S, D] (D = 64 or 128), GQA by h / group, optionally
// causal (bottom-right aligned, offset Sk - Sq); ragged Sq and Sk. Out in
// bf16, lse fp32 natural log; a row with no valid key gets out 0, lse -inf.
//
// What bounds it on the H100: tensor-core issue (4 D FLOPs per (q row, key)
// pair; each K/V byte loaded feeds 128 q rows), and close behind it the
// MUFU: a 128 x 128 tile at D 128 is 8.4 MFLOP, ~1.1 us of one SM's tensor
// cores, and its 16 384 exp2 take ~0.6 us at 16 a clock (at D 64 the two
// are about equal). So the products run on wgmma, the loads take no issue
// slots (TMA), and a tile's softmax runs while products are in flight. The
// sparse walks (B3, B4, B5) are bound the same way on the tiles they visit:
// a skipped tile costs no load and no math.
//
// One CTA per (b, h, 128-row q-tile), 256 threads: two consumer warpgroups
// of 64 q rows each. O, S and P take 186 of a thread's 255 registers at D
// 128; with a producer warp (288 threads) ptxas gives 166 and spills
// (b1_ablation.py, producer_warp), so thread 0 also issues the TMA loads
// (128-byte swizzle; 3-D tensor maps over [B * H, S, D], so a ragged tail
// reads zeros, never the next head's rows): Q once, K and V per 128-key
// tile into a ring of kStages stages. Each stage has a full barrier
// (expect-tx bytes) and an empty barrier that every warp arrives on once
// its wgmmas that read the stage have retired. No __syncthreads in the
// loop. Per warpgroup and k-tile j of the walk:
//   S_{j+1} = Q K_{j+1}^T   wgmma m64n128k16, both operands in shared memory
//   O += P_j V_j            wgmma RS: P_j bf16 in registers, V MN-major
//   (thread 0: refill tile j - 1's stage with tile j + 2 under the products)
//   wait for S_{j+1}; mask and online softmax (the row steps of
//   attention_fwd.cuh on the accumulator as it lies; the softmax scale is
//   folded into each exp2's FFMA) while PV_j runs; wait for PV_j; rescale
//   O; P_{j+1} to bf16 registers; release stage j.
// The warpgroups take turns to issue their products (two named barriers),
// so that one's softmax runs under the other's products. Every wgmma is
// issued outside a branch: the walk visits at least one tile, and the last
// tile's PV is peeled off the loop (under a branch ptxas serialises them
// and says so in a performance advisory; b1_ablation.py,
// wgmma_under_branch). Only the ragged last tile and tiles that cross a
// warp's diagonal pay the per-element mask (key_mask.cuh, B7's test).
// Causal walks stop at the q-tile's diagonal, and q-tiles run in reverse
// order so the longest walks start first. Epilogue: each warpgroup writes
// its normalised rows into its own half of the Q buffer and stores them by
// TMA (rows >= Sq are clipped); lse from each quad's first lane. An
// mbarrier wait traps after 2^28 tries, so a pipeline fault fails the
// launch instead of holding the card.
//
// The walk is a template parameter. The dense walk (B1) visits tiles 0 ..
// n - 1. The list walk (B3) visits the entries fidx[0 .. count) of its (b,
// h, q-tile) row, the live fine k-tiles in increasing order, and loads
// entry j from tile lidx[j] of a union-compacted K/V buffer when the caller
// passes one (B6's output; the tensor maps then describe that buffer), else
// from fidx[j]. Skipped tiles cost no load and no math: what was 3.5x its
// bound on the first version's mma.sync loop runs at B1's rate on half the
// tiles. The list stays in global memory (at D 128 B1's Q buffer and ring
// leave under 2 KB of shared memory, a row of 576 tiles needs 2.3 KB): each
// thread reads entry j + 2 one step ahead, and thread 0 the entry it loads
// next. A row with no live tile (count 0, or fidx[0] dead in the mask) still
// visits one tile, with every key hidden: out 0, lse -inf.
//
// The coarse walks (B4) visit the entries kv_idx[0 .. count) of the coarse
// row (block_q = 128 qsub, block_k = 128 ksub) that holds the CTA's fine
// q-tile: entry e is the fine k-tiles kv_idx[e] ksub + s inside [0, Kt), and
// in super-tile mode only those whose bit of bits[e] is set for this q-tile.
// The CTA counts its visits before the loop (a popcount per entry), so n is
// known and every wgmma stays outside a branch; thread 0's feed and each
// thread's place step (entry, sub-tile) with __ffs, the threads' one step
// ahead under the products. A walk with no visit computes tile 0 with every
// key hidden (out 0, lse -inf) and votes nothing.
//
// The votes (VOTES), as the JAX kernels' contract (attention_fwd.cuh): a
// vote step is gsize list entries, or one coarse entry; m_prev, the running
// row max before the step, is snapshotted at the top of the step's first
// tile, before that tile's math; the tile's raw row maxima x scale_log2 are
// compared with it before softmax_rows absorbs them, strictly (> thr), on
// valid rows only. The OR over the tile's 128 rows takes no CTA barrier (the
// warpgroups run out of phase): the wrapper fills the votes with 1 (skip)
// and every warp with a passing row stores 0 (__any_sync), idempotent stores
// in any order; the first entry is stored 0 by thread 0 at the start. Coarse
// votes go to the coarse tile, so the plain stores of a coarse row's qsub
// CTAs are the AND of their votes; the coarse walks clamp both sides to the
// JAX kernel's finite mask value. emit_votes=False compiles the vote chain
// out of B3.
//
// Folded heads (FOLD, B5): one CTA walks `fold` heads' rows in turn. The
// ring runs on across heads: the walks are one flat sequence of tiles, so
// the next head's first tiles load under the current head's last products,
// and each head's last stage is released when its last P V retires. Q of
// the next head loads only after both warpgroups' epilogue stores have read
// the Q buffer (bulk_wait_read, then a CTA barrier). Out, lse and votes are
// B3's bit for bit: the per-head arithmetic is the same.
#include "attention_fwd.cuh"
#include "sm90.cuh"

namespace lite {
namespace fwd {

using sm90::desc_sw128;

constexpr int kRowsQ = 128;  // q rows per CTA, 64 per warpgroup
constexpr int kKeys = 128;   // keys per k-tile
constexpr int kStages = 3;   // K/V ring depth
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTurn = 3;  // named barriers kTurn, kTurn + 1: the warpgroups' turns to issue

// The walk over k-tiles: dense (B1), a live-tile list (B3, B5), or the
// coarse schedule's entries (B4), in coarse or super-tile mode.
enum Walk { kDense, kList, kCoarse, kSuper };

struct Params {
  float* lse;  // [B, H, Sq]
  int heads, kv_heads, seqlen_q, seqlen_k, qtiles, ktiles;
  int causal_offset;  // Sk - Sq
  float scale_log2;   // softmax scale * log2(e)
  // The list walk (B3, B5); fidx and count are also the coarse schedule.
  const int* fidx;      // [B, H, Qt, Kt] live fine k-tiles per row, increasing
  const int* count;     // [B, H, Qt] entries per row
  const int* lidx;      // load positions aligned with fidx, or null
  const uint8_t* mask;  // [B, H, Qt, Kt] the fine mask the list came from
  int* votes;           // [B, H, Qt, Kt] (VOTES), pre-filled with 1
  int gsize;            // entries per vote step
  int fold;             // heads per CTA (FOLD)
  float thr;            // vote threshold, log2 space
  // The coarse walks (B4): kv_idx [B, H, sched_q, sched_k] (fidx) and count
  // [B, H, sched_q] at block_q = 128 qsub, block_k = 128 ksub; votes [B, H,
  // vote_q, vote_k], coarse (kCoarse) or fine (kSuper).
  const int* bits;  // kSuper: sub-tile liveness aligned with kv_idx
  int qsub, ksub, sched_q, sched_k, vote_q, vote_k;
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base). Each
// tile is stored as 64-value atoms of 128-byte rows (TMA's 128-byte
// swizzle), atom a at a * rows * 128.
template <int D>
struct Smem {
  static constexpr int kQ = kRowsQ * D * 2;  // the Q tile
  static constexpr int kKV = kKeys * D * 2;  // one K or V tile
  static constexpr int kStage = 2 * kKV;     // K, then V
  static constexpr int q = 0;
  static constexpr int ring = q + kQ;        // [kStages]
  static constexpr int bars = ring + kStages * kStage;  // full, empty [kStages]; q_full
  static constexpr int bytes = bars + (2 * kStages + 1) * 8;
};

// The k-tiles a CTA visits, in order: n >= 1 of them, so that every wgmma
// of the mainloop is issued outside a branch (ptxas serialises wgmmas in a
// path it cannot prove uniform). The dense walk: tile j = j for j < n, n
// ending at the last tile the q-tile's last row reaches when causal; a
// q-tile whose rows see no key still visits tile 0, where the mask hides
// every key (out 0, lse -inf).
struct DenseWalk {
  int n;
  static constexpr bool dead = false;
  __device__ __forceinline__ int tile(int j) const { return j; }
};

template <bool CAUSAL>
__device__ __forceinline__ DenseWalk dense_walk(const Params& p, int q0) {
  if constexpr (CAUSAL) {
    const int last = q0 + kRowsQ - 1 + p.causal_offset;  // the last row's last key
    return {min(p.ktiles, max(last, 0) / kKeys + 1)};
  }
  return {p.ktiles};
}

// The list walk of row (b, h, q-tile): entries fidx[0 .. n), n >= 1; a
// row with no live tile visits fidx[0] with every key hidden.
struct ListWalk {
  const int* sched;
  int n;
  bool dead;
  __device__ __forceinline__ int tile(int j) const { return __ldg(sched + j); }
};

__device__ __forceinline__ ListWalk list_walk(const Params& p, size_t row) {
  ListWalk w;
  w.sched = p.fidx + row * p.ktiles;
  const int count = __ldg(p.count + row);
  w.n = max(count, 1);
  w.dead = count < 1 || !p.mask[row * p.ktiles + w.tile(0)];
  return w;
}

// What thread 0 loads for the list walks, in order: their load positions
// (lidx, or fidx), head by head. (The dense walk loads tile f at step f.)
struct ListFeed {
  int hl, j, n, bhk;
  const int* lrow;

  __device__ __forceinline__ void open(const Params& p, int b, int h, int qt) {
    const size_t row = (static_cast<size_t>(b) * p.heads + h) * p.qtiles + qt;
    j = 0;
    n = max(__ldg(p.count + row), 1);
    bhk = b * p.kv_heads + h / (p.heads / p.kv_heads);
    lrow = (p.lidx != nullptr ? p.lidx : p.fidx) + row * p.ktiles;
  }

  __device__ __forceinline__ bool more(int fold) const { return hl < fold; }

  // The next tile to load and its (b, kv head) in bhk_out.
  __device__ __forceinline__ int take(const Params& p, int b, int h0, int qt, int fold,
                                      int& bhk_out) {
    bhk_out = bhk;
    const int tile = __ldg(lrow + j);
    if (++j == n && ++hl < fold) open(p, b, h0 + hl, qt);
    return tile;
  }
};

// The coarse walks (B4) of fine q-tile qt: entry e of its coarse row qt /
// qsub (kv_idx[e], e < count) covers fine k-tiles kv_idx[e] * ksub + s for s
// < ksub, inside [0, Kt); in super-tile mode tile s only if bit (qt % qsub)
// ksub + s of bits[e] is set (the order _coarse_walk gives the plain
// version). n, the tiles visited, is counted before the loop (a popcount of
// each entry's slice, the warp's lanes over the entries); a walk with none
// visits tile 0 with every key hidden, and votes nothing.
template <bool SUPER>
struct CoarseWalk {
  const int* sched;
  const int* bits;
  int count, ksub, shift, ktiles;
  int n;
  bool dead;

  // Entry e's coarse tile (idx) and the fine tiles of it this q-tile visits.
  __device__ __forceinline__ unsigned live(int e, int& idx) const {
    idx = __ldg(sched + e);
    const int inside = max(min(ktiles - idx * ksub, ksub), 0);
    unsigned m = inside >= 32 ? 0xffffffffu : (1u << inside) - 1u;
    if constexpr (SUPER) m &= static_cast<unsigned>(__ldg(bits + e)) >> shift;
    return m;
  }
};

template <bool SUPER>
__device__ __forceinline__ CoarseWalk<SUPER> coarse_walk(const Params& p, size_t bh, int qt) {
  CoarseWalk<SUPER> w;
  const size_t srow = bh * p.sched_q + qt / p.qsub;
  w.sched = p.fidx + srow * p.sched_k;
  w.bits = SUPER ? p.bits + srow * p.sched_k : nullptr;
  w.count = __ldg(p.count + srow);
  w.ksub = p.ksub;
  w.shift = (qt % p.qsub) * p.ksub;
  w.ktiles = p.ktiles;
  int visits = 0;
  for (int e = threadIdx.x % 32; e < w.count; e += 32) {
    int idx;
    visits += __popc(w.live(e, idx));
  }
  visits = __reduce_add_sync(0xffffffffu, visits);
  w.n = max(visits, 1);
  w.dead = visits == 0;
  return w;
}

// A place on a coarse walk: entry e, its coarse tile idx, the fine tile,
// whether it is the first the walk visits of its entry (a vote step starts
// there); rest holds the entry's visited sub-tiles from this one on.
struct CoarsePos {
  int e, idx, tile;
  unsigned rest;
  bool start;
};

// Step `at` to the walk's next place (from e = -1 and rest = 0, the first);
// false past the end.
template <bool SUPER>
__device__ __forceinline__ bool coarse_next(const CoarseWalk<SUPER>& w, CoarsePos& at) {
  at.rest &= at.rest - 1u;
  at.start = false;
  while (at.rest == 0) {
    if (++at.e >= w.count) return false;
    at.rest = w.live(at.e, at.idx);
    at.start = true;
  }
  at.tile = at.idx * w.ksub + __ffs(at.rest) - 1;
  return true;
}

// K and V of k-tile `tile` into ring stage `stage` (thread 0).
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                          unsigned char* smem, uint64_t* full, int stage,
                                          int tile, int bhk) {
  using L = Smem<D>;
  unsigned char* dst = smem + L::ring + stage * L::kStage;
  sm90::mbar_expect_tx(full + stage, 2 * L::kKV);
#pragma unroll
  for (int a = 0; a < D / 64; ++a) {
    sm90::tma_load_3d(dst + a * kKeys * 128, &tm_k, full + stage, 64 * a, tile * kKeys, bhk);
    sm90::tma_load_3d(dst + L::kKV + a * kKeys * 128, &tm_v, full + stage, 64 * a,
                      tile * kKeys, bhk);
  }
}

// S = Q K^T over the warpgroup's 64 rows (q_desc) and the 128 keys of the
// K tile at k_addr, both K-major: a 16-deep step moves 32 bytes inside an
// atom, then to the next atom (kRowsQ == kKeys rows on).
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t q_desc, uint32_t k_addr) {
  const uint64_t k_desc = desc_sw128(k_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
    sm90::wgmma_ss_n128<0, 0>(s, sm90::desc_add(q_desc, off), sm90::desc_add(k_desc, off),
                              kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V: P from registers, V at v_addr as the MN-major B operand (rows
// of 64 values of D, atoms kKeys * 128 bytes apart), 16 keys a step.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kKeys / 16][4],
                                         uint32_t v_addr) {
  const uint64_t v_desc = desc_sw128(v_addr, kKeys * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t db = sm90::desc_add(v_desc, kk * 2048);
    if constexpr (D == 128) {
      sm90::wgmma_rs_n128<1>(o, pf[kk], db, 1);
    } else {
      sm90::wgmma_rs_n64<1>(o, pf[kk], db, 1);
    }
  }
  sm90::wgmma_commit();
}

// Tile `tile`'s scores, masked only on the ragged tile, on tiles that cross
// this warp's diagonal and on a dead row's tile, then `vote` with the rows'
// maxima in log2 space before the running max absorbs them, then folded
// into the running row state; they stay raw until softmax_rows takes them
// to log2 space inside each exp2's FFMA (one instruction a score fewer than
// scaling first). alpha is the accumulator's rescale.
template <bool CAUSAL, typename Vote>
__device__ __forceinline__ void tile_softmax(float (&s)[16][4], const Params& p, int tile, bool dead,
                                             int warp_row0, int r_lo, int r_hi, float& m_lo,
                                             float& m_hi, float& l_lo, float& l_hi,
                                             float& alpha_lo, float& alpha_hi, Vote&& vote) {
  const int col0 = tile * kKeys;
  const bool mask = dead || col0 + kKeys > p.seqlen_k ||
                    (CAUSAL && col0 + kKeys - 1 > warp_row0 + p.causal_offset);
  float mx_lo, mx_hi;
  mask_scores(
      s, 1.f, mask, col0,
      [&](int col, bool hi) {
        return dead || key_masked<CAUSAL>(col, hi ? r_hi : r_lo, p.seqlen_k, p.causal_offset);
      },
      mx_lo, mx_hi);
  vote(mx_lo * p.scale_log2, mx_hi * p.scale_log2);
  softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, p.scale_log2);
}

template <int D, bool CAUSAL, int WALK, bool VOTES, bool FOLD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, const Params p) {
  constexpr bool LIST = WALK == kList;
  constexpr bool COARSE = WALK == kCoarse || WALK == kSuper;
  constexpr bool SUPER = WALK == kSuper;
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static_assert(kRowsQ == kKeys, "Q and K tiles step through D alike");
  static_assert(WALK != kDense || !VOTES, "the dense walk does not vote");
  static_assert(LIST || !FOLD, "folded heads take the list walk");
  static_assert(WALK == kDense || !CAUSAL, "the sparse walks are not causal");
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int qt = CAUSAL ? p.qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int b = blockIdx.z;
  const int fold = FOLD ? p.fold : 1;
  const int h0 = blockIdx.y * fold;
  const int q0 = qt * kRowsQ;
  // The dense walk: its tiles and (b, kv head), uniform over the CTA.
  const int n_dense = WALK == kDense ? dense_walk<CAUSAL>(p, q0).n : 0;
  const int bhk0 = b * p.kv_heads + h0 / (p.heads / p.kv_heads);
  ListFeed feed;
  feed.hl = 0;
  // The coarse walk (one head per CTA), and thread 0's place on it.
  CoarseWalk<SUPER> cwalk{};
  if constexpr (COARSE) cwalk = coarse_walk<SUPER>(p, static_cast<size_t>(b) * p.heads + h0, qt);
  CoarsePos fpos{-1, 0, 0, 0u, false};

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
    for (int a = 0; a < D / 64; ++a) {
      sm90::tma_load_3d(smem + L::q + a * kRowsQ * 128, &tm_q, q_full, 64 * a, q0,
                        b * p.heads + h0);
    }
    if constexpr (LIST) {
      feed.open(p, b, h0, qt);
      for (int j = 0; j < kStages && feed.more(fold); ++j) {  // a walk has n >= 1
        int bhk;
        const int tile = feed.take(p, b, h0, qt, fold, bhk);
        load_tile<D>(tm_k, tm_v, smem, full, j, tile, bhk);
      }
    } else if constexpr (COARSE) {
      for (int j = 0; j < kStages && j < cwalk.n; ++j) {  // a dead walk loads tile 0
        load_tile<D>(tm_k, tm_v, smem, full, j, coarse_next(cwalk, fpos) ? fpos.tile : 0, bhk0);
      }
    } else {
      for (int j = 0; j < kStages && j < n_dense; ++j) {  // n_dense >= 1
        load_tile<D>(tm_k, tm_v, smem, full, j, j, bhk0);
      }
    }
  }

  const int ct = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, ct / 128, 0);  // warp-uniform to the compiler
  const int tw = ct % 128;
  const int warp = tw / 32;
  const int lane = ct % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int warp_row0 = q0 + 64 * wg + 16 * warp;
  const int r_lo = warp_row0 + g;  // this thread's rows: r_lo, r_lo + 8
  const int r_hi = r_lo + 8;
  const uint64_t q_desc = desc_sw128(sm90::smem_u32(smem + L::q) + 64 * wg * 128, 16, 1024);
  const uint32_t ring = sm90::smem_u32(smem + L::ring);

  // S and O in the accumulator layout (sm90.cuh), as the row steps take
  // them: s[j][2 i + c] is d[4 j + 2 i + c].
  float s[kKeys / 8][4];
  float o[D / 8][4];
  uint32_t pf[kKeys / 16][4];  // P_j, bf16 pairs: the A operand of PV
  float(&sd)[kKeys / 2] = reinterpret_cast<float(&)[kKeys / 2]>(s);
  float(&od)[D / 2] = reinterpret_cast<float(&)[D / 2]>(o);

  // Thread 0 refills tile f - 1's stage (all eight warps released it at the
  // end of their step f - 1) with the next tile of the CTA's flat walk: on
  // the dense walk tile f - 1 + kStages, from uniform values (TMA takes its
  // coordinates in uniform registers).
  auto refill = [&](int f) {
    const int free = (f - 1) % kStages;
    if constexpr (LIST) {
      if (ct == 0 && f > 0 && feed.more(fold)) {
        sm90::mbar_wait(&empty[free], ((f - 1) / kStages) & 1);
        int bhk;
        const int load = feed.take(p, b, h0, qt, fold, bhk);
        load_tile<D>(tm_k, tm_v, smem, full, free, load, bhk);
      }
    } else if constexpr (COARSE) {
      if (ct == 0 && f > 0 && f - 1 + kStages < cwalk.n) {
        sm90::mbar_wait(&empty[free], ((f - 1) / kStages) & 1);
        coarse_next(cwalk, fpos);
        load_tile<D>(tm_k, tm_v, smem, full, free, fpos.tile, bhk0);
      }
    } else if (ct == 0 && f > 0 && f - 1 + kStages < n_dense) {
      sm90::mbar_wait(&empty[free], ((f - 1) / kStages) & 1);
      load_tile<D>(tm_k, tm_v, smem, full, free, f - 1 + kStages, bhk0);
    }
  };
  int f_head = 0;  // the head's first tile in the CTA's flat walk
  for (int hl = 0; hl < fold; ++hl) {
    const int f0 = FOLD ? f_head : 0;
    const int h = h0 + hl;
    const int bh = b * p.heads + h;
    const size_t row = static_cast<size_t>(bh) * p.qtiles + qt;
    const auto walk = [&] {
      if constexpr (LIST) {
        return list_walk(p, row);
      } else if constexpr (COARSE) {
        return cwalk;
      } else {
        return dense_walk<CAUSAL>(p, q0);
      }
    }();
    if (FOLD && hl > 0) {
      __syncthreads();  // both warpgroups' stores have read the Q buffer
      if (ct == 0) {
        sm90::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          sm90::tma_load_3d(smem + L::q + a * kRowsQ * 128, &tm_q, q_full, 64 * a, q0, bh);
        }
      }
    }
    int* vrow = nullptr;
    float mv_lo = -INFINITY, mv_hi = -INFINITY;  // running row max before the vote step
    int gpos = 0;  // place of entry j + 1 in its vote step
    if constexpr (LIST && VOTES) {
      vrow = p.votes + row * p.ktiles;
      if (ct == 0) vrow[walk.tile(0)] = 0;  // the first entry votes 0
      gpos = 1 % p.gsize;
    }
    // The coarse walks: this q-tile's place (cpos; the tile being computed,
    // then one ahead), and its votes. The first entry votes 0: coarse, its
    // coarse tile; super-tile, the entry's lowest tile this q-tile visits.
    CoarsePos cpos{-1, 0, 0, 0u, false};
    int tile0 = 0;
    if constexpr (COARSE) {
      vrow = p.votes + (static_cast<size_t>(bh) * p.vote_q + (SUPER ? qt : qt / p.qsub)) * p.vote_k;
      if (coarse_next(walk, cpos)) tile0 = cpos.tile;
      if (ct == 0 && walk.count > 0) {
        int idx;
        const unsigned live0 = walk.live(0, idx);
        if (!SUPER) {
          vrow[idx] = 0;
        } else if (live0 != 0) {
          vrow[idx * walk.ksub + __ffs(live0) - 1] = 0;
        }
      }
    } else {
      tile0 = walk.tile(0);
    }
    // A coarse vote, as the JAX kernel's: the tile's row maxima in log2
    // space against m_prev of its entry, both clamped to the JAX kernel's
    // finite mask value (m_prev -inf at entry 0), strictly, on valid rows
    // only. Every warp with a passing row stores 0 into the coarse tile's
    // vote (kCoarse: the stores of a coarse row's qsub CTAs are the AND of
    // their votes, with no atomic) or the fine tile's (kSuper).
    auto coarse_vote = [&](const CoarsePos& at, float mx_lo, float mx_hi) {
      const float mp_lo = at.e == 0 ? -INFINITY : fmaxf(mv_lo, kMaskValue);
      const float mp_hi = at.e == 0 ? -INFINITY : fmaxf(mv_hi, kMaskValue);
      const bool keep = !walk.dead &
                        (((r_lo < p.seqlen_q) & (fmaxf(mx_lo, kMaskValue) - mp_lo > p.thr)) |
                         ((r_hi < p.seqlen_q) & (fmaxf(mx_hi, kMaskValue) - mp_hi > p.thr)));
      if (__any_sync(0xffffffffu, keep) && lane == 0) vrow[SUPER ? at.tile : at.idx] = 0;
    };
    auto first_vote = [&](float mx_lo, float mx_hi) {
      if constexpr (COARSE) coarse_vote(cpos, mx_lo, mx_hi);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) od[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
    float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums
    float alpha_lo, alpha_hi;

    // S of the first tile, then per tile j: S_{j+1} and P_j V_j in flight,
    // the softmax of S_{j+1} under P_j V_j, O rescaled once P_j V_j retires.
    // The warpgroups take turns to issue their products (named barriers
    // kTurn + wg), so that one's softmax runs under the other's products;
    // warpgroup 0 goes first.
    sm90::mbar_wait(q_full, hl & 1);
    if (hl == 0 && wg == 1) sm90::named_arrive(kTurn, kThreads);
    sm90::mbar_wait(&full[f0 % kStages], (f0 / kStages) & 1);
    sm90::wgmma_fence();
    issue_s<D>(sd, q_desc, ring + f0 % kStages * L::kStage);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sd);
    tile_softmax<CAUSAL>(s, p, tile0, walk.dead, warp_row0, r_lo, r_hi, m_lo, m_hi, l_lo, l_hi,
                         alpha_lo, alpha_hi, first_vote);
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k) sm90::frag_a(pf[k], sd, k);
    int tile_next = 0;
    if constexpr (LIST) tile_next = walk.n > 1 ? walk.tile(1) : 0;
    if constexpr (COARSE) coarse_next(walk, cpos);
    for (int j = 0; j + 1 < walk.n; ++j) {
      const int f = f0 + j;
      const int stage = f % kStages;
      const int next = (f + 1) % kStages;
      // Entry j + 1; j + 2 is read a step ahead (the coarse walks step
      // their place under the products).
      const int tile = LIST ? tile_next : COARSE ? cpos.tile : j + 1;
      if constexpr (LIST) tile_next = j + 2 < walk.n ? walk.tile(j + 2) : 0;
      const CoarsePos at = cpos;
      if (VOTES && (COARSE ? at.start : gpos == 0)) {  // a vote step starts: snapshot m_prev
        mv_lo = m_lo;
        mv_hi = m_hi;
      }
      sm90::mbar_wait(&full[next], ((f + 1) / kStages) & 1);
      sm90::named_sync(kTurn + wg, kThreads);
      sm90::wgmma_fence();
      issue_s<D>(sd, q_desc, ring + next * L::kStage);
      issue_pv<D>(od, pf, ring + stage * L::kStage + L::kKV);
      refill(f);  // while the products run
      sm90::named_arrive(kTurn + 1 - wg, kThreads);
      if constexpr (COARSE) coarse_next(walk, cpos);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sd);
      tile_softmax<CAUSAL>(s, p, tile, walk.dead, warp_row0, r_lo, r_hi, m_lo, m_hi, l_lo, l_hi,
                           alpha_lo, alpha_hi, [&](float mx_lo, float mx_hi) {
                             if constexpr (COARSE) {
                               coarse_vote(at, mx_lo, mx_hi);
                             } else if constexpr (VOTES) {
                               // Some valid row of this warp passes: the tile is kept.
                               // Bitwise, not short-circuit: no branch on the way.
                               const bool keep = ((r_lo < p.seqlen_q) & (mx_lo - mv_lo > p.thr)) |
                                                 ((r_hi < p.seqlen_q) & (mx_hi - mv_hi > p.thr));
                               if (__any_sync(0xffffffffu, keep) && lane == 0) vrow[tile] = 0;
                             }
                           });
      sm90::wgmma_wait<0>();
      sm90::fence_regs(od);
      sm90::fence_regs(pf);
      rescale_rows(o, alpha_lo, alpha_hi);
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) sm90::frag_a(pf[k], sd, k);
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);  // this warp is done with stage j
      if constexpr (LIST && VOTES) gpos = gpos + 1 == p.gsize ? 0 : gpos + 1;
    }
    // P V of the last tile. Folded, the flat walk goes on into the next
    // heads: this step refills too and then releases its stage (which is
    // otherwise never refilled).
    sm90::wgmma_fence();
    issue_pv<D>(od, pf, ring + (f0 + walk.n - 1) % kStages * L::kStage + L::kKV);
    if constexpr (FOLD) refill(f0 + walk.n - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(od);
    if (FOLD && lane == 0) sm90::mbar_arrive(&empty[(f0 + walk.n - 1) % kStages]);

    // Epilogue: the warpgroup's normalised rows, bf16, into its own half of
    // the Q buffer (its wgmmas are done with it) in the 128-byte swizzle, then
    // one TMA store per 64-value atom; lse from each quad's first lane.
    float inv_lo, inv_hi, lse_lo, lse_hi;
    finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
    unsigned char* ob = smem + L::q + 64 * wg * 128;
    const int orow = 16 * warp + g;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      unsigned char* chunk = ob + (jb / 8) * kRowsQ * 128 + (((jb % 8) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(chunk + orow * 128) =
          sm90::pack_bf16x2(o[jb][0] * inv_lo, o[jb][1] * inv_lo);
      *reinterpret_cast<uint32_t*>(chunk + (orow + 8) * 128) =
          sm90::pack_bf16x2(o[jb][2] * inv_hi, o[jb][3] * inv_hi);
    }
    if (t == 0) {
      const size_t base = static_cast<size_t>(bh) * p.seqlen_q;
      if (r_lo < p.seqlen_q) p.lse[base + r_lo] = lse_lo;
      if (r_hi < p.seqlen_q) p.lse[base + r_hi] = lse_hi;
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1 + wg, 128);
    if (tw == 0 && q0 + 64 * wg < p.seqlen_q) {
#pragma unroll
      for (int a = 0; a < D / 64; ++a) {
        sm90::tma_store_3d(&tm_o, ob + a * kRowsQ * 128, 64 * a, q0 + 64 * wg, bh);
      }
      sm90::bulk_commit();
      sm90::bulk_wait_read();  // the Q buffer stays until the stores have read it
    }
    f_head += walk.n;
  }
}

// Tensor maps of q, k, v (k and v with `kv_rows` rows per (b, kv head)) and
// out, then one launch of instantiation <D, CAUSAL, WALK, VOTES, FOLD> over
// (q-tiles, heads / fold, batch).
template <int D, bool CAUSAL, int WALK = kDense, bool VOTES = false, bool FOLD = false>
cudaError_t run(const void* q, const void* k, const void* v, void* out, Params p, int batch,
                float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const int bh = batch * p.heads, bhk = batch * p.kv_heads;
  cudaError_t err;
  if ((err = sm90::make_tensor_map_3d(&tm_q, q, D, p.seqlen_q, bh, 64, kRowsQ)) ||
      (err = sm90::make_tensor_map_3d(&tm_k, k, D, p.seqlen_k, bhk, 64, kKeys)) ||
      (err = sm90::make_tensor_map_3d(&tm_v, v, D, p.seqlen_k, bhk, 64, kKeys)) ||
      (err = sm90::make_tensor_map_3d(&tm_o, out, D, p.seqlen_q, bh, 64, 64))) {
    return err;
  }
  p.qtiles = (p.seqlen_q + kRowsQ - 1) / kRowsQ;
  p.ktiles = (p.seqlen_k + kKeys - 1) / kKeys;
  p.causal_offset = p.seqlen_k - p.seqlen_q;
  p.scale_log2 = scale * 1.4426950408889634f;
  auto kernel = flash_fwd_kernel<D, CAUSAL, WALK, VOTES, FOLD>;
  constexpr int smem = Smem<D>::bytes + 1024;  // + alignment of the base
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int fold = FOLD ? p.fold : 1;
  kernel<<<dim3(p.qtiles, p.heads / fold, batch), kThreads, smem, stream>>>(tm_q, tm_k, tm_v,
                                                                            tm_o, p);
  return cudaGetLastError();
}

template <int D, bool VOTES>
cudaError_t run_list(const void* q, const void* k, const void* v, void* out, const Params& p,
                     int batch, float scale, cudaStream_t stream) {
  return p.fold > 1 ? run<D, false, kList, VOTES, true>(q, k, v, out, p, batch, scale, stream)
                    : run<D, false, kList, VOTES, false>(q, k, v, out, p, batch, scale, stream);
}

template <int D>
cudaError_t run_coarse(const void* q, const void* k, const void* v, void* out, const Params& p,
                       int batch, float scale, cudaStream_t stream) {
  return p.bits != nullptr ? run<D, false, kSuper, true>(q, k, v, out, p, batch, scale, stream)
                           : run<D, false, kCoarse, true>(q, k, v, out, p, batch, scale, stream);
}

}  // namespace fwd
}  // namespace lite

// q [B, H, Sq, D], k and v [B, Hk, Sk, D], out [B, H, Sq, D], all bf16; lse
// [B, H, Sq] fp32. Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_dense(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int batch, int heads, int kv_heads,
                                    int seqlen_q, int seqlen_k, int head_dim,
                                    float scale, int causal, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lite::fwd;
  Params p{};
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  if (head_dim == 64) {
    err = causal ? run<64, true>(q, k, v, out, p, batch, scale, s)
                 : run<64, false>(q, k, v, out, p, batch, scale, s);
  } else if (head_dim == 128) {
    err = causal ? run<128, true>(q, k, v, out, p, batch, scale, s)
                 : run<128, false>(q, k, v, out, p, batch, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B3 / B5: q [B, H, Sq, D], k and v [B, Hk, Sk, D] (or the union-compacted
// buffers of that shape with lidx), out [B, H, Sq, D], all bf16; lse [B, H,
// Sq] fp32; fidx, lidx (or null) [B, H, Qt, Kt] and count [B, H, Qt] int32;
// mask [B, H, Qt, Kt] bool; votes [B, H, Qt, Kt] int32 pre-filled with 1
// (written with emit_votes). `fold` heads per CTA (must divide H). Returns
// the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_gather(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* fidx, const void* count, const void* lidx, const void* mask,
    void* votes, int batch, int heads, int kv_heads, int seqlen_q,
    int seqlen_k, int head_dim, int gsize, int fold, float scale, float thr,
    int emit_votes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fold < 1 || heads % fold || gsize < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lite::fwd;
  Params p{};
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.fidx = static_cast<const int*>(fidx);
  p.count = static_cast<const int*>(count);
  p.lidx = static_cast<const int*>(lidx);
  p.mask = static_cast<const uint8_t*>(mask);
  p.votes = static_cast<int*>(votes);
  p.gsize = gsize;
  p.fold = fold;
  p.thr = thr;
  const bool v8 = emit_votes != 0;
  if (head_dim == 64) {
    err = v8 ? run_list<64, true>(q, k, v, out, p, batch, scale, s)
             : run_list<64, false>(q, k, v, out, p, batch, scale, s);
  } else if (head_dim == 128) {
    err = v8 ? run_list<128, true>(q, k, v, out, p, batch, scale, s)
             : run_list<128, false>(q, k, v, out, p, batch, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B4: q [B, H, Sq, D], k and v [B, Hk, Sk, D], out [B, H, Sq, D], all bf16;
// lse [B, H, Sq] fp32; the coarse schedule kv_idx [B, H, Qt_c, Kt_c] and
// count [B, H, Qt_c] int32 at block_q = 128 qsub, block_k = 128 ksub; bits
// (super-tile mode) aligned with kv_idx, or null; votes int32 pre-filled
// with 1, [B, H, Qt_c, Kt_c] (coarse) or [B, H, Qt_c qsub, Kt_c ksub]
// (super-tile). Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_coarse(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_idx, const void* count, const void* bits, void* votes,
    int batch, int heads, int kv_heads, int seqlen_q, int seqlen_k,
    int head_dim, int qsub, int ksub, float scale, float thr, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (qsub < 1 || ksub < 1 || ksub > 32 || (bits != nullptr && qsub * ksub > 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lite::fwd;
  Params p{};
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.fidx = static_cast<const int*>(kv_idx);
  p.count = static_cast<const int*>(count);
  p.bits = static_cast<const int*>(bits);
  p.votes = static_cast<int*>(votes);
  p.thr = thr;
  p.qsub = qsub;
  p.ksub = ksub;
  p.sched_q = ((seqlen_q + kRowsQ - 1) / kRowsQ + qsub - 1) / qsub;
  p.sched_k = ((seqlen_k + kKeys - 1) / kKeys + ksub - 1) / ksub;
  p.vote_q = bits != nullptr ? p.sched_q * qsub : p.sched_q;
  p.vote_k = bits != nullptr ? p.sched_k * ksub : p.sched_k;
  if (head_dim == 64) {
    err = run_coarse<64>(q, k, v, out, p, batch, scale, s);
  } else if (head_dim == 128) {
    err = run_coarse<128>(q, k, v, out, p, batch, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B1's MLA channels (liteattention_tpu/ops/flash_fwd.py:_fwd_kernel with
// has_qv, or V of its own head dim DV != DK): forward only, as in JAX.
//
// The score is q . k (DK channels), plus qv . v (DV channels) with QV; the
// output takes V's head dim. Neither the 128 x DV accumulator (at DV 512: 256
// KB) nor q's fragments at DK 576 fit a CTA's registers, so the walk differs
// from the mainloop above: q (and qv) stay in shared memory for the whole
// walk (in registers when the score channels are at most 256), and each CTA
// produces one 128-wide chunk of V's channels, recomputing S for each chunk.
// That costs (DV / 128 - 1) extra passes of QK^T: at (576, 512) 3 x 2 x 576
// FLOP per (row, key) on top of the 2 x (576 + 512) needed (x2.6); at
// (192, 128), DeepSeek's non-absorbed prefill shape, nothing. With QV the
// ring holds V's whole rows, since S reads them all; the chunk's PV reads its
// columns from the same tile. mma.sync m16n8k16 with ldmatrix fragments, a
// two-stage cp.async ring of BK-key tiles, exp2 online softmax (the row steps
// of attention_fwd.cuh), causal bottom-right (offset Sk - Sq) with the walk
// stopped at the diagonal and the q-tiles in reverse order. Bound on the H100
// by tensor-core issue, as B1.
namespace mla_fwd {

using lite::cp_async16;
using lite::cp_async_commit;
using lite::cp_async_wait;
using lite::finish_rows;
using lite::ldmatrix_x4;
using lite::mask_scores;
using lite::mma_bf16;
using lite::pv_product;
using lite::softmax_update;
using lite::store_rows;

constexpr int kChunk = 128;  // V channels (output columns) per CTA

struct Params {
  const __nv_bfloat16* q;   // [B, H, Sq, DK]
  const __nv_bfloat16* qv;  // [B, H, Sq, DV] (QV)
  const __nv_bfloat16* k;   // [B, Hk, Sk, DK]
  const __nv_bfloat16* v;   // [B, Hk, Sk, DV]
  __nv_bfloat16* out;       // [B, H, Sq, DV]
  float* lse;               // [B, H, Sq]
  int heads, kv_heads, seqlen_q, seqlen_k, qtiles, chunks, causal_offset;
  float scale_log2;
};

template <int DK, int DV, bool QV, int WARPS, int BK>
struct Geometry {
  static constexpr int kRowsQ = 16 * WARPS;        // q rows per CTA
  static constexpr int kDS = DK + (QV ? DV : 0);   // score channels
  static constexpr int kQPitch = kDS + 8;          // shared row pitches: odd
  static constexpr int kKPitch = DK + 8;           // multiples of 16 bytes
  static constexpr int kVW = QV ? DV : kChunk;     // V channels in the ring
  static constexpr int kVPitch = kVW + 8;
  static constexpr bool kQRegs = kDS <= 256;
  static constexpr int kStage = BK * (kKPitch + kVPitch);  // elements
  static constexpr int kSmem = (kRowsQ * kQPitch + 2 * kStage) * 2;
  static_assert(DK % 16 == 0 && DV % kChunk == 0 && BK % 16 == 0, "tile shapes");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

template <int DK, int DV, bool QV, int WARPS, int BK, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32, 1) mla_fwd_kernel(const Params p) {
  using G = Geometry<DK, DV, QV, WARPS, BK>;
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRowsQ][kQPitch]
  __nv_bfloat16* ring = qs + G::kRowsQ * G::kQPitch;                // [2][kStage]

  const int qt = CAUSAL ? p.qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y / p.chunks;
  const int chunk = blockIdx.y % p.chunks;
  const int b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const size_t bh = static_cast<size_t>(b) * p.heads + h;
  const size_t bhk = static_cast<size_t>(b) * p.kv_heads + hk;
  const __nv_bfloat16* qb = p.q + bh * p.seqlen_q * DK;
  const __nv_bfloat16* qvb = QV ? p.qv + bh * p.seqlen_q * DV : qb;
  const __nv_bfloat16* kb = p.k + bhk * p.seqlen_k * DK;
  const __nv_bfloat16* vb = p.v + bhk * p.seqlen_k * DV + (QV ? 0 : chunk * kChunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * G::kRowsQ;
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int lim_lo = CAUSAL ? min(p.seqlen_k, r_lo + p.causal_offset + 1) : p.seqlen_k;
  const int lim_hi = CAUSAL ? min(p.seqlen_k, r_hi + p.causal_offset + 1) : p.seqlen_k;

  int n = (p.seqlen_k + BK - 1) / BK;
  if constexpr (CAUSAL) {
    const int last = q0 + G::kRowsQ - 1 + p.causal_offset;  // the last row's last key
    n = last < 0 ? 0 : min(n, last / BK + 1);
  }

  // q | qv rows of this tile (rows past Sq zero-fill), in the first group.
  constexpr int kQChunks = G::kDS / 8;
  for (int c = threadIdx.x; c < G::kRowsQ * kQChunks; c += kThreads) {
    const int r = c / kQChunks;
    const int col = (c % kQChunks) * 8;
    const int row = q0 + r;
    const bool valid = row < p.seqlen_q;
    const __nv_bfloat16* src = qb;
    if (valid) src = col < DK ? qb + static_cast<size_t>(row) * DK + col
                              : qvb + static_cast<size_t>(row) * DV + (col - DK);
    cp_async16(qs + r * G::kQPitch + col, src, valid);
  }
  auto load_tile = [&](int j) {
    __nv_bfloat16* ks = ring + (j & 1) * G::kStage;
    __nv_bfloat16* vs = ks + BK * G::kKPitch;
    for (int c = threadIdx.x; c < BK * (DK / 8); c += kThreads) {
      const int r = c / (DK / 8);
      const int col = (c % (DK / 8)) * 8;
      const int pos = j * BK + r;
      const bool valid = pos < p.seqlen_k;
      cp_async16(ks + r * G::kKPitch + col,
                 kb + static_cast<size_t>(valid ? pos : 0) * DK + col, valid);
    }
    for (int c = threadIdx.x; c < BK * (G::kVW / 8); c += kThreads) {
      const int r = c / (G::kVW / 8);
      const int col = (c % (G::kVW / 8)) * 8;
      const int pos = j * BK + r;
      const bool valid = pos < p.seqlen_k;
      cp_async16(vs + r * G::kVPitch + col,
                 vb + static_cast<size_t>(valid ? pos : 0) * DV + col, valid);
    }
  };

  uint32_t qf[G::kQRegs ? G::kDS / 16 : 1][4];
  float acc[kChunk / 8][4];
#pragma unroll
  for (int i = 0; i < kChunk / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
  float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums

  if (n > 0) load_tile(0);
  cp_async_commit();

  const __nv_bfloat16* qa = qs + (warp * 16 + (lane & 15)) * G::kQPitch + (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);  // K (or V) rows as B fragments
  const int b_col = ((lane >> 3) & 1) * 8;
  const int v_col = QV ? chunk * kChunk : 0;  // the chunk's first column in the ring

  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = ring + (j & 1) * G::kStage;
    const __nv_bfloat16* vs = ks + BK * G::kKPitch;
    if constexpr (G::kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < G::kDS / 16; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
      }
    }

    // S = [q | qv] [k | v]^T for this warp's 16 rows x BK keys.
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kDS / 16; ++kk) {
      uint32_t a[4];
      if constexpr (G::kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, qa + kk * 16);
      }
      const bool in_k = kk < DK / 16;
      const __nv_bfloat16* src = in_k ? ks + b_row * G::kKPitch + kk * 16 + b_col
                                      : vs + b_row * G::kVPitch + (kk - DK / 16) * 16 + b_col;
      const int pitch16 = 16 * (in_k ? G::kKPitch : G::kVPitch);
#pragma unroll
      for (int nb2 = 0; nb2 < BK / 16; ++nb2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, src + nb2 * pitch16);
        mma_bf16(s[2 * nb2], a, bk[0], bk[1]);
        mma_bf16(s[2 * nb2 + 1], a, bk[2], bk[3]);
      }
    }

    // Log2-space scores (past Sk, and above the diagonal with CAUSAL, -inf),
    // the online softmax, and O += P V over this CTA's chunk of V's channels.
    const int col0 = j * BK;
    const bool masked = col0 + BK > p.seqlen_k ||
                        (CAUSAL && col0 + BK - 1 > q0 + warp * 16 + p.causal_offset);
    float mx_lo, mx_hi;
    mask_scores(s, p.scale_log2, masked, col0, lim_lo, lim_hi, mx_lo, mx_hi);
    softmax_update(s, acc, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi);
    pv_product(acc, s, vs + v_col, G::kVPitch);
    __syncthreads();  // this stage is refilled next
  }
  cp_async_wait<0>();

  float inv_lo, inv_hi, lse_lo, lse_hi;
  finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
  const bool lo_valid = r_lo < p.seqlen_q;
  const bool hi_valid = r_hi < p.seqlen_q;
  store_rows(p.out + (bh * p.seqlen_q + r_lo) * DV + chunk * kChunk,
             p.out + (bh * p.seqlen_q + r_hi) * DV + chunk * kChunk, acc, inv_lo, inv_hi,
             lo_valid, hi_valid);
  if (t == 0 && chunk == 0) {
    if (lo_valid) p.lse[bh * p.seqlen_q + r_lo] = lse_lo;
    if (hi_valid) p.lse[bh * p.seqlen_q + r_hi] = lse_hi;
  }
}

template <int DK, int DV, bool QV, int WARPS, int BK>
cudaError_t launch(Params p, int batch, bool causal, cudaStream_t stream) {
  using G = Geometry<DK, DV, QV, WARPS, BK>;
  auto kernel = causal ? mla_fwd_kernel<DK, DV, QV, WARPS, BK, true>
                       : mla_fwd_kernel<DK, DV, QV, WARPS, BK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  p.qtiles = (p.seqlen_q + G::kRowsQ - 1) / G::kRowsQ;
  p.chunks = DV / kChunk;
  dim3 grid(p.qtiles, p.heads * p.chunks, batch);
  kernel<<<grid, WARPS * 32, G::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mla_fwd

// q [B, H, Sq, DK], qv [B, H, Sq, DV] or null, k [B, Hk, Sk, DK], v [B, Hk,
// Sk, DV], all bf16; out [B, H, Sq, DV] bf16, lse [B, H, Sq] fp32. Built for
// (DK, DV, qv) = (192, 128, no), (576, 512, no) and (64, 512, yes); other
// shapes return cudaErrorInvalidValue. Returns the CUDA error (0 = success).
extern "C" int lite_flash_fwd_mla(const void* q, const void* qv, const void* k,
                                  const void* v, void* out, void* lse, int batch,
                                  int heads, int kv_heads, int seqlen_q, int seqlen_k,
                                  int head_dim, int head_dim_v, float scale, int causal,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_fwd::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.qv = static_cast<const __nv_bfloat16*>(qv);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.causal_offset = seqlen_k - seqlen_q;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_qv = qv != nullptr;
  if (head_dim == 192 && head_dim_v == 128 && !has_qv) {
    err = mla_fwd::launch<192, 128, false, 8, 64>(p, batch, causal, s);
  } else if (head_dim == 576 && head_dim_v == 512 && !has_qv) {
    err = mla_fwd::launch<576, 512, false, 4, 32>(p, batch, causal, s);
  } else if (head_dim == 64 && head_dim_v == 512 && has_qv) {
    err = mla_fwd::launch<64, 512, true, 4, 32>(p, batch, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
