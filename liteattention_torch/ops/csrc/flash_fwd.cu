// B1: dense flash-attention forward on Hopper (flash_fwd_kernel), replacing
// the Pallas kernel liteattention_tpu/ops/flash_fwd.py:_fwd_kernel. The same
// kernel, walking a list of live k-tiles, is B3 (lite_flash_fwd_gather),
// replacing liteattention_tpu/ops/lite_flash_fwd.py:_lite_gather_kernel, and
// with `fold` heads per CTA B5, replacing _lite_gather_kernel_hfold; walking
// a coarse schedule's entries it is B4 (lite_flash_fwd_coarse), replacing
// _lite_kernel. With V of its own head dim, (DK, DV) = (192, 128), it is
// B1's MLA channels at DeepSeek's non-absorbed prefill shape (the MLA
// shapes at V 512 run on mla_fwd.cu's split-O kernel).
//
// bf16 q/k in [B, H, S, DK] and v in [B, Hk, S, DV] ((DK, DV) = (64, 64),
// (80, 80), (96, 96), (128, 128), (256, 256) or (192, 128)), GQA by h / group, optionally causal
// (bottom-right aligned, offset Sk - Sq); ragged Sq and Sk. Out [B, H, Sq,
// DV] in bf16, lse fp32 natural log; a row with no valid key gets out 0,
// lse -inf.
//
// B1's per-batch channels (the JAX kernel's has_bound, bound_causal, has_low
// and has_alibi; dense walk at (DK, DV) = (64, 64), (80, 80) or (128,
// 128)): the keys
// of batch b are [kv_low[b], min(Sk, kv_bound[b])), with bound_causal the
// diagonal at kv_bound[b] - Sq (the smaller of the two offsets when causal
// too); with ALIBI the scores take -slope[b, h] log2(e) |row + Sk - Sq -
// col| in log2 units. Bound and low are runtime data, uniform over a CTA
// (its batch is blockIdx.z): the CTA reads them once into a KeyRange, walks
// only the tiles [low / 128, the last the limit and its diagonal reach),
// and masks per element only the tiles that cross the start, the limit or
// the diagonal. Without them the range is [0, Sk) at offset Sk - Sq, and
// the outputs are bit for bit those of the kernel without the channels.
// bound_causal without causal runs the CAUSAL instantiation at the bound's
// offset. ALiBi costs an FFMA a score on every tile, so it is a template
// flag (the dense walk's only): its tiles scale to log2 units first, as the
// JAX kernel does, and subtract the bias, then mask; the exp2 then takes
// scale 1. The bias is JAX's: slope |row + Sk - Sq - col| (under either
// diagonal a visible key's distance is >= 0, so |.| always). With
// bound_causal every visible key of batch b is at least shift = Sk -
// kv_bound[b] away (a KV cache's unused tail), and JAX's scores carry that
// per-row constant: at a 2048-key cache half full it is ~1200 in log2
// units, where fp32 keeps 2^-13: with it, Baichuan2-13B's geometry (random
// weights, 40 layers, an H100) decoded 2.1e-2 from a full recompute, and
// 4.1e-3 without it. So the kernel subtracts slope (|dist| - shift), which
// leaves every output the same, and takes slope shift off lse at the end.
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
// The segment walk (kSegment; the JAX kernel's has_segments, batch 1;
// entry lite_flash_fwd_segments in flash_fwd_segments.cu): a key is seen by
// the rows whose segment id equals its own. The JAX kernel visits every
// (q-tile, k-tile) pair and masks by id, total^2 work for a packed batch
// whose useful work is the sum of its documents' squares (25x at BERT's
// batch). Here each q-tile walks the dense walk's tiles over a key range
// [x, y) that the wrapper computes on the device (ops/segments.py): for ids
// in order apart from negative markers (what the varlen functions make)
// exactly the keys of the tile's segments, else [0, Sk). Causal stops at
// the diagonal as the dense walk does. The test is per element only on the
// tiles where the keys' ids (each k-tile's least and largest, from the
// wrapper) and the warp's 16 rows' ids (read once per CTA) are not all one
// id, which inside a document is none but the tiles that cross a boundary.
// Rows whose id no key carries get out 0, lse -inf.
//
// Attention dropout (DROPOUT; the JAX kernel's dropout_p, dense walk at D 64
// and 128, with the key range; kernel flash_fwd_dropout_kernel and entry
// lite_flash_fwd_dropout in flash_fwd_dropout.cu): once a tile's P has
// gone into the row sums l (which, like lse, stay dropout-free), each score
// keeps its P iff key_mask.cuh's dropout_keep passes for (seed, b * H + h,
// its global row, its global key), else 0, and the epilogue folds 1 / (1 -
// p) into 1 / l. The hash takes about eleven integer instructions a score
// (the row's and the column's products are shared: an add, the xor with
// the (seed, bh) term, three shift-xors, two multiplies, one compare),
// issued right after the tile's exp2 while its P V and the next S are in
// flight. A 128 x 128 tile at D 64 is ~1k clocks of wgmma and ~1k of MUFU
// exp2, and ~2.8k of integer issue at 64 a clock, so the dropout forward at
// D 64 is bound by integer issue unless the products hide it.
//
// Head dims 80 (BTLM) and 96 (GPT-NeoX-20B): every tile takes two 64-value
// atoms, as at D 128 (sm90.cuh: the second partly filled), so the shared
// memory and the ring depth are D 128's. The tensor maps' inner extent is
// D: the second box reads columns 64 .. D - 1 and TMA fills the rest of
// the atom with zeros; S = Q K^T runs D / 16 k-steps, P V one wgmma at N =
// D, and the output's TMA store clips at column D. No product reads the
// padding. (Padding q, k and v to 128 in the caller, the TPU's 128-lane
// habit, would copy them and spend 1.6x the MMA work at D 80.)
//
// Head dim 256 (GPT-J-6B): four atoms a row, so the Q tile is 64 KB and one
// 128-key K + V stage 128 KB, and no second stage would fit. The tiles are
// 64 keys (Tiles) in two stages with (192, 128)'s split K / V barriers, 192
// KB in all; S = Q K^T is m64n64 over 16 k-steps and P V one wgmma at N =
// 256. O takes 128 of a thread's registers (64 x 256 fp32 a warpgroup), S 32
// and P 16. The key range (bound, low, bound_causal) is runtime data, so
// the two instantiations (causal or not, flash_fwd_d256.cu) take it; ALiBi
// and segments are not built at 256.
//
// One CTA per (b, h, 128-row q-tile), 256 threads: two consumer warpgroups
// of 64 q rows each. O, S and P take 186 of a thread's 255 registers at D
// 128; with a producer warp (288 threads) ptxas gives 166 and spills
// (b1_ablation.py, producer_warp), so thread 0 also issues the TMA loads
// (128-byte swizzle; 3-D tensor maps over [B * H, S, D], so a ragged tail
// reads zeros, never the next head's rows): Q once, K and V per 128-key
// tile into a ring of kStages stages (Q and operands step through DK and
// DV in 64-value atoms). Each stage has a full barrier (expect-tx bytes)
// and an empty barrier that every warp arrives on once its wgmmas that
// read the stage have retired. No __syncthreads in the loop. At (192, 128)
// a stage is 80 KB and only two fit beside Q (48 KB); two stages would
// leave no tile to prefetch (S_{j+1} and P_j V_j hold both), so there K
// and V take barriers of their own (a split ring): K of tile j + 2 loads
// once S_j has read it, V of tile j + 1 once P_{j-1} V_{j-1} has, each a
// step ahead as in the three-stage ring. Per warpgroup and k-tile j of the
// walk:
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
constexpr int kKeys = 128;   // keys per fine k-tile (the sparse walks' tiles)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTurn = 3;  // named barriers kTurn, kTurn + 1: the warpgroups' turns to issue

// The walk over k-tiles: dense (B1), a live-tile list (B3, B5), the
// coarse schedule's entries (B4), in coarse or super-tile mode, or the dense
// walk over a q-tile's segment range (B1's segment channel).
enum Walk { kDense, kList, kCoarse, kSuper, kSegment };

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

// B1's per-batch channels (the dense walk) arrive as key_mask.cuh's
// Channels, a kernel argument of their own: grown by these fields, Params
// cost the list walk (B3) 9 registers and 5 % on an H100 (A/B of the two
// layouts).

// Keys per k-tile and ring depth of the (DK, DV) instantiation. (192, 128)
// takes two 128-key stages with split barriers; 64-key tiles in three
// stages (kKeys 64 there: the helpers take either) ran slower on the H100.
// (256, 256) takes two 64-key stages with split barriers: the Q tile is 64
// KB and one 128-key stage 128 KB, so 128-key tiles would leave no second
// stage; 64 KB stages give 192 KB in all.
template <int DK, int DV>
struct Tiles {
  static constexpr int kKeys = DK == 256 ? 64 : 128;
  static constexpr int kStages = DK + DV <= 256 ? 3 : 2;
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base). Each
// tile is stored as 64-value atoms of 128-byte rows (TMA's 128-byte
// swizzle), atom a at a * rows * 128; a width of 80 or 96 takes two.
template <int DK, int DV>
struct Smem {
  using T = Tiles<DK, DV>;
  static constexpr int kQ = kRowsQ * sm90::atoms(DK) * 128;   // the Q tile
  static constexpr int kK = T::kKeys * sm90::atoms(DK) * 128;  // one K tile
  static constexpr int kV = T::kKeys * sm90::atoms(DV) * 128;  // one V tile
  static constexpr int kStage = kK + kV;       // K, then V
  static constexpr int q = 0;
  static constexpr int ring = q + kQ;          // [kStages]
  // full, empty [kStages]; q_full; the split ring's V barriers vfull, vempty [kStages]
  static constexpr int bars = ring + T::kStages * kStage;
  static constexpr int bytes = bars + (4 * T::kStages + 1) * 8;
};

// The k-tiles a CTA visits, in order: n >= 1 of them, so that every wgmma
// of the mainloop is issued outside a branch (ptxas serialises wgmmas in a
// path it cannot prove uniform). The dense walk: tile first + j for j < n,
// from the tile that holds the range's first key to the last tile its limit
// and (CAUSAL) the q-tile's last row reach; a q-tile whose rows see no key
// visits tile 0 with its range's limit set to 0, so that every key is
// hidden (out 0, lse -inf). (Not a dead flag, as the sparse walks keep: a
// flag tested on every masked score cost causal B1 7 % at GPT-2 small on an
// H100.)
struct DenseWalk {
  int first, n;
  static constexpr bool dead = false;
  __device__ __forceinline__ int tile(int j) const { return first + j; }
};

template <bool CAUSAL, int KEYS>
__device__ __forceinline__ DenseWalk dense_walk(int q0, KeyRange& r) {
  int end = (r.lim + KEYS - 1) / KEYS;
  if constexpr (CAUSAL) {
    const int last = q0 + kRowsQ - 1 + r.diag;  // the last row's last key
    end = min(end, last < 0 ? 0 : last / KEYS + 1);
  }
  const int first = r.low / KEYS;
  if (end > first) return {first, end - first};
  r.lim = 0;
  return {0, 1};
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

// K of k-tile `tile` into ring stage `stage`, completing on `bar` (thread 0).
template <int DK, int DV>
__device__ __forceinline__ void load_k(const CUtensorMap& tm_k, unsigned char* smem, uint64_t* bar,
                                       int stage, int tile, int bhk) {
  using L = Smem<DK, DV>;
  constexpr int kKeys = Tiles<DK, DV>::kKeys;
  unsigned char* dst = smem + L::ring + stage * L::kStage;
#pragma unroll
  for (int a = 0; a < sm90::atoms(DK); ++a) {
    sm90::tma_load_3d(dst + a * kKeys * 128, &tm_k, bar, 64 * a, tile * kKeys, bhk);
  }
}

// V of k-tile `tile` into ring stage `stage`, completing on `bar` (thread 0).
template <int DK, int DV>
__device__ __forceinline__ void load_v(const CUtensorMap& tm_v, unsigned char* smem, uint64_t* bar,
                                       int stage, int tile, int bhk) {
  using L = Smem<DK, DV>;
  constexpr int kKeys = Tiles<DK, DV>::kKeys;
  unsigned char* dst = smem + L::ring + stage * L::kStage + L::kK;
#pragma unroll
  for (int a = 0; a < sm90::atoms(DV); ++a) {
    sm90::tma_load_3d(dst + a * kKeys * 128, &tm_v, bar, 64 * a, tile * kKeys, bhk);
  }
}

// K and V of k-tile `tile` into ring stage `stage` on one barrier (thread 0).
template <int DK, int DV>
__device__ __forceinline__ void load_tile(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                          unsigned char* smem, uint64_t* full, int stage,
                                          int tile, int bhk) {
  sm90::mbar_expect_tx(full + stage, Smem<DK, DV>::kStage);
  load_k<DK, DV>(tm_k, smem, full + stage, stage, tile, bhk);
  load_v<DK, DV>(tm_v, smem, full + stage, stage, tile, bhk);
}

// S = Q K^T over the warpgroup's 64 rows (q_desc) and the KEYS keys of the
// K tile at k_addr, both K-major: a 16-deep step moves 32 bytes inside an
// atom, then to the next atom (kRowsQ rows on in Q, KEYS in K).
template <int DK, int KEYS>
__device__ __forceinline__ void issue_s(float (&s)[KEYS / 2], uint64_t q_desc, uint32_t k_addr) {
  const uint64_t k_desc = desc_sw128(k_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t in_atom = (kk % 4) * 32;
    const uint64_t qd = sm90::desc_add(q_desc, (kk / 4) * kRowsQ * 128 + in_atom);
    const uint64_t kd = sm90::desc_add(k_desc, (kk / 4) * KEYS * 128 + in_atom);
    if constexpr (KEYS == 128) {
      sm90::wgmma_ss_n128<0, 0>(s, qd, kd, kk > 0);
    } else {
      sm90::wgmma_ss_n64<0, 0>(s, qd, kd, kk > 0);
    }
  }
  sm90::wgmma_commit();
}

// O += P V: P from registers, V at v_addr as the MN-major B operand (rows
// of 64 values of DV, atoms KEYS * 128 bytes apart), 16 keys a step, one
// wgmma at N = DV.
template <int DV, int KEYS>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&pf)[KEYS / 16][4],
                                         uint32_t v_addr) {
  const uint64_t v_desc = desc_sw128(v_addr, KEYS * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    sm90::wgmma_rs<DV, 1>(o, pf[kk], sm90::desc_add(v_desc, kk * 2048), 1);
  }
  sm90::wgmma_commit();
}

// The segment walk's ids: the keys' ids and each k-tile's least and
// largest (Channels), this thread's rows' ids and its warp's least and
// largest (read once per CTA).
struct SegRows {
  const int* k_seg;
  const int2* k_span;
  int q_lo, q_hi;
  int2 warp;
};

// Tile `tile`'s scores, masked only on tiles that cross the range's start
// or limit (the dense walk's; the sparse walks' range is [0, Sk), read from
// the params), on tiles that cross this warp's diagonal, on a dead row's
// tile and (SEG) on tiles whose keys and this warp's rows are not all of
// one segment, then `vote` with the rows' maxima in log2 space before the
// running max absorbs them, then folded into the running row state; they
// stay raw until softmax_rows takes them to log2 space inside each exp2's
// FFMA (one instruction a score fewer than scaling first). With ALIBI
// (slope_log2 = slope log2(e)) they go to log2 space first and take the
// bias there. alpha is the accumulator's rescale.
template <bool CAUSAL, bool DENSE, bool ALIBI, bool SEG, int NB, typename Vote>
__device__ __forceinline__ void tile_softmax(float (&s)[NB][4], const Params& p, const KeyRange& r,
                                             const SegRows& seg, float slope_log2, int tile,
                                             bool dead,
                                             int warp_row0, int r_lo, int r_hi, float& m_lo,
                                             float& m_hi, float& l_lo, float& l_hi,
                                             float& alpha_lo, float& alpha_hi, Vote&& vote) {
  constexpr int kKeys = 8 * NB;
  const int col0 = tile * kKeys;
  if constexpr (ALIBI) {
    const int t = threadIdx.x % 4;
    const int d_lo = r_lo + p.causal_offset - col0 - 2 * t;  // the distance to key col0 + 2 t
    const int d_hi = d_lo + 8;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dist = abs((e >= 2 ? d_hi : d_lo) - 8 * nb - (e & 1)) - r.shift;
        s[nb][e] = fmaf(s[nb][e], p.scale_log2, -slope_log2 * static_cast<float>(dist));
      }
    }
  }
  const float scale = ALIBI ? 1.f : p.scale_log2;
  const int lim = DENSE ? r.lim : p.seqlen_k;
  const int diag = DENSE ? r.diag : p.causal_offset;
  const bool mask = dead || col0 + kKeys > lim || (DENSE && col0 < r.low) ||
                    (CAUSAL && col0 + kKeys - 1 > warp_row0 + diag) ||
                    (SEG && !one_segment(__ldg(seg.k_span + tile), seg.warp));
  float mx_lo, mx_hi;
  mask_scores(
      s, 1.f, mask, col0,
      [&](int col, bool hi) {
        const int row = hi ? r_hi : r_lo;
        if constexpr (SEG) {
          return key_masked<CAUSAL>(col, row, lim, diag, r.low, hi ? seg.q_hi : seg.q_lo,
                                    __ldg(seg.k_seg + col));
        }
        if constexpr (DENSE) return dead || key_masked<CAUSAL>(col, row, lim, diag, r.low);
        return dead || key_masked<CAUSAL>(col, row, lim, diag);
      },
      mx_lo, mx_hi);
  vote(mx_lo * scale, mx_hi * scale);
  softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, scale);
}

// DROPOUT: tile `tile`'s P (after its row sums) keeps the scores whose
// dropout_keep passes at this thread's rows (row_lo / row_hi: row *
// kDropRow) and the tile's keys; the rest become 0.
template <int NB>
__device__ __forceinline__ void drop_scores(float (&s)[NB][4], int tile, uint32_t row_lo,
                                            uint32_t row_hi, uint32_t key, uint32_t keep_min) {
  const uint32_t col = static_cast<uint32_t>(tile * 8 * NB + 2 * (threadIdx.x % 4)) * kDropCol;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t pos =
          (e >= 2 ? row_hi : row_lo) + col + static_cast<uint32_t>(8 * nb + (e & 1)) * kDropCol;
      s[nb][e] = dropout_keep(pos, key, keep_min) ? s[nb][e] : 0.f;
    }
  }
}

// One CTA of B1 (flash_fwd_kernel; with DROPOUT flash_fwd_dropout_kernel,
// flash_fwd_dropout.cu).
template <int DK, int DV, bool CAUSAL, int WALK, bool VOTES, bool FOLD, bool ALIBI, bool DROPOUT>
__device__ __forceinline__ void fwd_cta(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                        const CUtensorMap& tm_v, const CUtensorMap& tm_o,
                                        const Params& p, const Channels& c) {
  constexpr bool SEG = WALK == kSegment;
  constexpr bool DENSE = WALK == kDense || SEG;
  constexpr bool LIST = WALK == kList;
  constexpr bool COARSE = WALK == kCoarse || WALK == kSuper;
  constexpr bool SUPER = WALK == kSuper;
  // This instantiation's tile geometry (the sparse walks' tiles are kKeys
  // = 128 keys). With two stages the ring splits: K and V of a stage
  // complete and are released on barriers of their own (vfull, vempty);
  // otherwise vfull and vempty are full and empty.
  constexpr int kKeys = Tiles<DK, DV>::kKeys;
  constexpr int kStages = Tiles<DK, DV>::kStages;
  constexpr bool SPLIT = kStages == 2;
  static_assert((DK == DV && (DK == 64 || DK == 80 || DK == 96 || DK == 128 || DK == 256)) ||
                    (DK == 192 && DV == 128),
                "(DK, DV) must be (64, 64), (80, 80), (96, 96), (128, 128), (256, 256) or (192, 128)");
  static_assert(DV <= DK, "the Q buffer holds the output");
  static_assert(!DENSE || !VOTES, "the dense walks do not vote");
  static_assert(LIST || !FOLD, "folded heads take the list walk");
  static_assert(DENSE || !CAUSAL, "the sparse walks are not causal");
  static_assert(DENSE || ((DK == 64 || DK == 128) && DK == DV && kKeys == 128 && !SPLIT),
                "the sparse walks visit 128-key fine tiles through a ring of three");
  static_assert(!ALIBI || (WALK == kDense && DK == DV && DK <= 128),
                "ALiBi is a channel of the dense walk at D <= 128");
  static_assert(!SEG || (DK == DV && DK != 96 && DK <= 128), "segments at D 64, 80 and 128");
  static_assert(!DROPOUT || (WALK == kDense && !ALIBI && DK == DV && (DK == 64 || DK == 128)),
                "dropout is a channel of the dense walk at D 64 and 128");
  using L = Smem<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* vfull = SPLIT ? q_full + 1 : full;
  uint64_t* vempty = SPLIT ? vfull + kStages : empty;

  const int qt = CAUSAL ? p.qtiles - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int b = blockIdx.z;
  const int fold = FOLD ? p.fold : 1;
  const int h0 = blockIdx.y * fold;
  const int q0 = qt * kRowsQ;
  // The dense walk: its keys, tiles and (b, kv head), uniform over the CTA;
  // the segment walk's keys are its q-tile's range.
  KeyRange range = DENSE ? key_range(c, b, p.seqlen_q, p.seqlen_k, p.causal_offset)
                         : KeyRange{};
  if constexpr (SEG) {
    const int2 keys = segment_range(c, qt);
    range.low = max(keys.x, 0);
    range.lim = min(keys.y, p.seqlen_k);
  }
  const DenseWalk dwalk = DENSE ? dense_walk<CAUSAL, kKeys>(q0, range) : DenseWalk{};
  const int n_dense = dwalk.n;
  const int k0 = dwalk.first;  // the dense walk's first tile
  const float slope = ALIBI ? __ldg(c.alibi + b * p.heads + h0) : 0.f;
  const float slope_log2 = slope * 1.4426950408889634f;
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
      if constexpr (SPLIT) {
        sm90::mbar_init(&vfull[s], 1);
        sm90::mbar_init(&vempty[s], kWarps);
      }
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
    for (int a = 0; a < sm90::atoms(DK); ++a) {
      sm90::tma_load_3d(smem + L::q + a * kRowsQ * 128, &tm_q, q_full, 64 * a, q0,
                        b * p.heads + h0);
    }
    if constexpr (LIST) {
      feed.open(p, b, h0, qt);
      for (int j = 0; j < kStages && feed.more(fold); ++j) {  // a walk has n >= 1
        int bhk;
        const int tile = feed.take(p, b, h0, qt, fold, bhk);
        load_tile<DK, DV>(tm_k, tm_v, smem, full, j, tile, bhk);
      }
    } else if constexpr (COARSE) {
      for (int j = 0; j < kStages && j < cwalk.n; ++j) {  // a dead walk loads tile 0
        load_tile<DK, DV>(tm_k, tm_v, smem, full, j, coarse_next(cwalk, fpos) ? fpos.tile : 0,
                          bhk0);
      }
    } else if constexpr (SPLIT) {
      for (int j = 0; j < kStages && j < n_dense; ++j) {  // n_dense >= 1
        sm90::mbar_expect_tx(&full[j], L::kK);
        load_k<DK, DV>(tm_k, smem, &full[j], j, k0 + j, bhk0);
        sm90::mbar_expect_tx(&vfull[j], L::kV);
        load_v<DK, DV>(tm_v, smem, &vfull[j], j, k0 + j, bhk0);
      }
    } else {
      for (int j = 0; j < kStages && j < n_dense; ++j) {  // n_dense >= 1
        load_tile<DK, DV>(tm_k, tm_v, smem, full, j, k0 + j, bhk0);
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
  // DROPOUT: the hash's (seed, b * H + h) term and this thread's rows' terms.
  uint32_t drop_key = 0, drop_lo = 0, drop_hi = 0;
  if constexpr (DROPOUT) {
    drop_key = dropout_key(__ldg(c.dropout_seed), b * p.heads + h0);
    drop_lo = static_cast<uint32_t>(r_lo) * kDropRow;
    drop_hi = static_cast<uint32_t>(r_hi) * kDropRow;
  }
  SegRows seg{};
  if constexpr (SEG) {  // rows past Sq carry the last row's id (the wrapper's padding)
    seg = SegRows{c.k_seg, c.k_span, __ldg(c.q_seg + r_lo), __ldg(c.q_seg + r_hi)};
    seg.warp = make_int2(__reduce_min_sync(0xffffffffu, min(seg.q_lo, seg.q_hi)),
                         __reduce_max_sync(0xffffffffu, max(seg.q_lo, seg.q_hi)));
  }
  const uint64_t q_desc = desc_sw128(sm90::smem_u32(smem + L::q) + 64 * wg * 128, 16, 1024);
  const uint32_t ring = sm90::smem_u32(smem + L::ring);

  // S and O in the accumulator layout (sm90.cuh), as the row steps take
  // them: s[j][2 i + c] is d[4 j + 2 i + c].
  float s[kKeys / 8][4];
  float o[DV / 8][4];
  uint32_t pf[kKeys / 16][4];  // P_j, bf16 pairs: the A operand of PV
  float(&sd)[kKeys / 2] = reinterpret_cast<float(&)[kKeys / 2]>(s);
  float(&od)[DV / 2] = reinterpret_cast<float(&)[DV / 2]>(o);

  // Thread 0 refills tile f - 1's stage (all eight warps released it at the
  // end of their step f - 1) with the next tile of the CTA's flat walk: on
  // the dense walk step f - 1 + kStages (tile k0 + f - 1 + kStages), from
  // uniform values (TMA takes its coordinates in uniform registers). The
  // split ring: K of step f + 2 into step f's stage (every warp's S_f has
  // read it), V of step f + 1 into step f - 1's (every warp's P_{f-1}
  // V_{f-1} has read it).
  auto refill = [&](int f) {
    const int free = (f - 1) % kStages;
    if constexpr (LIST) {
      if (ct == 0 && f > 0 && feed.more(fold)) {
        sm90::mbar_wait(&empty[free], ((f - 1) / kStages) & 1);
        int bhk;
        const int load = feed.take(p, b, h0, qt, fold, bhk);
        load_tile<DK, DV>(tm_k, tm_v, smem, full, free, load, bhk);
      }
    } else if constexpr (COARSE) {
      if (ct == 0 && f > 0 && f - 1 + kStages < cwalk.n) {
        sm90::mbar_wait(&empty[free], ((f - 1) / kStages) & 1);
        coarse_next(cwalk, fpos);
        load_tile<DK, DV>(tm_k, tm_v, smem, full, free, fpos.tile, bhk0);
      }
    } else if constexpr (SPLIT) {
      if (ct == 0 && f + 2 < n_dense) {
        sm90::mbar_wait(&empty[f % 2], (f / 2) & 1);
        sm90::mbar_expect_tx(&full[f % 2], L::kK);
        load_k<DK, DV>(tm_k, smem, &full[f % 2], f % 2, k0 + f + 2, bhk0);
      }
      if (ct == 0 && f > 0 && f + 1 < n_dense) {
        sm90::mbar_wait(&vempty[free], ((f - 1) / 2) & 1);
        sm90::mbar_expect_tx(&vfull[free], L::kV);
        load_v<DK, DV>(tm_v, smem, &vfull[free], free, k0 + f + 1, bhk0);
      }
    } else if (ct == 0 && f > 0 && f - 1 + kStages < n_dense) {
      sm90::mbar_wait(&empty[free], ((f - 1) / kStages) & 1);
      load_tile<DK, DV>(tm_k, tm_v, smem, full, free, k0 + f - 1 + kStages, bhk0);
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
        return dwalk;
      }
    }();
    if (FOLD && hl > 0) {
      __syncthreads();  // both warpgroups' stores have read the Q buffer
      if (ct == 0) {
        sm90::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
        for (int a = 0; a < sm90::atoms(DK); ++a) {
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
    for (int i = 0; i < DV / 2; ++i) od[i] = 0.f;
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
    issue_s<DK, kKeys>(sd, q_desc, ring + f0 % kStages * L::kStage);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sd);
    if (SPLIT && lane == 0) sm90::mbar_arrive(&empty[0]);  // this warp is done with K_0
    tile_softmax<CAUSAL, DENSE, ALIBI, SEG>(s, p, range, seg, slope_log2, tile0, walk.dead,
                                            warp_row0, r_lo, r_hi, m_lo, m_hi, l_lo, l_hi,
                                            alpha_lo, alpha_hi, first_vote);
    if constexpr (DROPOUT) drop_scores(s, tile0, drop_lo, drop_hi, drop_key, c.dropout_min);
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
      const int tile = LIST ? tile_next : COARSE ? cpos.tile : k0 + j + 1;
      if constexpr (LIST) tile_next = j + 2 < walk.n ? walk.tile(j + 2) : 0;
      const CoarsePos at = cpos;
      if (VOTES && (COARSE ? at.start : gpos == 0)) {  // a vote step starts: snapshot m_prev
        mv_lo = m_lo;
        mv_hi = m_hi;
      }
      sm90::mbar_wait(&full[next], ((f + 1) / kStages) & 1);
      if constexpr (SPLIT) sm90::mbar_wait(&vfull[stage], (f / kStages) & 1);
      sm90::named_sync(kTurn + wg, kThreads);
      sm90::wgmma_fence();
      issue_s<DK, kKeys>(sd, q_desc, ring + next * L::kStage);
      issue_pv<DV, kKeys>(od, pf, ring + stage * L::kStage + L::kK);
      refill(f);  // while the products run
      sm90::named_arrive(kTurn + 1 - wg, kThreads);
      if constexpr (COARSE) coarse_next(walk, cpos);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sd);
      if (SPLIT && lane == 0) sm90::mbar_arrive(&empty[next]);  // this warp is done with K_{j+1}
      auto vote = [&](float mx_lo, float mx_hi) {
        if constexpr (COARSE) {
          coarse_vote(at, mx_lo, mx_hi);
        } else if constexpr (VOTES) {
          // Some valid row of this warp passes: the tile is kept.
          // Bitwise, not short-circuit: no branch on the way.
          const bool keep = ((r_lo < p.seqlen_q) & (mx_lo - mv_lo > p.thr)) |
                            ((r_hi < p.seqlen_q) & (mx_hi - mv_hi > p.thr));
          if (__any_sync(0xffffffffu, keep) && lane == 0) vrow[tile] = 0;
        }
      };
      tile_softmax<CAUSAL, DENSE, ALIBI, SEG>(s, p, range, seg, slope_log2, tile, walk.dead,
                                              warp_row0, r_lo, r_hi, m_lo, m_hi, l_lo, l_hi,
                                              alpha_lo, alpha_hi, vote);
      if constexpr (DROPOUT) drop_scores(s, tile, drop_lo, drop_hi, drop_key, c.dropout_min);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(od);
      sm90::fence_regs(pf);
      rescale_rows(o, alpha_lo, alpha_hi);
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) sm90::frag_a(pf[k], sd, k);
      if (lane == 0) sm90::mbar_arrive(&vempty[stage]);  // this warp is done with stage j
      if constexpr (LIST && VOTES) gpos = gpos + 1 == p.gsize ? 0 : gpos + 1;
    }
    // P V of the last tile. Folded, the flat walk goes on into the next
    // heads: this step refills too and then releases its stage (which is
    // otherwise never refilled).
    if constexpr (SPLIT) sm90::mbar_wait(&vfull[(walk.n - 1) % 2], ((walk.n - 1) / 2) & 1);
    sm90::wgmma_fence();
    issue_pv<DV, kKeys>(od, pf, ring + (f0 + walk.n - 1) % kStages * L::kStage + L::kK);
    if constexpr (FOLD) refill(f0 + walk.n - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(od);
    if (FOLD && lane == 0) sm90::mbar_arrive(&empty[(f0 + walk.n - 1) % kStages]);

    // Epilogue: the warpgroup's normalised rows, bf16, into its own half of
    // the Q buffer (its wgmmas are done with it) in the 128-byte swizzle, then
    // one TMA store per 64-value atom (clipped at column DV); lse from each
    // quad's first lane.
    float inv_lo, inv_hi, lse_lo, lse_hi;
    finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
    if constexpr (ALIBI) {  // the scores left out slope * shift (tile_softmax)
      lse_lo -= slope * range.shift;
      lse_hi -= slope * range.shift;
    }
    if constexpr (DROPOUT) {  // 1 / (1 - p), as JAX folds it into l_inv
      inv_lo *= c.dropout_scale;
      inv_hi *= c.dropout_scale;
    }
    unsigned char* ob = smem + L::q + 64 * wg * 128;
    const int orow = 16 * warp + g;
#pragma unroll
    for (int jb = 0; jb < DV / 8; ++jb) {
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
      for (int a = 0; a < sm90::atoms(DV); ++a) {
        sm90::tma_store_3d(&tm_o, ob + a * kRowsQ * 128, 64 * a, q0 + 64 * wg, bh);
      }
      sm90::bulk_commit();
      sm90::bulk_wait_read();  // the Q buffer stays until the stores have read it
    }
    f_head += walk.n;
  }
}

template <int DK, int DV, bool CAUSAL, int WALK, bool VOTES, bool FOLD, bool ALIBI>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, const Params p,
                     const Channels c) {
  fwd_cta<DK, DV, CAUSAL, WALK, VOTES, FOLD, ALIBI, false>(tm_q, tm_k, tm_v, tm_o, p, c);
}

// Tensor maps of q, k, v and out, then one launch of `kernel` (B1's
// instantiation at (DK, DV), FOLD heads a CTA) over (q-tiles, heads / fold,
// batch).
template <int DK, int DV, bool FOLD, typename Kernel>
cudaError_t launch(Kernel kernel, const void* q, const void* k, const void* v, void* out,
                   Params p, int batch, float scale, cudaStream_t stream, const Channels& c) {
  constexpr int keys = Tiles<DK, DV>::kKeys;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const int bh = batch * p.heads, bhk = batch * p.kv_heads;
  cudaError_t err;
  if ((err = sm90::make_tensor_map_3d(&tm_q, q, DK, p.seqlen_q, bh, 64, kRowsQ)) ||
      (err = sm90::make_tensor_map_3d(&tm_k, k, DK, p.seqlen_k, bhk, 64, keys)) ||
      (err = sm90::make_tensor_map_3d(&tm_v, v, DV, p.seqlen_k, bhk, 64, keys)) ||
      (err = sm90::make_tensor_map_3d(&tm_o, out, DV, p.seqlen_q, bh, 64, 64))) {
    return err;
  }
  p.qtiles = (p.seqlen_q + kRowsQ - 1) / kRowsQ;
  p.ktiles = (p.seqlen_k + keys - 1) / keys;
  p.causal_offset = p.seqlen_k - p.seqlen_q;
  p.scale_log2 = scale * 1.4426950408889634f;
  constexpr int smem = Smem<DK, DV>::bytes + 1024;  // + alignment of the base
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int fold = FOLD ? p.fold : 1;
  kernel<<<dim3(p.qtiles, p.heads / fold, batch), kThreads, smem, stream>>>(tm_q, tm_k, tm_v,
                                                                            tm_o, p, c);
  return cudaGetLastError();
}

// One launch of instantiation <DK, DV, CAUSAL, WALK, VOTES, FOLD, ALIBI>.
template <int DK, int DV, bool CAUSAL, int WALK = kDense, bool VOTES = false, bool FOLD = false,
          bool ALIBI = false>
cudaError_t run(const void* q, const void* k, const void* v, void* out, const Params& p,
                int batch, float scale, cudaStream_t stream, const Channels& c = Channels{}) {
  return launch<DK, DV, FOLD>(flash_fwd_kernel<DK, DV, CAUSAL, WALK, VOTES, FOLD, ALIBI>, q, k, v,
                              out, p, batch, scale, stream, c);
}

template <int D, bool VOTES>
cudaError_t run_list(const void* q, const void* k, const void* v, void* out, const Params& p,
                     int batch, float scale, cudaStream_t stream) {
  return p.fold > 1 ? run<D, D, false, kList, VOTES, true>(q, k, v, out, p, batch, scale, stream)
                    : run<D, D, false, kList, VOTES, false>(q, k, v, out, p, batch, scale, stream);
}

template <int D>
cudaError_t run_coarse(const void* q, const void* k, const void* v, void* out, const Params& p,
                       int batch, float scale, cudaStream_t stream) {
  return p.bits != nullptr ? run<D, D, false, kSuper, true>(q, k, v, out, p, batch, scale, stream)
                           : run<D, D, false, kCoarse, true>(q, k, v, out, p, batch, scale, stream);
}

// The dense walk at (D, D), with or without the ALiBi bias.
template <int D, bool CAUSAL>
cudaError_t run_dense(const void* q, const void* k, const void* v, void* out, const Params& p,
                      const Channels& c, int batch, float scale, cudaStream_t stream) {
  if (c.alibi != nullptr) {
    return run<D, D, CAUSAL, kDense, false, false, true>(q, k, v, out, p, batch, scale, stream, c);
  }
  return run<D, D, CAUSAL>(q, k, v, out, p, batch, scale, stream, c);
}

// The dense walk at head dims 80 (with the channels) and 96 (without
// ALiBi), CAUSAL when `diag`: defined in flash_fwd_hd.cu, whose nvcc runs
// beside this file's. The segment walk's instantiations and entry are in
// flash_fwd_segments.cu.
cudaError_t run_dense_hd(int head_dim, bool diag, const void* q, const void* k, const void* v,
                         void* out, const Params& p, const Channels& c, int batch, float scale,
                         cudaStream_t stream);

// The dense walk at head dim 256 with the key range (bound, low,
// bound_causal; not ALiBi), CAUSAL when `diag`: defined in
// flash_fwd_d256.cu, whose nvcc runs beside this file's.
cudaError_t run_dense_d256(bool diag, const void* q, const void* k, const void* v, void* out,
                           const Params& p, const Channels& c, int batch, float scale,
                           cudaStream_t stream);

}  // namespace fwd
}  // namespace lite

// flash_fwd_hd.cu includes the templates above and none of the entries below.
#ifndef LITE_FWD_TEMPLATES_ONLY

// B1 with its per-batch channels: q [B, H, Sq, D], k and v [B, Hk, Sk, D],
// out [B, H, Sq, D], all bf16 (D 64, 80 or 128; 96 and 256 without ALiBi); lse [B,
// H, Sq] fp32; kv_bound and kv_low [B] int32 or null; alibi [B, H] fp32
// slopes or null. Keys of
// batch b: [kv_low[b], min(Sk, kv_bound[b])); causal bottom-right at Sk - Sq;
// bound_causal (with kv_bound) bottom-right at kv_bound[b] - Sq. Returns the
// CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_masked(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const void* kv_bound, const void* kv_low,
                                     const void* alibi, int batch, int heads, int kv_heads,
                                     int seqlen_q, int seqlen_k, int head_dim, float scale,
                                     int causal, int bound_causal, int device, void* stream) {
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
  lite::Channels c{};
  c.kv_bound = static_cast<const int*>(kv_bound);
  c.kv_low = static_cast<const int*>(kv_low);
  c.alibi = static_cast<const float*>(alibi);
  c.bound_causal = bound_causal != 0 && kv_bound != nullptr;
  const bool diag = causal != 0 || c.bound_causal;  // the CAUSAL instantiation
  c.bound_only = diag && causal == 0;
  if (head_dim == 64) {
    err = diag ? run_dense<64, true>(q, k, v, out, p, c, batch, scale, s)
               : run_dense<64, false>(q, k, v, out, p, c, batch, scale, s);
  } else if (head_dim == 128) {
    err = diag ? run_dense<128, true>(q, k, v, out, p, c, batch, scale, s)
               : run_dense<128, false>(q, k, v, out, p, c, batch, scale, s);
  } else if (head_dim == 80 || head_dim == 96) {
    err = run_dense_hd(head_dim, diag, q, k, v, out, p, c, batch, scale, s);
  } else if (head_dim == 256) {
    err = run_dense_d256(diag, q, k, v, out, p, c, batch, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B1 without the channels (the entry b1_ablation.py times): q [B, H, Sq, D],
// k and v [B, Hk, Sk, D], out [B, H, Sq, D], all bf16; lse [B, H, Sq] fp32.
// Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_dense(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int batch, int heads, int kv_heads, int seqlen_q,
                                    int seqlen_k, int head_dim, float scale, int causal,
                                    int device, void* stream) {
  return lite_flash_fwd_masked(q, k, v, out, lse, nullptr, nullptr, nullptr, batch, heads,
                               kv_heads, seqlen_q, seqlen_k, head_dim, scale, causal, 0, device,
                               stream);
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

// The MLA forward at V 512, the split-O kernel of mla_fwd.cu.
cudaError_t lite_mla_fwd_v512(const void* q, const void* qv, const void* k, const void* v,
                              void* out, void* lse, int batch, int heads, int kv_heads,
                              int seqlen_q, int seqlen_k, int head_dim, float scale, bool causal,
                              cudaStream_t stream);

// B1's MLA channels: q [B, H, Sq, DK], qv [B, H, Sq, DV] or null, k [B, Hk,
// Sk, DK], v [B, Hk, Sk, DV], all bf16; out [B, H, Sq, DV] bf16, lse [B, H,
// Sq] fp32. Built for (DK, DV, qv) = (192, 128, no) on B1's kernel, and (576,
// 512, no) and (64, 512, yes) on mla_fwd.cu's; other shapes return
// cudaErrorInvalidValue. Returns the CUDA error (0 = success).
extern "C" int lite_flash_fwd_mla(const void* q, const void* qv, const void* k,
                                  const void* v, void* out, void* lse, int batch,
                                  int heads, int kv_heads, int seqlen_q, int seqlen_k,
                                  int head_dim, int head_dim_v, float scale, int causal,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_qv = qv != nullptr;
  if (head_dim == 192 && head_dim_v == 128 && !has_qv) {
    using namespace lite::fwd;
    Params p{};
    p.lse = static_cast<float*>(lse);
    p.heads = heads;
    p.kv_heads = kv_heads;
    p.seqlen_q = seqlen_q;
    p.seqlen_k = seqlen_k;
    err = causal ? run<192, 128, true>(q, k, v, out, p, batch, scale, s)
                 : run<192, 128, false>(q, k, v, out, p, batch, scale, s);
  } else if (head_dim_v == 512 && ((head_dim == 576 && !has_qv) || (head_dim == 64 && has_qv))) {
    err = lite_mla_fwd_v512(q, qv, k, v, out, lse, batch, heads, kv_heads, seqlen_q, seqlen_k,
                            head_dim, scale, causal != 0, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#endif  // LITE_FWD_TEMPLATES_ONLY
