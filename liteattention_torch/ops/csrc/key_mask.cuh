// The one test of which keys a q row may not see, shared by the forward
// kernels (B1 in flash_fwd.cu; B3-B5 through attention_fwd.cuh) and the
// backward (B7, flash_bwd.cu), so that a mask channel added here hides the
// same keys forwards and backwards; the per-batch key range of B1's
// channels, which B1 and B7 read the same way; the segment walks' ids and
// ranges (B1's and B7's segment channel); the attention-dropout keep test,
// which B1 and B7 regenerate from one seed; and the window channel's
// intervals and the softcap channel's tanh, which B1 and B7 compute alike.
#pragma once

#include <stdint.h>

namespace lite {

// Key `key` is hidden from q row `row`: past Sk, or, with CAUSAL, above the
// bottom-right-aligned diagonal (causal_offset = Sk - Sq, key valid iff
// key <= row + causal_offset). Later mask channels (window, segments) add
// their tests here.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int seqlen_k, int causal_offset) {
  return key >= seqlen_k || (CAUSAL && key > row + causal_offset);
}

// The same with B1's per-batch channels: the key limit min(Sk, kv_bound[b]),
// the diagonal at kv_bound[b] - Sq with bound_causal, and keys before
// kv_low[b] hidden too (a KeyRange's fields). The channel-free kernels keep
// the four-argument test: a fifth argument cost B7 15 registers and GPT-2
// small's backward 14 % on an H100.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int lim, int diag, int low) {
  return key_masked<CAUSAL>(key, row, lim, diag) || key < low;
}

// The same with segment ids (the JAX kernels' has_segments): a key is seen
// only by the rows whose id equals its own. Its own form, so that the
// channel-free and per-batch instantiations keep theirs.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int lim, int diag, int low, int q_id,
                                           int k_id) {
  return key_masked<CAUSAL>(key, row, lim, diag, low) || q_id != k_id;
}

// The same with the window channel (the JAX kernels' window and
// attention_chunk): a key outside the row's interval [win.x, win.y) is
// hidden too (row_window gives it). Its own form, so that the other
// instantiations keep theirs.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int lim, int diag, int low, int2 win) {
  return key_masked<CAUSAL>(key, row, lim, diag, low) || key < win.x || key >= win.y;
}

// Segment ids and the window together (the segment walks with WINDOW; the
// varlen functions' window over packed documents): same id, inside the
// row's interval, at or below the diagonal, in one test.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int lim, int diag, int low, int q_id,
                                           int k_id, int2 win) {
  return key_masked<CAUSAL>(key, row, lim, diag, low, q_id, k_id) || key < win.x ||
         key >= win.y;
}

// B1's per-batch channels, forwards (B1's dense walk) and backwards (B7's
// RANGE / ALIBI instantiations); null when absent: keys [kv_low[b],
// kv_bound[b]), the diagonal at kv_bound[b] - Sq with bound_causal (alone,
// without causal, when bound_only), ALiBi slopes [B, H].
struct Channels {
  const int* kv_bound;
  const int* kv_low;
  const float* alibi;
  int bound_causal, bound_only;
  // The segment walks (batch 1; null elsewhere): q and key ids, each padded
  // to whole 128-row tiles with its last id; B1's key range [x, y) per
  // 128-row q-tile, or B7's q-row range per 128-key tile; each 128-key
  // tile's least and largest id; B7: each 64-row q block's.
  const int* q_seg;
  const int* k_seg;
  const int2* range;
  const int2* k_span;
  const int2* q_span;
  // Attention dropout (the DROPOUT instantiations of B1's dense walk and
  // B7's RANGE one, and of both segment walks): the int32 seed on the
  // device, the least kept hash (dropout_keep) and 1 / (1 - p).
  const int* dropout_seed;
  uint32_t dropout_min;
  float dropout_scale;
  // The window channel (the WINDOW instantiations of B1's dense walk and
  // B7's RANGE one, and of both segment walks): row r at position pos = r
  // + off (off = kv_bound[b] - Sq with kv_bound, else Sk - Sq) sees keys
  // [pos - win_left, pos + win_right] (-1: that side unbounded) and, with
  // chunk > 0 (B1 only), keys [floor(pos / chunk) chunk, + chunk). SOFTCAP:
  // cap > 0, the scores become cap tanh(s scale / cap) before the mask.
  int win_left, win_right, chunk;
  float cap;
};

// The JAX kernels' counter-based dropout mask (liteattention_tpu/ops/
// flash_fwd.py:dropout_keep_mask, ops/dropout.py in this package): a pure
// function of (seed, b * H + q head, the global q row, the global key
// column), so B1's 128-key tiles and B7's 64-row steps regenerate the same
// bits. Every product is mod 2^32. dropout_key is the (seed, bh) term,
// dropout_pos the position term row * kDropRow + col * kDropCol (callers
// add a row's and a column's share, each computed once).
constexpr uint32_t kDropRow = 0x9E3779B9u;
constexpr uint32_t kDropCol = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t dropout_key(int seed, int bh) {
  return static_cast<uint32_t>(seed) * 0xCC9E2D51u + static_cast<uint32_t>(bh) * 0x1B873593u;
}

// Kept iff murmur3's fmix32 of pos ^ key is at least dropout_min: JAX keeps
// a score iff (x >> 8) 2^-24 >= float32(p), both sides exact in fp32, that
// is x >> 8 >= ceil(float32(p) 2^24), that is x >= that << 8 (the host's
// Channels::dropout_min).
__device__ __forceinline__ bool dropout_keep(uint32_t pos, uint32_t key, uint32_t keep_min) {
  uint32_t x = pos ^ key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= keep_min;
}

// The diagonal offset of "no diagonal" (bound_causal's offset replaces it).
constexpr int kNoDiag = 1 << 29;

// The keys of batch b, uniform over a CTA: [low, lim), and with CAUSAL
// those at most row + diag. Without the channels [0, Sk) at diag Sk - Sq.
// shift: the least ALiBi distance of a visible key, Sk - kv_bound[b] with
// bound_causal (else 0).
struct KeyRange {
  int low, lim, diag, shift;
};

// Read once per CTA; each field goes through lane 0 so that the compiler
// sees it warp-uniform (the walk's length and TMA's coordinates derive from
// it).
__device__ __forceinline__ KeyRange key_range(const Channels& c, int b, int seqlen_q, int seqlen_k,
                                              int causal_offset) {
  KeyRange r{0, seqlen_k, c.bound_only ? kNoDiag : causal_offset, 0};
  if (c.kv_bound != nullptr) {
    const int bound = __ldg(c.kv_bound + b);
    r.lim = min(r.lim, max(bound, 0));
    if (c.bound_causal) {
      r.diag = min(r.diag, bound - seqlen_q);
      r.shift = max(seqlen_k - bound, 0);
    }
  }
  if (c.kv_low != nullptr) r.low = max(__ldg(c.kv_low + b), 0);
  r.low = __shfl_sync(0xffffffffu, r.low, 0);
  r.lim = __shfl_sync(0xffffffffu, r.lim, 0);
  r.diag = __shfl_sync(0xffffffffu, r.diag, 0);
  r.shift = __shfl_sync(0xffffffffu, r.shift, 0);
  return r;
}

// A key bound no key or row reaches (B7's tests off the tiles that need
// them; the window's open sides, +-): a position added to it stays in int
// range.
constexpr int kNoBound = 1 << 30;

// floor(a / b) for b > 0 (C++'s / truncates toward zero; JAX's // floors).
__device__ __forceinline__ int floor_div(int a, int b) {
  return (a >= 0 ? a : a - b + 1) / b;
}

// The window channel of batch b, uniform over a CTA: each row's position
// offset off (pos = row + off) and the channel's sides.
struct Window {
  int off, left, right, chunk;
};

// Read once per CTA through lane 0, as key_range. kv_bound is clamped to
// +-2^29 so that no position overflows.
__device__ __forceinline__ Window window_of(const Channels& c, int b, int seqlen_q, int seqlen_k) {
  int off = seqlen_k - seqlen_q;
  if (c.kv_bound != nullptr) off = max(min(__ldg(c.kv_bound + b), 1 << 29), -(1 << 29)) - seqlen_q;
  return Window{__shfl_sync(0xffffffffu, off, 0), c.win_left, c.win_right, c.chunk};
}

// Row `row`'s keys under the window and chunk: [x, y) (empty when x >= y).
// Both ends are nondecreasing in the row.
__device__ __forceinline__ int2 row_window(const Window& w, int row) {
  const int pos = row + w.off;
  int lo = w.left >= 0 ? pos - w.left : -kNoBound;
  int hi = w.right >= 0 ? pos + w.right + 1 : kNoBound;
  if (w.chunk > 0) {
    const int start = floor_div(pos, w.chunk) * w.chunk;
    lo = max(lo, start);
    hi = min(hi, start + w.chunk);
  }
  return make_int2(lo, hi);
}

// B1's window walk: the keys of the q-tile's rows [q0, q0 + rows) (rows >=
// 1, the valid rows of the tile) under the window: the union of their
// intervals, [the first row's start, the last row's end) since both ends
// are nondecreasing, intersected with the key range r (its low and lim
// narrowed in place). Uniform over the CTA: w is, and so are q0 and rows.
__device__ __forceinline__ void window_range(const Window& w, int q0, int rows, KeyRange& r) {
  r.low = max(r.low, row_window(w, q0).x);
  r.lim = min(r.lim, row_window(w, q0 + rows - 1).y);
}

// The softcap channel's tanh, which B1 and B7 compute alike: tanh(x) from y =
// 2 x log2(e) (callers fold that factor into their scale), as 1 - 2 / (2^y +
// 1) on ex2.approx and rcp.approx: absolute error near 2e-7, where
// tanh.approx.f32's is near 2^-11 (0.025 in a natural-log score at cap 50,
// a 2-3 % error in a softmax weight). Two MUFU operations a score. It
// saturates to +-1: 2^y overflows to inf (1 / inf = 0) or underflows to 0.
__device__ __forceinline__ float softcap_tanh(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}

// A walk's range [x, y) from the segment walk's `range` entry `tile`, read
// once per CTA through lane 0 (uniform to the compiler, as key_range's).
__device__ __forceinline__ int2 segment_range(const Channels& c, int tile) {
  const int2 r = __ldg(c.range + tile);
  return make_int2(__shfl_sync(0xffffffffu, r.x, 0), __shfl_sync(0xffffffffu, r.y, 0));
}

// Whether every key of a span and every row of another carry one id, so
// that no score between them needs the segment test.
__device__ __forceinline__ bool one_segment(int2 keys, int2 rows) {
  return keys.x == keys.y && rows.x == rows.y && keys.x == rows.x;
}

}  // namespace lite
