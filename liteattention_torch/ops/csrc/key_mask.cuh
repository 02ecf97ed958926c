// The one test of which keys a q row may not see, shared by the forward
// kernels (B1 in flash_fwd.cu; B3-B5 through attention_fwd.cuh) and the
// backward (B7, flash_bwd.cu), so that a mask channel added here hides the
// same keys forwards and backwards; and the per-batch key range of B1's
// channels, which B1 and B7 read the same way.
#pragma once

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

// B1's per-batch channels, forwards (B1's dense walk) and backwards (B7's
// RANGE / ALIBI instantiations); null when absent: keys [kv_low[b],
// kv_bound[b]), the diagonal at kv_bound[b] - Sq with bound_causal (alone,
// without causal, when bound_only), ALiBi slopes [B, H].
struct Channels {
  const int* kv_bound;
  const int* kv_low;
  const float* alibi;
  int bound_causal, bound_only;
};

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

}  // namespace lite
