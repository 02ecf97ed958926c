// The one test of which keys a q row may not see, shared by the forward
// kernels (B1 in flash_fwd.cu; B3-B5 through attention_fwd.cuh) and the
// backward (B7, flash_bwd.cu), so that a mask channel added here hides the
// same keys forwards and backwards.
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
// kv_low[b] hidden too. (B7 takes the four-argument test until it takes
// these channels.)
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int lim, int diag, int low) {
  return key_masked<CAUSAL>(key, row, lim, diag) || key < low;
}

}  // namespace lite
