// The one test of which keys a q row may not see, shared by the forward
// kernels (B1 in flash_fwd.cu; B3-B5 through attention_fwd.cuh) and the
// backward (B7, flash_bwd.cu), so that a mask channel added here hides the
// same keys forwards and backwards.
#pragma once

namespace lite {

// Key `key` is hidden from q row `row`: past Sk, or, with CAUSAL, above the
// bottom-right-aligned diagonal (causal_offset = Sk - Sq, key valid iff
// key <= row + causal_offset). Later mask channels (window, ALiBi bounds,
// segments) add their tests here.
template <bool CAUSAL>
__device__ __forceinline__ bool key_masked(int key, int row, int seqlen_k, int causal_offset) {
  return key >= seqlen_k || (CAUSAL && key > row + causal_offset);
}

}  // namespace lite
