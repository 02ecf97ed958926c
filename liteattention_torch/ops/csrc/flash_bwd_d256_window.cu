// B7's window and softcap channels at head dim 256 (flash_bwd_d256.cu:
// flash_bwd_d256_channels_kernel with RANGE and WINDOW / SOFTCAP, with the
// pre and post kernels of the one pass; the Pallas kernels' window and
// softcap, liteattention_tpu/ops/flash_bwd.py:_dq_kernel and _dkv_kernel, at
// Gemma-2's and Gemma-3's head dim): six instantiations (causal or not; the
// window, the cap, or both, each over B1's key range), in a source of their
// own so that nvcc compiles them beside flash_bwd_d256.cu's (one nvcc per
// source, all started together); flash_bwd_window.cu's entry calls
// run_window_d256.
#define LITE_BWD_D256_TEMPLATES_ONLY
#include "flash_bwd_d256.cu"

namespace lite {
namespace bwd {

cudaError_t run_window_d256(bool diag, const Args& a, const Channels& c, bool window,
                            cudaStream_t stream) {
  // d256::run<CAUSAL, RANGE, SEG, WINDOW, SOFTCAP>
  if (window && c.cap > 0.f) {
    return diag ? d256::run<true, true, false, true, true>(a, stream, c)
                : d256::run<false, true, false, true, true>(a, stream, c);
  }
  if (window) {
    return diag ? d256::run<true, true, false, true, false>(a, stream, c)
                : d256::run<false, true, false, true, false>(a, stream, c);
  }
  return diag ? d256::run<true, true, false, false, true>(a, stream, c)
              : d256::run<false, true, false, false, true>(a, stream, c);
}

}  // namespace bwd
}  // namespace lite
