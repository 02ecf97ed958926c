// B7's segment walk at head dim 256 (flash_bwd_d256.cu:
// flash_bwd_d256_channels_kernel with SEG, alone or with WINDOW / SOFTCAP,
// with the pre and post kernels of the one pass; the Pallas kernels'
// has_segments with window and softcap, liteattention_tpu/ops/flash_bwd.py:
// _dq_kernel and _dkv_kernel, as the varlen functions pass them over packed
// documents at Gemma's head dim): eight instantiations (causal or not; no
// channel, the window, the cap, or both; not dropout), in a source of their
// own so that nvcc compiles them beside flash_bwd_d256.cu's (one nvcc per
// source, all started together); lite_flash_bwd_segments and
// lite_flash_bwd_segments_channels call run_segments_d256 and
// run_segment_channels_d256. A 64-key CTA walks the q rows of the 128-key
// tile that holds it (ops/segments.py's ranges and spans are per 128 keys).
#define LITE_BWD_D256_TEMPLATES_ONLY
#include "flash_bwd_d256.cu"

namespace lite {
namespace bwd {

cudaError_t run_segments_d256(bool causal, const Args& a, const Channels& c,
                              cudaStream_t stream) {
  // d256::run<CAUSAL, RANGE, SEG, WINDOW, SOFTCAP>
  return causal ? d256::run<true, false, true>(a, stream, c)
                : d256::run<false, false, true>(a, stream, c);
}

cudaError_t run_segment_channels_d256(bool causal, const Args& a, const Channels& c, bool window,
                                      cudaStream_t stream) {
  if (c.dropout_seed != nullptr) return cudaErrorInvalidValue;  // no dropout at 256
  if (window && c.cap > 0.f) {
    return causal ? d256::run<true, false, true, true, true>(a, stream, c)
                  : d256::run<false, false, true, true, true>(a, stream, c);
  }
  if (window) {
    return causal ? d256::run<true, false, true, true, false>(a, stream, c)
                  : d256::run<false, false, true, true, false>(a, stream, c);
  }
  return causal ? d256::run<true, false, true, false, true>(a, stream, c)
                : d256::run<false, false, true, false, true>(a, stream, c);
}

}  // namespace bwd
}  // namespace lite
