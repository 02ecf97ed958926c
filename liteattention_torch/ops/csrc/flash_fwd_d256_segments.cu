// B1's segment walk at head dim 256 (flash_fwd.cu:fwd_cta walking kSegment:
// flash_fwd_kernel alone, flash_fwd_segments_channels_kernel with the window
// / chunk / softcap channels; the Pallas kernel's has_segments with window
// and softcap, liteattention_tpu/ops/flash_fwd.py:_fwd_kernel, as the varlen
// functions pass them over packed documents at Gemma's head dim): eight
// instantiations (causal or not; no channel, the window with or without the
// chunk, the cap, or both; not dropout), in a source of their own so that
// nvcc compiles them beside flash_fwd_segments.cu's (one nvcc per source, all
// started together); lite_flash_fwd_segments and
// lite_flash_fwd_segments_channels call run_segments_d256 and
// run_segment_channels_d256.
//
// The walk's tiles are 64 keys (flash_fwd.cu: Tiles) while ops/segments.py
// gives each q-tile's key range in keys and each 128-key tile's id span: the
// range cuts into 64-key tiles as the dense walk's does, and a tile reads the
// span of the 128-key tile that holds it (tile_softmax), a superset of its
// own keys' ids. The one-segment test stays sound (it can only send a tile
// to the per-element test that a 64-key span would have spared), and the
// walk needs no second set of spans.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

namespace lite {
namespace fwd {

cudaError_t run_segments_d256(const void* q, const void* k, const void* v, void* out,
                              const Params& p, const Channels& c, bool causal, float scale,
                              cudaStream_t stream) {
  return run_segments<256>(q, k, v, out, p, c, causal, scale, stream);
}

cudaError_t run_segment_channels_d256(const void* q, const void* k, const void* v, void* out,
                                      const Params& p, const Channels& c, bool causal,
                                      bool window, float scale, cudaStream_t stream) {
  return run_segment_channels<256>(q, k, v, out, p, c, causal, window, scale, stream);
}

}  // namespace fwd
}  // namespace lite
