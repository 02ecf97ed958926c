// B1's window, attention_chunk and softcap channels at head dim 256
// (flash_fwd.cu:flash_fwd_window_kernel, fwd_cta with WINDOW and / or SOFTCAP
// on the dense walk with the key range; the Pallas kernel's window,
// attention_chunk and softcap, liteattention_tpu/ops/flash_fwd.py:
// _fwd_kernel, at Gemma-2's and Gemma-3's head dim): six instantiations
// (causal or not; the window with or without the chunk, the cap, or both),
// in a source of their own so that nvcc compiles them beside
// flash_fwd_window.cu's (one nvcc per source, all started together);
// flash_fwd_window.cu's entry calls run_window_d256.
//
// The walk is the D 256 one (flash_fwd.cu: Tiles, 64-key tiles in two
// stages): window_range narrows the key range in keys, and dense_walk cuts
// it into 64-key tiles, so the window's first tile is the one holding its
// left edge; tile_softmax tests its keys against the warp's common interval
// at the tile's own width. The cap's constants and the two rows' intervals
// take a thread's registers beside O's 128.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

namespace lite {
namespace fwd {

cudaError_t run_window_d256(const void* q, const void* k, const void* v, void* out,
                            const Params& p, const Channels& c, bool diag, bool window, int batch,
                            float scale, cudaStream_t stream) {
  return run_window_channels<256>(q, k, v, out, p, c, diag, window, batch, scale, stream);
}

}  // namespace fwd
}  // namespace lite
