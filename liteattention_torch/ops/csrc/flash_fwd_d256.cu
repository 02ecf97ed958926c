// B1 (flash_fwd.cu:flash_fwd_kernel) at head dim 256 (GPT-J-6B): the dense
// walk's instantiations, in a source of their own so that nvcc compiles
// them beside flash_fwd.cu's (one nvcc per source, all started together).
// 64-key tiles in two stages (flash_fwd.cu: Tiles), with the key range of
// B1's channels (bound, low, bound_causal) and not ALiBi; flash_fwd.cu's
// entries call run_dense_d256.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

namespace lite {
namespace fwd {

cudaError_t run_dense_d256(bool diag, const void* q, const void* k, const void* v, void* out,
                           const Params& p, const Channels& c, int batch, float scale,
                           cudaStream_t stream) {
  if (c.alibi != nullptr) return cudaErrorInvalidValue;  // no ALiBi instantiation at 256
  return diag ? run<256, 256, true>(q, k, v, out, p, batch, scale, stream, c)
              : run<256, 256, false>(q, k, v, out, p, batch, scale, stream, c);
}

}  // namespace fwd
}  // namespace lite
