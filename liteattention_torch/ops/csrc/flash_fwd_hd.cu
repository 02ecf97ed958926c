// B1 (flash_fwd.cu:flash_fwd_kernel) at head dims 80 and 96: the dense
// walk's instantiations, in a source of their own so that nvcc compiles
// them beside flash_fwd.cu's (one nvcc per source, all started together).
// At 80 with every channel (bound, low, bound_causal, ALiBi), at 96 without
// ALiBi; flash_fwd.cu's entries call run_dense_hd.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

namespace lite {
namespace fwd {

cudaError_t run_dense_hd(int head_dim, bool diag, const void* q, const void* k, const void* v,
                         void* out, const Params& p, const Channels& c, int batch, float scale,
                         cudaStream_t stream) {
  if (head_dim == 80) {
    return diag ? run_dense<80, true>(q, k, v, out, p, c, batch, scale, stream)
                : run_dense<80, false>(q, k, v, out, p, c, batch, scale, stream);
  }
  if (head_dim == 96 && c.alibi == nullptr) {  // no ALiBi instantiation at 96
    return diag ? run<96, 96, true>(q, k, v, out, p, batch, scale, stream, c)
                : run<96, 96, false>(q, k, v, out, p, batch, scale, stream, c);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fwd
}  // namespace lite
