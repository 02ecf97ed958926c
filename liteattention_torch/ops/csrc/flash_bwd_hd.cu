// B7 (flash_bwd.cu) at head dims 80 and 96: their instantiations, in a
// source of their own so that nvcc compiles them beside flash_bwd.cu's
// (one nvcc per source, all started together), with the RANGE and ALIBI
// instantiations; flash_bwd.cu's entries call run_hd and run_masked_hd.
#define LITE_BWD_TEMPLATES_ONLY
#include "flash_bwd.cu"

namespace lite {
namespace bwd {

cudaError_t run_hd(int head_dim, bool causal, const Args& a, cudaStream_t stream) {
  if (head_dim == 80) return causal ? run<80, true>(a, stream) : run<80, false>(a, stream);
  if (head_dim == 96) return causal ? run<96, true>(a, stream) : run<96, false>(a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t run_masked_hd(int head_dim, bool diag, const Args& a, const Channels& c,
                          cudaStream_t stream) {
  if (head_dim == 80) {
    return diag ? run_masked<80, true>(a, c, stream) : run_masked<80, false>(a, c, stream);
  }
  if (head_dim == 96) {
    return diag ? run_masked<96, true>(a, c, stream) : run_masked<96, false>(a, c, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace lite
