// The decode kernel B8 / B9a / B9b (flash_decode.cu:flash_decode_kernel) at
// head dims 80 (Pythia) and 96 (GPT-NeoX-20B), bf16 and int8 caches
// (cache_batch_idx; no int8_mma: JAX's asserts d % 128 == 0): its
// instantiations, in a source of their own so that nvcc compiles them
// beside flash_decode.cu's (one nvcc per source, all started together).
// Rows of 128 stored channels, TMA's zeros past D (flash_decode.cu:
// Layout::kDp); lite_flash_decode calls launch_hd.
#define LITE_DECODE_TEMPLATES_ONLY
#include "flash_decode.cu"

namespace decode {

template <int D>
cudaError_t launch_at(bool int8, bool idx, const Params& p, const void* k, const void* v,
                      const int* kn, const long long* kst, const int* vn, const long long* vst,
                      int grid, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  return int8  ? launch<D, uint8_t>(p, k, v, kn, kst, vn, vst, grid, stream)
         : idx ? launch<D, bf16, false, true>(p, k, v, kn, kst, vn, vst, grid, stream)
               : launch<D, bf16>(p, k, v, kn, kst, vn, vst, grid, stream);
}

cudaError_t launch_hd(int head_dim, bool int8, bool idx, const Params& p, const void* k,
                      const void* v, const int* kn, const long long* kst, const int* vn,
                      const long long* vst, int grid, cudaStream_t stream) {
  if (head_dim == 80) return launch_at<80>(int8, idx, p, k, v, kn, kst, vn, vst, grid, stream);
  if (head_dim == 96) return launch_at<96>(int8, idx, p, k, v, kn, kst, vn, vst, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace decode
