// The decode kernel B8 / B9a / B9b (flash_decode.cu:flash_decode_kernel) at
// head dim 256 (GPT-J-6B), bf16 and int8 caches (int8_mma, cache_batch_idx):
// its instantiations, in a
// source of their own so that nvcc compiles them beside flash_decode.cu's
// (one nvcc per source, all started together). 64-key tiles, 8 a warp
// (flash_decode.cu: Layout); lite_flash_decode calls launch_d256.
#define LITE_DECODE_TEMPLATES_ONLY
#include "flash_decode.cu"

namespace decode {

cudaError_t launch_d256(bool int8, bool q8, bool idx, const Params& p, const void* k,
                        const void* v, const int* kn, const long long* kst, const int* vn,
                        const long long* vst, int grid, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  return q8     ? launch<256, uint8_t, true>(p, k, v, kn, kst, vn, vst, grid, stream)
         : int8 ? launch<256, uint8_t>(p, k, v, kn, kst, vn, vst, grid, stream)
         : idx  ? launch<256, bf16, false, true>(p, k, v, kn, kst, vn, vst, grid, stream)
                : launch<256, bf16>(p, k, v, kn, kst, vn, vst, grid, stream);
}

}  // namespace decode
