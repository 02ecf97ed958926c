// B1's attention-dropout channel (flash_fwd.cu:fwd_cta with DROPOUT, the
// dense walk with the key range; the Pallas kernel's dropout_p,
// liteattention_tpu/ops/flash_fwd.py:_fwd_kernel): its kernel, its four
// instantiations (head dims 64 and 128, causal or not) and its entry, in a
// source of their own so that nvcc compiles them beside flash_fwd.cu's (one
// nvcc per source, all started together).
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

namespace lite {
namespace fwd {

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_dropout_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_o, const Params p,
                             const Channels c) {
  fwd_cta<D, D, CAUSAL, kDense, false, false, false, true>(tm_q, tm_k, tm_v, tm_o, p, c);
}

template <int D>
cudaError_t run_dropout(const void* q, const void* k, const void* v, void* out, const Params& p,
                        const Channels& c, bool diag, int batch, float scale,
                        cudaStream_t stream) {
  return diag ? launch<D, D, false>(flash_fwd_dropout_kernel<D, true>, q, k, v, out, p, batch,
                                    scale, stream, c)
              : launch<D, D, false>(flash_fwd_dropout_kernel<D, false>, q, k, v, out, p, batch,
                                    scale, stream, c);
}

}  // namespace fwd
}  // namespace lite

// B1 with attention dropout: as lite_flash_fwd_masked (q [B, H, Sq, D], k and
// v [B, Hk, Sk, D], out [B, H, Sq, D], all bf16, D 64 or 128; lse [B, H, Sq]
// fp32; kv_bound and kv_low [B] int32 or null; causal, bound_causal), plus
// seed, one int32 on the device, keep_threshold = ceil(float32(p) 2^24) (a
// score is kept iff its hash >> 8 reaches it) and keep_scale = 1 / (1 - p).
// lse is dropout-free. Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_dropout(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const void* kv_bound, const void* kv_low,
                                      const void* seed, int batch, int heads, int kv_heads,
                                      int seqlen_q, int seqlen_k, int head_dim, float scale,
                                      int causal, int bound_causal, int keep_threshold,
                                      float keep_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (keep_threshold < 0 || keep_threshold >= (1 << 24) || seed == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lite::fwd;
  Params p{};
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  lite::Channels c{};
  c.kv_bound = static_cast<const int*>(kv_bound);
  c.kv_low = static_cast<const int*>(kv_low);
  c.bound_causal = bound_causal != 0 && kv_bound != nullptr;
  const bool diag = causal != 0 || c.bound_causal;  // the CAUSAL instantiation
  c.bound_only = diag && causal == 0;
  c.dropout_seed = static_cast<const int*>(seed);
  c.dropout_min = static_cast<uint32_t>(keep_threshold) << 8;
  c.dropout_scale = keep_scale;
  if (head_dim == 64) {
    err = run_dropout<64>(q, k, v, out, p, c, diag, batch, scale, s);
  } else if (head_dim == 128) {
    err = run_dropout<128>(q, k, v, out, p, c, diag, batch, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
