// B7's attention-dropout channel (flash_bwd.cu:flash_bwd_dropout_kernel, the
// RANGE walk with DROPOUT, with the pre and post kernels of the one pass; the
// Pallas kernels' dropout_p, liteattention_tpu/ops/flash_bwd.py:_dq_kernel
// and _dkv_kernel): its four instantiations (head dims 64 and 128, causal or
// not) and its entry, in a source of their own so that nvcc compiles them
// beside flash_bwd.cu's (one nvcc per source, all started together).
#define LITE_BWD_TEMPLATES_ONLY
#include "flash_bwd.cu"

// B7 with attention dropout: as lite_flash_bwd_masked without ALiBi (dq_accum,
// lse2 and delta scratch; kv_bound and kv_low [B] int32 or null; causal,
// bound_causal; D 64 or 128), plus the forward's seed (one int32 on the
// device), keep_threshold = ceil(float32(p) 2^24) and keep_scale = 1 / (1 -
// p). o is B1's dropped output and lse its dropout-free lse. Returns the CUDA
// error of the launches (0 = success).
extern "C" int lite_flash_bwd_dropout(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq, void* dk,
                                      void* dv, void* dq_accum, void* lse2, void* delta,
                                      const void* kv_bound, const void* kv_low, const void* seed,
                                      int batch, int heads, int kv_heads, int seqlen_q,
                                      int seqlen_k, int head_dim, float scale, int causal,
                                      int bound_causal, int keep_threshold, float keep_scale,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (keep_threshold < 0 || keep_threshold >= (1 << 24) || seed == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using namespace lite::bwd;
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, dq_accum, lse2, delta,
               batch, heads, kv_heads, seqlen_q, seqlen_k, scale};
  lite::Channels c{};
  c.kv_bound = static_cast<const int*>(kv_bound);
  c.kv_low = static_cast<const int*>(kv_low);
  c.bound_causal = bound_causal != 0 && kv_bound != nullptr;
  const bool diag = causal != 0 || c.bound_causal;  // the CAUSAL instantiation
  c.bound_only = diag && causal == 0;
  c.dropout_seed = static_cast<const int*>(seed);
  c.dropout_min = static_cast<uint32_t>(keep_threshold) << 8;
  c.dropout_scale = keep_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = diag ? run<64, true, true, false, false, true>(a, s, c)
               : run<64, false, true, false, false, true>(a, s, c);
  } else if (head_dim == 128) {
    err = diag ? run<128, true, true, false, false, true>(a, s, c)
               : run<128, false, true, false, false, true>(a, s, c);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
