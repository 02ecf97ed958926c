// B7's window and softcap channels (flash_bwd.cu:flash_bwd_window_kernel,
// the RANGE walk with WINDOW and / or SOFTCAP, with the pre and post kernels
// of the one pass; the Pallas kernels' window and softcap,
// liteattention_tpu/ops/flash_bwd.py:_dq_kernel and _dkv_kernel): its
// twelve instantiations (head dims 64 and 128, causal or not; the window,
// the cap, or both) and its entry, in a source of their own so that nvcc
// compiles them beside flash_bwd.cu's (one nvcc per source, all started
// together); head dim 256's are flash_bwd_d256_window.cu's.
#define LITE_BWD_TEMPLATES_ONLY
#include "flash_bwd.cu"

namespace lite {
namespace bwd {

template <int D, bool CAUSAL>
cudaError_t run_window(const Args& a, const Channels& c, bool window, cudaStream_t stream) {
  // run<D, CAUSAL, RANGE, ALIBI, SEG, DROPOUT, WINDOW, SOFTCAP>
  if (window && c.cap > 0.f) {
    return run<D, CAUSAL, true, false, false, false, true, true>(a, stream, c);
  }
  if (window) return run<D, CAUSAL, true, false, false, false, true, false>(a, stream, c);
  return run<D, CAUSAL, true, false, false, false, false, true>(a, stream, c);
}

}  // namespace bwd
}  // namespace lite

// B7 with the window and softcap channels: as lite_flash_bwd_masked without
// ALiBi (dq_accum, lse2 and delta scratch; kv_bound and kv_low [B] int32 or
// null; causal, bound_causal; D 64, 128 or 256), plus the forward's window sides
// win_left and win_right (-1: unbounded; at most 2^29) and softcap (0:
// none); at least one of them on. lse is B1's with the same channels.
// Returns the CUDA error of the launches (0 = success).
extern "C" int lite_flash_bwd_window(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* dq, void* dk,
                                     void* dv, void* dq_accum, void* lse2, void* delta,
                                     const void* kv_bound, const void* kv_low, int batch,
                                     int heads, int kv_heads, int seqlen_q, int seqlen_k,
                                     int head_dim, float scale, int causal, int bound_causal,
                                     int win_left, int win_right, float softcap, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool window = win_left >= 0 || win_right >= 0;
  if ((!window && !(softcap > 0.f)) || softcap < 0.f || win_left < -1 || win_right < -1 ||
      win_left > (1 << 29) || win_right > (1 << 29)) {
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
  c.win_left = win_left;
  c.win_right = win_right;
  c.cap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = diag ? run_window<64, true>(a, c, window, s) : run_window<64, false>(a, c, window, s);
  } else if (head_dim == 128) {
    err = diag ? run_window<128, true>(a, c, window, s) : run_window<128, false>(a, c, window, s);
  } else if (head_dim == 256) {
    err = run_window_d256(diag, a, c, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
