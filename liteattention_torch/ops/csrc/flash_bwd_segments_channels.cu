// B7's segment walk with the dropout, window and softcap channels
// (flash_bwd.cu:flash_bwd_segments_channels_kernel, with the pre and post
// kernels of the one pass; the Pallas kernels' has_segments with dropout_p,
// window and softcap, liteattention_tpu/ops/flash_bwd.py:_dq_kernel and
// _dkv_kernel, as the varlen functions pass them over packed documents): its
// sixteen instantiations (head dims 64 and 128, causal or not; the window,
// the cap, both, or dropout) and its entry, in a source of their own so that
// nvcc compiles them beside flash_bwd_segments.cu's (one nvcc per source, all
// started together); head dim 256's six (no dropout) are
// flash_bwd_d256_segments.cu's.
#define LITE_BWD_TEMPLATES_ONLY
#include "flash_bwd.cu"

namespace lite {
namespace bwd {

// The instantiation of the channels in use: dropout, or the window, the cap,
// or both.
template <int D, bool CAUSAL>
cudaError_t run_segment_channels(const Args& a, const Channels& c, bool window,
                                 cudaStream_t stream) {
  // run<D, CAUSAL, RANGE, ALIBI, SEG, DROPOUT, WINDOW, SOFTCAP>
  if (c.dropout_seed != nullptr) {
    return run<D, CAUSAL, false, false, true, true, false, false>(a, stream, c);
  }
  if (window && c.cap > 0.f) {
    return run<D, CAUSAL, false, false, true, false, true, true>(a, stream, c);
  }
  if (window) return run<D, CAUSAL, false, false, true, false, true, false>(a, stream, c);
  return run<D, CAUSAL, false, false, true, false, false, true>(a, stream, c);
}

}  // namespace bwd
}  // namespace lite

// B7 with segment ids and the dropout, window or softcap channels, batch 1:
// as lite_flash_bwd_segments (dq_accum, lse2 and delta scratch; q_seg, k_seg,
// range, q_span and k_span; D 64 or 128, or 256 without dropout), plus the
// forward's window sides win_left and win_right (-1: unbounded; at most
// 2^29) and softcap (0: none), as lite_flash_bwd_window takes them; or its
// seed (one int32 on the device, null without dropout), keep_threshold =
// ceil(float32(p) 2^24) and keep_scale = 1 / (1 - p), as
// lite_flash_bwd_dropout takes them. Either dropout or at
// least one of the other two must be on, not both. o and lse are B1's with
// the same ids and channels. Returns the CUDA error of the launches (0 =
// success).
extern "C" int lite_flash_bwd_segments_channels(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* dq_accum, void* lse2, void* delta,
    const void* q_seg, const void* k_seg, const void* range, const void* q_span,
    const void* k_span, const void* seed, int heads, int kv_heads, int seqlen_q, int seqlen_k,
    int head_dim, float scale, int causal, int win_left, int win_right, float softcap,
    int keep_threshold, float keep_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool window = win_left >= 0 || win_right >= 0;
  const bool dropout = seed != nullptr;
  if (dropout == (window || softcap > 0.f) || softcap < 0.f || win_left < -1 || win_right < -1 ||
      win_left > (1 << 29) || win_right > (1 << 29) ||
      (dropout && (keep_threshold < 0 || keep_threshold >= (1 << 24)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using namespace lite::bwd;
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, dq_accum, lse2, delta,
               1, heads, kv_heads, seqlen_q, seqlen_k, scale};
  lite::Channels c{};
  c.q_seg = static_cast<const int*>(q_seg);
  c.k_seg = static_cast<const int*>(k_seg);
  c.range = static_cast<const int2*>(range);
  c.q_span = static_cast<const int2*>(q_span);
  c.k_span = static_cast<const int2*>(k_span);
  c.win_left = win_left;
  c.win_right = win_right;
  c.cap = softcap;
  c.dropout_seed = static_cast<const int*>(seed);
  c.dropout_min = static_cast<uint32_t>(keep_threshold) << 8;
  c.dropout_scale = keep_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool diag = causal != 0;
  if (head_dim == 64) {
    err = diag ? run_segment_channels<64, true>(a, c, window, s)
               : run_segment_channels<64, false>(a, c, window, s);
  } else if (head_dim == 128) {
    err = diag ? run_segment_channels<128, true>(a, c, window, s)
               : run_segment_channels<128, false>(a, c, window, s);
  } else if (head_dim == 256) {
    err = run_segment_channels_d256(diag, a, c, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
