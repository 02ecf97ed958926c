// B1's segment walk with the window, attention_chunk, softcap and dropout
// channels (flash_fwd.cu:flash_fwd_segments_channels_kernel, fwd_cta walking
// kSegment with WINDOW, SOFTCAP or DROPOUT; the Pallas kernel's has_segments
// with window, softcap and dropout_p, liteattention_tpu/ops/flash_fwd.py:
// _fwd_kernel, as the varlen functions pass them over packed documents): its
// sixteen instantiations at head dims 64 and 128 (causal or not; the window
// with or without the chunk, the cap, both, or dropout) and its entry, in a
// source of their own so that nvcc compiles them beside
// flash_fwd_segments.cu's (one nvcc per source, all started together); head
// dim 256's six (no dropout) are flash_fwd_d256_segments.cu's.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

// B1 with segment ids and the window / chunk / softcap or dropout channels,
// batch 1: as lite_flash_fwd_segments (q [1, H, Sq, D], k and v [1, Hk, Sk,
// D], out [1, H, Sq, D], all bf16, D 64 or 128, or 256 without dropout; lse
// [1, H, Sq] fp32; q_seg, k_seg, range and k_span), plus the window's sides
// win_left and win_right (-1: unbounded; at most 2^29), chunk (0: none) and
// softcap (0: none) about pos = row + Sk - Sq, as lite_flash_fwd_window
// takes them; or seed (one int32 on the device, null without dropout),
// keep_threshold = ceil(float32(p) 2^24) and keep_scale = 1 / (1 - p), as
// lite_flash_fwd_dropout takes them.
// Either dropout or at least one of the other three must be on, not both.
// lse is dropout-free. Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_segments_channels(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* q_seg,
    const void* k_seg, const void* range, const void* k_span, const void* seed, int heads,
    int kv_heads, int seqlen_q, int seqlen_k, int head_dim, float scale, int causal, int win_left,
    int win_right, int chunk, float softcap, int keep_threshold, float keep_scale, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool window = win_left >= 0 || win_right >= 0 || chunk > 0;
  const bool dropout = seed != nullptr;
  if (dropout == (window || softcap > 0.f) || softcap < 0.f || chunk < 0 || win_left < -1 ||
      win_right < -1 || win_left > (1 << 29) || win_right > (1 << 29) || chunk > (1 << 29) ||
      (dropout && (keep_threshold < 0 || keep_threshold >= (1 << 24)))) {
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
  c.q_seg = static_cast<const int*>(q_seg);
  c.k_seg = static_cast<const int*>(k_seg);
  c.range = static_cast<const int2*>(range);
  c.k_span = static_cast<const int2*>(k_span);
  c.win_left = win_left;
  c.win_right = win_right;
  c.chunk = chunk;
  c.cap = softcap;
  c.dropout_seed = static_cast<const int*>(seed);
  c.dropout_min = static_cast<uint32_t>(keep_threshold) << 8;
  c.dropout_scale = keep_scale;
  const bool diag = causal != 0;
  if (head_dim == 64) {
    err = run_segment_channels<64>(q, k, v, out, p, c, diag, window, scale, s);
  } else if (head_dim == 128) {
    err = run_segment_channels<128>(q, k, v, out, p, c, diag, window, scale, s);
  } else if (head_dim == 256) {
    err = run_segment_channels_d256(q, k, v, out, p, c, diag, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
