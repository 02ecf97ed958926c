// B1's segment channel (flash_fwd.cu:flash_fwd_kernel walking kSegment):
// its instantiations at head dims 64, 80, 96 and 128 and its entry, in a source
// of their own so that nvcc compiles them beside flash_fwd.cu's (one nvcc
// per source, all started together); head dim 256's are
// flash_fwd_d256_segments.cu's.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

// B1 with segment ids, batch 1: q [1, H, Sq, D], k and v [1, Hk, Sk, D],
// out [1, H, Sq, D], all bf16 (D 64, 80, 96, 128 or 256); lse [1, H, Sq] fp32;
// q_seg and k_seg int32, padded to whole 128-row tiles with their last id;
// range int2 [Sq tiles]: the keys [x, y) each 128-row q-tile walks (every
// key whose id one of its rows carries lies inside); k_span int2 [Sk
// tiles]: each 128-key tile's least and largest id. A key is seen by the
// rows of its id (and, causal, at or below the bottom-right diagonal at Sk
// - Sq). Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_segments(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const void* q_seg, const void* k_seg,
                                       const void* range, const void* k_span, int heads,
                                       int kv_heads, int seqlen_q, int seqlen_k, int head_dim,
                                       float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  const bool diag = causal != 0;
  if (head_dim == 64) {
    err = run_segments<64>(q, k, v, out, p, c, diag, scale, s);
  } else if (head_dim == 80) {
    err = run_segments<80>(q, k, v, out, p, c, diag, scale, s);
  } else if (head_dim == 96) {
    err = run_segments<96>(q, k, v, out, p, c, diag, scale, s);
  } else if (head_dim == 128) {
    err = run_segments<128>(q, k, v, out, p, c, diag, scale, s);
  } else if (head_dim == 256) {
    err = run_segments_d256(q, k, v, out, p, c, diag, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
