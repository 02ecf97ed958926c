// B7's segment channel (flash_bwd.cu:flash_bwd_segments_kernel, with the
// pre and post kernels of the one pass): its instantiations at head dims
// 64, 80, 96 and 128 and its entry, in a source of their own so that nvcc
// compiles them beside flash_bwd.cu's (one nvcc per source, all started
// together); head dim 256's are flash_bwd_d256_segments.cu's.
#define LITE_BWD_TEMPLATES_ONLY
#include "flash_bwd.cu"

namespace lite {
namespace bwd {

template <int D>
cudaError_t run_segments(const Args& a, const Channels& c, bool causal, cudaStream_t stream) {
  return causal ? run<D, true, false, false, true>(a, stream, c)
                : run<D, false, false, false, true>(a, stream, c);
}

}  // namespace bwd
}  // namespace lite

// B7 with segment ids, batch 1: as lite_flash_bwd (dq_accum, lse2 and
// delta scratch; D 64, 80, 96, 128 or 256), plus q_seg and k_seg int32,
// padded to whole 128-row tiles with their last id; range int2 [Sk / 128
// tiles]: the q rows [x, y) each 128-key tile walks (every row whose id one
// of its keys carries lies inside);
// q_span int2 [Sq rounded up to 64, / 64] and k_span int2 [Sk tiles]: each
// 64-row q block's and each 128-key tile's least and largest id. lse is
// the forward's (B1's with the same ids). Returns the CUDA error of the
// launches (0 = success).
extern "C" int lite_flash_bwd_segments(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* dq, void* dk,
                                       void* dv, void* dq_accum, void* lse2, void* delta,
                                       const void* q_seg, const void* k_seg, const void* range,
                                       const void* q_span, const void* k_span, int heads,
                                       int kv_heads, int seqlen_q, int seqlen_k, int head_dim,
                                       float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using namespace lite::bwd;
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, dq_accum, lse2, delta,
               1, heads, kv_heads, seqlen_q, seqlen_k, scale};
  lite::Channels c{};
  c.q_seg = static_cast<const int*>(q_seg);
  c.k_seg = static_cast<const int*>(k_seg);
  c.range = static_cast<const int2*>(range);
  c.q_span = static_cast<const int2*>(q_span);
  c.k_span = static_cast<const int2*>(k_span);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool diag = causal != 0;
  if (head_dim == 64) {
    err = run_segments<64>(a, c, diag, s);
  } else if (head_dim == 80) {
    err = run_segments<80>(a, c, diag, s);
  } else if (head_dim == 96) {
    err = run_segments<96>(a, c, diag, s);
  } else if (head_dim == 128) {
    err = run_segments<128>(a, c, diag, s);
  } else if (head_dim == 256) {
    err = run_segments_d256(diag, a, c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
