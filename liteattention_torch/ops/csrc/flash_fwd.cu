// B1: dense flash-attention forward on Hopper (replaces the Pallas kernel
// liteattention_tpu/ops/flash_fwd.py:_fwd_kernel).
//
// bf16 q/k/v in [B, H, S, D] (D = 64 or 128), GQA by h / group, optionally
// causal (bottom-right aligned, offset Sk - Sq); ragged Sq and Sk are masked
// inside the kernel. Out in bf16, lse fp32 natural log. The mainloop is
// shared with the lite kernel (attention_fwd.cuh) under the dense schedule:
// every k-tile in order (up to the diagonal when causal).
#include "attention_fwd.cuh"

extern "C" int lite_flash_fwd_dense(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int batch, int heads, int kv_heads,
                                    int seqlen_q, int seqlen_k, int head_dim,
                                    float scale, int causal, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lite::FwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seqlen_q = seqlen_q;
  p.seqlen_k = seqlen_k;
  p.qtiles = (seqlen_q + lite::kBlockQ - 1) / lite::kBlockQ;
  p.ktiles = (seqlen_k + lite::kBlockK - 1) / lite::kBlockK;
  p.gsize = 1;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.thr = 0.f;
  p.causal_offset = seqlen_k - seqlen_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = causal ? lite::launch_attention_fwd<64, false, false, true>(p, batch, s)
                 : lite::launch_attention_fwd<64, false, false>(p, batch, s);
  } else if (head_dim == 128) {
    err = causal ? lite::launch_attention_fwd<128, false, false, true>(p, batch, s)
                 : lite::launch_attention_fwd<128, false, false>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
