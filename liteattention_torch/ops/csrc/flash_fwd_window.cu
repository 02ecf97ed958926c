// B1's window, attention_chunk and softcap channels (flash_fwd.cu:
// flash_fwd_window_kernel, fwd_cta with WINDOW and / or SOFTCAP, the dense
// walk with the key range; the Pallas kernel's window, attention_chunk and
// softcap, liteattention_tpu/ops/flash_fwd.py:_fwd_kernel): its twelve
// instantiations at head dims 64 and 128 (causal or not; the window with or
// without the chunk, the cap, or both) and its entry, in a source of their
// own so that nvcc compiles them beside flash_fwd.cu's (one nvcc per source,
// all started together); head dim 256's six are flash_fwd_d256_window.cu's.
#define LITE_FWD_TEMPLATES_ONLY
#include "flash_fwd.cu"

// B1 with the window, attention_chunk and softcap channels: as
// lite_flash_fwd_masked without ALiBi (q [B, H, Sq, D], k and v [B, Hk, Sk,
// D], out [B, H, Sq, D], all bf16, D 64, 128 or 256; lse [B, H, Sq] fp32;
// kv_bound and kv_low [B] int32 or null; causal, bound_causal), plus the
// window's sides win_left and win_right (-1: unbounded; at most 2^29),
// chunk (0: none) and softcap (0: none). Row r sees keys [pos - win_left,
// pos + win_right] and [floor(pos / chunk) chunk, + chunk), pos = r +
// kv_bound[b] - Sq with kv_bound, else r + Sk - Sq; softcap caps the
// scores as softcap tanh(s scale / softcap). At least one of the three must
// be on. Returns the CUDA error of the launch (0 = success).
extern "C" int lite_flash_fwd_window(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const void* kv_bound, const void* kv_low,
                                     int batch, int heads, int kv_heads, int seqlen_q,
                                     int seqlen_k, int head_dim, float scale, int causal,
                                     int bound_causal, int win_left, int win_right, int chunk,
                                     float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool window = win_left >= 0 || win_right >= 0 || chunk > 0;
  if ((!window && !(softcap > 0.f)) || softcap < 0.f || chunk < 0 || win_left < -1 ||
      win_right < -1 || win_left > (1 << 29) || win_right > (1 << 29) || chunk > (1 << 29)) {
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
  c.win_left = win_left;
  c.win_right = win_right;
  c.chunk = chunk;
  c.cap = softcap;
  if (head_dim == 64) {
    err = run_window_channels<64>(q, k, v, out, p, c, diag, window, batch, scale, s);
  } else if (head_dim == 128) {
    err = run_window_channels<128>(q, k, v, out, p, c, diag, window, batch, scale, s);
  } else if (head_dim == 256) {
    err = run_window_d256(q, k, v, out, p, c, diag, window, batch, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
