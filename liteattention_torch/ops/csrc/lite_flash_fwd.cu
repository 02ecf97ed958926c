// B4, the coarse lite (sparse) attention forward with fused skip votes on
// Hopper (lite_flash_fwd_coarse), replacing the Pallas kernel
// liteattention_tpu/ops/lite_flash_fwd.py:_lite_kernel. A schedule at
// compute-tile granularity (block_q = 128 * qsub, block_k = 128 * ksub): one
// CTA per fine q-tile walks the coarse row that holds it, entry by entry,
// each entry one vote step over its ksub fine k-tiles; without bits (coarse
// mode) the coarse votes are AND-ed over the qsub CTAs by atomicAnd; with
// bits (super-tile mode) dead fine tiles are not visited and each live one
// votes on its own.
//
// The fine gather walk (B3, _lite_gather_kernel; with folded heads B5,
// _lite_gather_kernel_hfold) is B1's wgmma/TMA kernel walking a live-tile
// list: lite_flash_fwd_gather in flash_fwd.cu. See attention_fwd.cuh for the
// contract and what bounds B4 on the H100: still the first version's
// mma.sync loop, the next to move onto B1's mainloop (ROADMAP B-ii R1c).
#include "attention_fwd.cuh"

namespace {

template <int D>
cudaError_t launch_coarse(const lite::FwdParams& p, int batch, cudaStream_t s) {
  return p.bits ? lite::launch_attention_fwd<D, lite::kSuper>(p, batch, s)
                : lite::launch_attention_fwd<D, lite::kCoarse>(p, batch, s);
}

}  // namespace

extern "C" int lite_flash_fwd_coarse(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_idx, const void* count, const void* bits, void* votes,
    int batch, int heads, int kv_heads, int seqlen_q, int seqlen_k,
    int head_dim, int qsub, int ksub, float scale, float thr, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (qsub < 1 || ksub < 1 || ksub > 32) return static_cast<int>(cudaErrorInvalidValue);
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
  p.scale_log2 = scale * 1.4426950408889634f;
  p.thr = thr;
  p.fidx = static_cast<const int*>(kv_idx);
  p.count = static_cast<const int*>(count);
  p.bits = static_cast<const int*>(bits);
  p.votes = static_cast<int*>(votes);
  p.qsub = qsub;
  p.ksub = ksub;
  p.sched_q = (p.qtiles + qsub - 1) / qsub;
  p.sched_k = (p.ktiles + ksub - 1) / ksub;
  // Coarse votes per schedule tile; super-tile votes per fine tile.
  p.vote_q = bits ? p.sched_q * qsub : p.sched_q;
  p.vote_k = bits ? p.sched_k * ksub : p.sched_k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    err = launch_coarse<64>(p, batch, s);
  } else if (head_dim == 128) {
    err = launch_coarse<128>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
