// The lite (sparse) attention forwards with fused skip votes on Hopper:
//
//   lite_flash_fwd_gather: B3, replacing the Pallas kernel
//     liteattention_tpu/ops/lite_flash_fwd.py:_lite_gather_kernel; with
//     fold > 1 heads per CTA it is B5, replacing _lite_gather_kernel_hfold
//     (bit-identical to B3: the per-head arithmetic is the same). One CTA
//     walks fidx[0..count) of its (b, h, q-tile) row: only live fine k-tiles
//     are loaded and computed, from the union-compacted K/V at lidx when the
//     caller passes it. With emit_votes, each visited tile's vote lands at
//     its fine index of the [B, H, Qt, Kt] vote array; without, the vote
//     chain is compiled out.
//   lite_flash_fwd_coarse: B4, replacing _lite_kernel. A schedule at
//     compute-tile granularity (block_q = 128 * qsub, block_k = 128 * ksub):
//     one CTA per fine q-tile walks the coarse row that holds it, entry by
//     entry, each entry one vote step over its ksub fine k-tiles; without
//     bits (coarse mode) the coarse votes are AND-ed over the qsub CTAs by
//     atomicAnd; with bits (super-tile mode) dead fine tiles are not visited
//     and each live one votes on its own.
//
// See attention_fwd.cuh for the contract and what bounds them.
#include "attention_fwd.cuh"

namespace {

void fill_common(lite::FwdParams& p, const void* q, const void* k,
                 const void* v, void* out, void* lse, int heads, int kv_heads,
                 int seqlen_q, int seqlen_k, float scale, float thr) {
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
  p.qsub = p.ksub = 1;
  p.gsize = 1;
  p.fold = 1;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.thr = thr;
}

template <int D, bool FOLD>
cudaError_t launch_gather(const lite::FwdParams& p, int batch, bool votes,
                          cudaStream_t s) {
  return votes ? lite::launch_attention_fwd<D, lite::kGather, true, FOLD>(p, batch, s)
               : lite::launch_attention_fwd<D, lite::kGather, false, FOLD>(p, batch, s);
}

template <int D>
cudaError_t launch_gather(const lite::FwdParams& p, int batch, bool votes,
                          cudaStream_t s) {
  return p.fold > 1 ? launch_gather<D, true>(p, batch, votes, s)
                    : launch_gather<D, false>(p, batch, votes, s);
}

template <int D>
cudaError_t launch_coarse(const lite::FwdParams& p, int batch, cudaStream_t s) {
  return p.bits ? lite::launch_attention_fwd<D, lite::kSuper, true>(p, batch, s)
                : lite::launch_attention_fwd<D, lite::kCoarse, true>(p, batch, s);
}

}  // namespace

extern "C" int lite_flash_fwd_gather(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* fidx, const void* count, const void* lidx, const void* mask,
    void* votes, int batch, int heads, int kv_heads, int seqlen_q,
    int seqlen_k, int head_dim, int gsize, int fold, float scale, float thr,
    int emit_votes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fold < 1 || heads % fold) return static_cast<int>(cudaErrorInvalidValue);
  lite::FwdParams p{};
  fill_common(p, q, k, v, out, lse, heads, kv_heads, seqlen_q, seqlen_k, scale, thr);
  p.fidx = static_cast<const int*>(fidx);
  p.count = static_cast<const int*>(count);
  p.lidx = static_cast<const int*>(lidx);
  p.mask = static_cast<const uint8_t*>(mask);
  p.votes = static_cast<int*>(votes);
  p.sched_q = p.vote_q = p.qtiles;
  p.sched_k = p.vote_k = p.ktiles;
  p.gsize = gsize;
  p.fold = fold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_votes = emit_votes != 0;
  if (head_dim == 64) {
    err = launch_gather<64>(p, batch, with_votes, s);
  } else if (head_dim == 128) {
    err = launch_gather<128>(p, batch, with_votes, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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
  fill_common(p, q, k, v, out, lse, heads, kv_heads, seqlen_q, seqlen_k, scale, thr);
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
