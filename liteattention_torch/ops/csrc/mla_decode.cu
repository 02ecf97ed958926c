// B10: absorbed MLA (multi-head latent attention) decode on Hopper
// (mla_decode_kernel), replacing the Pallas kernel
// liteattention_tpu/ops/mla.py:_mla_kernel.
//
// What it computes. Every q row attends one latent cache: K is the whole row
// of D = 576 channels and V its first DV = 512 channels, shared by all heads.
// The wrapper lays the q rows of a request out as [B, R, D] with R = Sq * Hq
// ordered r = qi * Hq + h; row r sees key col iff col < len, and with causal
// and Sq > 1 iff col < len - Sq + qi + 1 (bottom-right aligned). Scores live
// in log2 space (s * scale * log2e); the lse written out is natural log. A
// row with no valid key gives out 0 and lse -inf, never NaN.
//
// What bounds it on the H100: at Hq 128 each cache byte feeds ~242 FLOP of
// needed work (128 rows x 2 x (576 + 512) per 1152 bytes), just under the
// card's ~295 FLOP per byte: bytes bind, and the tensor cores need ~82 % of
// that time. So the kernel must stream HBM and keep the tensor cores busy at
// once, with S computed once and every cache byte read from HBM once. The
// design follows the layout DeepSeek published for this shape (FlashMLA),
// written from sm90.cuh:
//
// * One CTA per 64 q rows (a row block) of a chunk of the keys, 256 threads
//   in two warpgroups: mla_step.cuh's split-O tile step. Warpgroup 0
//   computes S = Q K^T once (wgmma m64n64k16, Q and K in shared memory, 36
//   steps over the 576 channels), masks it, runs the online softmax
//   (attention_fwd.cuh's row steps, the scale folded into each exp2) and
//   O[:, 0:256] += P V[:, 0:256] with P from registers. It also writes P
//   (bf16, 8 KB, 128-byte swizzle) and each row's rescale factor to shared
//   memory, from where warpgroup 1 runs O[:, 256:512] += P V[:, 256:512]
//   with both operands in shared memory, under warpgroup 0's next S. Each
//   accumulator is 64 x 256 fp32, 128 registers a thread. Two named
//   barriers hand P over (full, empty); the loop has no CTA barrier.
// * One load per tile: a 64-key x 576 tile (72 KB) feeds QK^T, and its first
//   512 channels feed P V from the same 128-byte-swizzled atoms, read
//   MN-major. Shared memory: Q 72 KB + 2 ring stages of 72 KB + P 8 KB =
//   224.5 KB of the 227 KB a CTA may use. A third stage does not fit, so the
//   ring has two: tile i + 2 loads while tile i + 1 is computed. Each stage
//   has a full barrier (expect-tx bytes) and an empty barrier that all eight
//   warps arrive on once their products that read it have retired.
// * TMA over the cache as it lies: one 3-D tensor map (channel, slot, page
//   or request) with the cache's own strides, so the 576-lane and 640-lane
//   caches share one load and the extra lanes are never read. Warp 4
//   (warpgroup 1's first, which waits least) feeds the ring: a tile is
//   loaded as boxes of gcd(page size, 64) rows that never cross a page, one
//   lane per box looking its page up, one box per 64-channel atom (a
//   contiguous cache or pages of a multiple of 64 keys: one box per atom).
//   Pages of a size that is not a multiple of 8 keys (a 128-byte-swizzled
//   box needs 8 rows) are copied row by row with 16-byte bulk copies into the
//   swizzled places: slow, but every page size runs on the kernel. Rows past
//   a request's length are set to 0 in V before P V reads them (P is 0
//   there, but 0 x NaN is not).
// * Splits balanced over the keys present, on the device, with no host
//   sync: every CTA derives each request's tile count from the lengths (a
//   scan over the CTA's threads) and takes chunk c of C equal chunks of the
//   flat sequence of all requests' tiles; C is the grid's width (the SMs
//   over the row blocks), fewer where a chunk would hold under min_tiles
//   tiles. The CTAs of one chunk's row blocks walk the same keys side by
//   side, so the second read of a tile comes from L2. A chunk may span
//   requests and a request chunks; the ring runs across requests, and the
//   next request's Q loads under the last tile of the one before.
// * The merge folded in: a request whose tiles all lie in one chunk writes
//   out and lse. Otherwise each piece writes (o fp32, lse) to its slot (two
//   per CTA: the piece continuing a request from the chunk before, and the
//   piece of a request that starts here) and thread 0 adds its tile count to
//   the request's ticket (a release atomic after a CTA barrier), read after
//   the walk. The piece that completes the count merges every piece of the
//   request into out and lse (ops/combine.py is its plain version) and puts
//   the ticket back to 0 for the next launch. A piece with no valid key for
//   a row carries weight 0 there; a row with none in any piece gets out 0
//   and lse -inf. A request with no key at all is written by CTA (b % grid).
#include <numeric>

#include "attention_fwd.cuh"
#include "mla_step.cuh"
#include "sm90.cuh"

namespace mla {

using lite::finish_rows;
using lite::mask_scores;
using lite::rescale_rows;
using lite::softmax_rows;
using lite::store_rows;
using lite::sm90::desc_sw128;

using lite::mla_step::kAtom;
using lite::mla_step::kHalf;
using lite::mla_step::kKeys;
using lite::mla_step::kPEmpty;
using lite::mla_step::kPFull;
using lite::mla_step::kRows;
using lite::mla_step::kThreads;
using lite::mla_step::kWarps;
using lite::mla_step::kWgBar;

constexpr int kD = 576;
constexpr int kDV = 512;
constexpr int kAtoms = kD / 64;  // 64-channel atoms of a row
constexpr int kFeeder = 4;       // the warp that feeds the ring
constexpr int kPieceBar = 5;     // named barrier: a piece's writes done
static_assert(kAtoms == lite::mla_step::kSAtoms && kDV == 2 * kHalf, "the split-O step's widths");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory (byte offsets from a 1024-byte aligned base). Q and each
// ring stage hold 64 rows of 576 channels as 9 atoms of 64 rows x 128 bytes
// in TMA's 128-byte swizzle; P is one such atom (64 rows x 64 keys).
struct Smem {
  static constexpr int kTile = kAtoms * kAtom;  // 72 KB
  static constexpr int q = 0;
  static constexpr int ring = q + kTile;    // [2] stages
  static constexpr int p = ring + 2 * kTile;
  static constexpr int rowv = p + kAtom;    // float[kRows]: rescale factors, then 1 / l
  static constexpr int bars = rowv + kRows * 4;  // full[2], empty[2], q_full
  static constexpr int misc = bars + 5 * 8;      // int[16]: scan sums, seek, merges
  static constexpr int feed = misc + 16 * 4;     // Feed
  static constexpr int bytes = feed + 288;
};
static_assert(Smem::bytes + 1024 <= 232448, "shared memory of one CTA");

struct Params {
  const __nv_bfloat16* kv;  // latent cache base (the row-by-row copies)
  const int* table;         // [B, table_stride] page table, or null
  const int* lens;          // [B] valid keys
  __nv_bfloat16* out;       // [B, R, DV]
  float* lse;               // [B, R]
  float* o_part;            // [row blocks * grid * 2][kRows][DV] pieces of split requests
  float* lse_part;          // [row blocks * grid * 2][kRows]
  int* tickets;             // [row blocks * B] tiles done per request; 0 between launches
  long long s_page, s_slot;  // element strides: page (or request), slot
  int batch, rows, hq, sq, capacity, table_stride, page_size;
  int box;  // rows per load box: gcd(page_size, 64), 64 for a contiguous cache
  int causal, min_tiles;
  float scale_log2;
};

__device__ __forceinline__ int req_len(const Params& p, int b) {
  return min(max(__ldg(p.lens + b), 0), p.capacity);
}

__device__ __forceinline__ int req_tiles(const Params& p, int b) {
  return (req_len(p, b) + kKeys - 1) / kKeys;
}

// Position in the flat sequence of all requests' tiles: request b, whose
// n tiles start at flat tile st; the flat tile x.
struct Cursor {
  int b, st, n, x;

  // The next flat tile (there must be one).
  __device__ __forceinline__ void next(const Params& p) {
    if (++x < st + n) return;
    st += n;
    do {
      n = req_tiles(p, ++b);
    } while (n == 0);
  }
};

// The next request with a key after request b (there must be one).
__device__ __forceinline__ int next_request(const Params& p, int b) {
  do {
    ++b;
  } while (req_tiles(p, b) == 0);
  return b;
}

// Warp kFeeder's state, in shared memory (in registers it would be held by
// every thread across the loop, where warpgroup 0's O, S and P leave none
// spare): the next tile to load (at, flat tile `fed`), its request's length
// and first key, and where each lane's box starts (page, slot). The pages
// are looked up right after the tile before is issued, so that no table read
// sits between a freed stage and its loads.
struct Feed {
  Cursor at;
  int fed, len, t0;
  int page[32], slot[32];
};

static_assert(sizeof(Feed) <= Smem::bytes - Smem::feed, "the feeder's state");

// Look the tile at f.at up (every lane of the feeder).
__device__ __forceinline__ void feed_locate(const Params& p, Feed& f, int lane) {
  const Cursor at = f.at;
  const int len = req_len(p, at.b);
  const int t0 = (at.x - at.st) * kKeys;
  int page = at.b, slot = t0 + lane * p.box;
  if (p.table != nullptr && p.box >= 8 && lane < kKeys / p.box && slot < len) {
    const int* trow = p.table + static_cast<size_t>(at.b) * p.table_stride;
    page = __ldg(trow + slot / p.page_size);
    slot %= p.page_size;
  }
  f.page[lane] = page;
  f.slot[lane] = slot;
  if (lane == 0) {
    f.len = len;
    f.t0 = t0;
  }
  __syncwarp();
}

// Warp kFeeder: the tile at `f` into the ring stage at dst. Boxes of p.box
// rows, one lane each, skipping those wholly past the request's length;
// under 8 rows a box, row by row with 16-byte bulk copies.
__device__ __forceinline__ void load_tile(const Params& p, const CUtensorMap* tm,
                                          unsigned char* dst, uint64_t* bar, const Feed& f,
                                          int lane) {
  if (p.box >= 8) {
    const bool want = lane < kKeys / p.box && f.t0 + lane * p.box < f.len;
    const int slot = f.slot[lane];
    const int page = f.page[lane];
    const int issued = __popc(__ballot_sync(0xffffffffu, want));
    if (lane == 0) lite::sm90::mbar_expect_tx(bar, issued * p.box * 128 * kAtoms);
    __syncwarp();
    if (want) {
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        lite::sm90::tma_load_3d(dst + a * kAtom + lane * p.box * 128, tm, bar, 64 * a, slot, page);
      }
    }
    return;
  }
  const int rows = min(kKeys, f.len - f.t0);
  if (lane == 0) lite::sm90::mbar_expect_tx(bar, rows * kD * 2);
  __syncwarp();
  const int* trow = p.table + static_cast<size_t>(f.at.b) * p.table_stride;
  for (int r = lane; r < rows; r += 32) {
    const int pos = f.t0 + r;
    const int page = __ldg(trow + pos / p.page_size);
    const __nv_bfloat16* src = p.kv + page * p.s_page + (pos % p.page_size) * p.s_slot;
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        lite::sm90::bulk_load(dst + a * kAtom + r * 128 + ((ch ^ (r & 7)) << 4),
                              src + 64 * a + 8 * ch, 16, bar);
      }
    }
  }
}

// Warp kFeeder: the tile at `f` into dst, then the next one of the chunk
// (flat tiles below x1) looked up.
__device__ __forceinline__ void feed_tile(const Params& p, const CUtensorMap* tm,
                                          unsigned char* dst, uint64_t* bar, Feed& f, int x1,
                                          int lane) {
  load_tile(p, tm, dst, bar, f, lane);
  Cursor at = f.at;
  const int fed = f.fed + 1;
  __syncwarp();
  if (lane == 0) f.fed = fed;
  if (fed < x1) {
    at.next(p);
    if (lane == 0) f.at = at;
    __syncwarp();
    feed_locate(p, f, lane);
  }
  __syncwarp();
}

// Q of request b's row block (rows past R read zeros) into the Q buffer.
__device__ __forceinline__ void load_q(const CUtensorMap* tm, unsigned char* dst, uint64_t* bar,
                                       int row0, int b) {
  lite::sm90::mbar_expect_tx(bar, kAtoms * kAtom);
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
    lite::sm90::tma_load_3d(dst + a * kAtom, tm, bar, 64 * a, row0, b);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_kv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  uint64_t* empty = full + 2;
  uint64_t* q_full = empty + 2;
  float* rowv = reinterpret_cast<float*>(smem + Smem::rowv);
  int* misc = reinterpret_cast<int*>(smem + Smem::misc);
  unsigned char* ring = smem + Smem::ring;

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int c = blockIdx.x;
  const int rb = blockIdx.y;
  const int row0 = rb * kRows;
  const int nrows = min(kRows, p.rows - row0);

  // Every request's tiles summed over the CTA (each thread a run of
  // requests); the thread whose run holds the chunk's first tile finds its
  // request.
  const int per = (p.batch + kThreads - 1) / kThreads;
  const int i0 = min(p.batch, tid * per);
  const int i1 = min(p.batch, i0 + per);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += req_tiles(p, i);
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) misc[warp] = incl;
  if (tid == 0) {
    lite::sm90::prefetch_tensormap(&tm_q);
    lite::sm90::prefetch_tensormap(&tm_kv);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      lite::sm90::mbar_init(&full[s], 1);
      lite::sm90::mbar_init(&empty[s], kWarps);
    }
    lite::sm90::mbar_init(q_full, 1);
    lite::sm90::mbar_fence_init();
  }
  __syncthreads();
  int total = 0, excl = incl - local;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total += misc[w];
    if (w < warp) excl += misc[w];
  }
  const int chunks = min(static_cast<int>(gridDim.x), max(1, total / p.min_tiles));
  const int x0 = c < chunks ? static_cast<int>(static_cast<long long>(c) * total / chunks) : 0;
  const int x1 = c < chunks ? static_cast<int>(static_cast<long long>(c + 1) * total / chunks) : 0;
  if (x0 < x1 && excl <= x0 && x0 < excl + local) {
    int st = excl;
    for (int i = i0; i < i1; ++i) {
      const int n = req_tiles(p, i);
      if (x0 < st + n) {
        misc[8] = i;
        misc[9] = st;
        break;
      }
      st += n;
    }
  }
  // The requests with no key: out 0, lse -inf.
  for (int b = c; b < p.batch; b += gridDim.x) {
    if (req_len(p, b) > 0) continue;
    for (int e = tid; e < nrows * kDV; e += kThreads) {
      const size_t row = static_cast<size_t>(b) * p.rows + row0 + e / kDV;
      p.out[row * kDV + e % kDV] = __float2bfloat16_rn(0.f);
      if (e % kDV == 0) p.lse[row] = -INFINITY;
    }
  }
  __syncthreads();
  if (x0 >= x1) return;
  const Cursor start{misc[8], misc[9], req_tiles(p, misc[8]), x0};
  if (tid == 0) {  // for the merges (the warps' sums are read)
    misc[0] = total;
    misc[1] = chunks;
  }

  // The first request's Q, and the first two tiles into the ring.
  if (tid == 0) load_q(&tm_q, smem + Smem::q, q_full, row0, start.b);
  Feed& feed = *reinterpret_cast<Feed*>(smem + Smem::feed);
  if (warp == kFeeder) {
    if (lane == 0) {
      feed.at = start;
      feed.fed = x0;
    }
    __syncwarp();
    feed_locate(p, feed, lane);
    for (int s = 0; s < 2 && feed.fed < x1; ++s) {
      feed_tile(p, &tm_kv, ring + s * Smem::kTile, &full[s], feed, x1, lane);
    }
  }

  const int wg = warp / 4;
  const int tw = tid % 128;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r_lo = 16 * (warp % 4) + g;  // this thread's rows of the block: r_lo, r_lo + 8
  const int r_hi = r_lo + 8;
  const uint32_t ring_a = lite::sm90::smem_u32(ring);
  const uint64_t q_desc = desc_sw128(lite::sm90::smem_u32(smem + Smem::q), 16, 1024);
  const uint32_t p_addr = lite::sm90::smem_u32(smem + Smem::p);
  // O (this warpgroup's 256 channels) in the accumulator layout (sm90.cuh).
  float o[kHalf / 8][4];
  float(&od)[kHalf / 2] = reinterpret_cast<float(&)[kHalf / 2]>(o);
  // This CTA's pieces of split requests (at most two: its first request
  // and its last); thread 0 keeps their tickets after its additions.
  int pieces = 0, done0 = 0, done1 = 0;

  if (wg == 1) lite::sm90::named_arrive(kPEmpty, kThreads);  // P's buffer starts free
  Cursor cur = start;
  int i = 0;  // the CTA's step: flat tile x0 + i, ring stage i % 2
  int q_phase = 0;
  while (true) {  // one piece per turn: this chunk's tiles of request cur.b
    const int b = cur.b;
    const int len = req_len(p, b);
    const int j0 = cur.x - cur.st;
    const int n = min(x1, cur.st + cur.n) - cur.x;
    const bool whole = j0 == 0 && cur.x + n == cur.st + cur.n;
    const int b_next = cur.x + n < x1 ? next_request(p, b) : -1;
    auto limit = [&](int r) {
      return p.causal && p.sq > 1 ? len - p.sq + min((row0 + r) / p.hq, p.sq - 1) + 1 : len;
    };
    const int lim_lo = limit(r_lo);
    const int lim_hi = limit(r_hi);
#pragma unroll
    for (int k = 0; k < kHalf / 2; ++k) od[k] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running row max (log2 space)
    float l_lo = 0.f, l_hi = 0.f;              // per-thread partial row sums
    if (wg == 0) {  // this request's Q (loaded during the last one's last tile)
      lite::sm90::mbar_wait(q_full, q_phase);
      q_phase ^= 1;
    }
    for (int jj = 0; jj < n; ++jj, ++i) {
      const int stage = i & 1;
      unsigned char* tile = ring + stage * Smem::kTile;
      const uint32_t tile_a = ring_a + stage * Smem::kTile;
      const int t0 = (j0 + jj) * kKeys;
      lite::sm90::mbar_wait(&full[stage], (i >> 1) & 1);
      if (t0 + kKeys > len) {
        // Keys past the length: this warpgroup's V channels of those rows
        // become 0 (they may be stale, unloaded or garbage in the cache).
        const int z0 = len - t0;
        for (int e = tw; e < (kKeys - z0) * 32; e += 128) {
          const int r = z0 + e / 32;
          const int a = 4 * wg + (e / 8) % 4;
          *reinterpret_cast<uint4*>(tile + a * kAtom + r * 128 + (e % 8) * 16) =
              make_uint4(0, 0, 0, 0);
        }
        lite::sm90::fence_proxy_async();
        lite::sm90::named_sync(kWgBar + wg, 128);
      }
      if (wg == 0) {
        // S = Q K^T over the 576 channels, masked; the online softmax; P to
        // warpgroup 1; O[:, 0:256] += P V[:, 0:256].
        float s[kKeys / 8][4];
        float(&sd)[kKeys / 2] = reinterpret_cast<float(&)[kKeys / 2]>(s);
        lite::mla_step::score(sd, q_desc, tile_a);
        if (jj == n - 1 && b_next >= 0) {
          // Every warp's last S has read Q: the next request's Q loads under
          // this tile's softmax, P V and the piece's end.
          lite::sm90::named_sync(kWgBar, 128);
          if (tw == 0) load_q(&tm_q, smem + Smem::q, q_full, row0, b_next);
        }
        float mx_lo, mx_hi, alpha_lo, alpha_hi;
        mask_scores(
            s, 1.f, t0 + kKeys > min(lim_lo, lim_hi), t0,
            [&](int col, bool hi) { return col >= (hi ? lim_hi : lim_lo); }, mx_lo, mx_hi);
        softmax_rows(s, mx_lo, mx_hi, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, p.scale_log2);
        rescale_rows(o, alpha_lo, alpha_hi);
        uint32_t pf[kKeys / 16][4];
#pragma unroll
        for (int k = 0; k < kKeys / 16; ++k) lite::sm90::frag_a(pf[k], sd, k);
        lite::mla_step::hand_p(smem + Smem::p, rowv, pf, alpha_lo, alpha_hi, r_lo, r_hi);
        lite::mla_step::pv_regs(od, pf, tile_a);
      } else {
        // O[:, 256:512] rescaled, then += P V[:, 256:512] (P from shared memory).
        lite::mla_step::pv_smem(o, rowv, r_lo, r_hi, p_addr, tile_a + 4 * kAtom);
      }
      if (lane == 0) lite::sm90::mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (warp == kFeeder && feed.fed < x1) {
        // Refill the stage (every warp released it) with tile i + 2.
        lite::sm90::mbar_wait(&empty[stage], (i >> 1) & 1);
        feed_tile(p, &tm_kv, tile, &full[stage], feed, x1, lane);
      }
    }

    // The piece's end: 1 / l and lse from warpgroup 0 (to warpgroup 1
    // through rowv), then out and lse, or the piece and the ticket.
    const int slot = (rb * static_cast<int>(gridDim.x) + c) * 2 + (j0 > 0 ? 0 : 1);
    const bool lo_ok = r_lo < nrows;
    const bool hi_ok = r_hi < nrows;
    float inv_lo, inv_hi;
    if (wg == 0) {
      float lse_lo, lse_hi;
      finish_rows(m_lo, m_hi, l_lo, l_hi, inv_lo, inv_hi, lse_lo, lse_hi);
      lite::sm90::named_sync(kPEmpty, kThreads);
      if (t == 0) {
        rowv[r_lo] = inv_lo;
        rowv[r_hi] = inv_hi;
        float* lse = whole ? p.lse + static_cast<size_t>(b) * p.rows + row0
                           : p.lse_part + static_cast<size_t>(slot) * kRows;
        if (lo_ok) lse[r_lo] = lse_lo;
        if (hi_ok) lse[r_hi] = lse_hi;
      }
      lite::sm90::named_arrive(kPFull, kThreads);
    } else {
      lite::sm90::named_sync(kPFull, kThreads);
      inv_lo = rowv[r_lo];
      inv_hi = rowv[r_hi];
      lite::sm90::named_arrive(kPEmpty, kThreads);
    }
    const int col0 = wg * kHalf;
    if (whole) {
      __nv_bfloat16* ob = p.out + (static_cast<size_t>(b) * p.rows + row0) * kDV + col0;
      store_rows(ob + r_lo * kDV, ob + r_hi * kDV, o, inv_lo, inv_hi, lo_ok, hi_ok);
    } else {
      float* ob = p.o_part + static_cast<size_t>(slot) * kRows * kDV + col0;
      store_rows(ob + r_lo * kDV, ob + r_hi * kDV, o, inv_lo, inv_hi, lo_ok, hi_ok);
      // Take the request's ticket: add this piece's tiles (release: the
      // barrier orders every thread's piece before thread 0's atomic). The
      // answer is read after the walk. A chunk holds at most two pieces.
      lite::sm90::named_sync(kPieceBar, kThreads);
      if (tid == 0) {
        misc[10 + pieces] = b;
        misc[12 + pieces] = cur.st;
        const int done = lite::sm90::atomic_add_release(p.tickets + rb * p.batch + b, n) + n;
        if (pieces == 0) {
          done0 = done;
        } else {
          done1 = done;
        }
      }
      ++pieces;
    }
    if (cur.x + n >= x1) break;
    cur.x += n - 1;  // the request's last tile: next() enters the next request
    cur.next(p);
  }

  // The pieces that completed their request merge all of its pieces into
  // out and lse, and put the ticket back to 0 for the next launch.
  if (pieces == 0) return;
  __syncthreads();  // the ring is free: it holds the pieces' weights, [piece][row]
  if (tid == 0) {
    __threadfence();  // acquire: the other pieces' writes before the reads below
    for (int k = 0; k < pieces; ++k) {
      const int b = misc[10 + k];
      const bool last = (k == 0 ? done0 : done1) == req_tiles(p, b);
      if (last) p.tickets[rb * p.batch + b] = 0;
      if (!last) misc[10 + k] = -1;
    }
  }
  __syncthreads();
  float* wts = reinterpret_cast<float*>(ring);
  const int total_m = misc[0];
  const int chunks_m = misc[1];
  for (int k = 0; k < pieces; ++k) {
    const int b = misc[10 + k];
    if (b < 0) continue;
    const int st = misc[12 + k];
    const int c0 = lite::chunk_of(st, total_m, chunks_m);
    const int np = lite::chunk_of(st + req_tiles(p, b) - 1, total_m, chunks_m) - c0 + 1;
    // Piece kk of the request: chunk c0 + kk; the first one started there.
    auto part = [&](int kk) {
      return static_cast<size_t>((rb * static_cast<int>(gridDim.x) + c0 + kk) * 2 + (kk == 0));
    };
    for (int e = tid; e < np * kRows; e += kThreads) {
      wts[e] = __ldcg(p.lse_part + part(e / kRows) * kRows + e % kRows);
    }
    __syncthreads();
    if (tid < nrows) {  // per row: the weights exp(lse - max) / sum and the lse
      float mx = -INFINITY;
      for (int kk = 0; kk < np; ++kk) mx = fmaxf(mx, wts[kk * kRows + tid]);
      float l = 0.f;
      if (mx != -INFINITY) {
        for (int kk = 0; kk < np; ++kk) l += expf(wts[kk * kRows + tid] - mx);
      }
      const bool none = !(l > 0.f);
      for (int kk = 0; kk < np; ++kk) {
        wts[kk * kRows + tid] = none ? 0.f : expf(wts[kk * kRows + tid] - mx) / l;
      }
      rowv[tid] = none ? -INFINITY : mx + logf(l);
    }
    __syncthreads();
    // out = the sum of w o over the pieces, four channels a thread a pass.
    for (int e = tid; e < nrows * (kDV / 4); e += kThreads) {
      const int r = e / (kDV / 4);
      const int d = (e % (kDV / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kk = 0; kk < np; ++kk) {
        const float w = wts[kk * kRows + r];
        if (w == 0.f) continue;
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(p.o_part + (part(kk) * kRows + r) * kDV + d));
        acc.x += w * v.x;
        acc.y += w * v.y;
        acc.z += w * v.z;
        acc.w += w * v.w;
      }
      const size_t row = static_cast<size_t>(b) * p.rows + row0 + r;
      uint2 packed;
      packed.x = lite::sm90::pack_bf16x2(acc.x, acc.y);
      packed.y = lite::sm90::pack_bf16x2(acc.z, acc.w);
      *reinterpret_cast<uint2*>(p.out + row * kDV + d) = packed;
      if (d == 0) p.lse[row] = rowv[r];
    }
    __syncthreads();  // the weights are read
  }
}

}  // namespace mla

// q [B, R, D] bf16 (R = Sq * Hq rows, r = qi * Hq + h); kv the latent cache
// base, [kv_pages][kv_slots][.] with element strides (s_page, s_slot) and a
// unit channel stride; table [B, table_stride] int32 or null (then kv_pages
// is B and kv_slots the capacity); lens [B] int32. out [B, R, DV] bf16, lse
// [B, R] fp32; o_part [row blocks * grid * 2, 64, DV] and lse_part [row
// blocks * grid * 2, 64] fp32 scratch; tickets [row blocks * B] int32, zero
// before the launch and after it. `grid` chunks of at least min_tiles 64-key
// tiles. Returns the CUDA error (0 = success).
extern "C" int lite_mla_decode(
    const void* q, const void* kv, const void* table, const void* lens, void* out,
    void* lse, void* o_part, void* lse_part, void* tickets, long long s_page,
    long long s_slot, int kv_pages, int kv_slots, int batch, int rows, int hq, int sq,
    int head_dim, int head_dim_v, int capacity, int table_stride, int page_size,
    int causal, int grid, int min_tiles, float scale, int device, void* stream) {
  if (head_dim != mla::kD || head_dim_v != mla::kDV || grid < 1 || batch < 1 ||
      rows < 1 || (table != nullptr && page_size < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla::Params p{};
  p.kv = static_cast<const __nv_bfloat16*>(kv);
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.tickets = static_cast<int*>(tickets);
  p.s_page = s_page;
  p.s_slot = s_slot;
  p.batch = batch;
  p.rows = rows;
  p.hq = hq;
  p.sq = sq;
  p.capacity = capacity;
  p.table_stride = table_stride;
  p.page_size = page_size;
  p.box = table != nullptr ? std::gcd(page_size, mla::kKeys) : mla::kKeys;
  p.causal = causal;
  p.min_tiles = max(min_tiles, 1);
  p.scale_log2 = scale * mla::kLog2e;
  CUtensorMap tm_q, tm_kv;
  const uint64_t dims[3] = {mla::kD, static_cast<uint64_t>(kv_slots),
                            static_cast<uint64_t>(kv_pages)};
  const uint64_t strides[2] = {static_cast<uint64_t>(s_slot) * 2,
                               static_cast<uint64_t>(s_page) * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(p.box), 1};
  if ((err = lite::sm90::make_tensor_map_3d(&tm_q, q, mla::kD, rows, batch, 64, mla::kRows)) ||
      (err = lite::sm90::make_tensor_map(&tm_kv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, kv, dims,
                                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B))) {
    return static_cast<int>(err);
  }
  constexpr int smem = mla::Smem::bytes + 1024;  // + alignment of the base
  err = cudaFuncSetAttribute(mla::mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(grid, (rows + mla::kRows - 1) / mla::kRows);
  mla::mla_decode_kernel<<<blocks, mla::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_kv, p);
  return static_cast<int>(cudaGetLastError());
}
