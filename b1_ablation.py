#!/usr/bin/env python3
"""Ablation of the dense forward B1's design on one NVIDIA GPU.

    python3 b1_ablation.py [VARIANT,...|all] [ROUNDS]

Each variant undoes one decision of ``liteattention_torch/ops/csrc/
flash_fwd.cu:flash_fwd_kernel`` in a copy of the sources, builds that copy
alone (``nvcc``, as ``liteattention_torch.ops._build`` does, with
``flash_fwd_hd.cu`` and ``mla_fwd.cu``, which the file's entries call, and
the committed ``flash_fwd_d256.cu``, the head-dim-256 instantiations that
the variants leave as they are) and loads its
``lite_flash_fwd_dense`` entry. All variants are timed in turns (order
reversed every other round) at B1's four shapes on the main paths -- the
Wan self- and cross-attention, causal GPT-2 small and the causal serving
prefill -- by CUDA events behind a busy wait (``chip_smoke.queued_ms``),
and every variant's output is held against the kernel as committed. Two
diagnostics give wrong outputs on purpose: ``no_softmax`` (P = S, no exp2)
and ``no_refill`` (the first kStages K/V tiles are reused, never reloaded)
bound what the softmax and the loads cost. Prints one JSON line (the card,
then per variant its ptxas registers, spills and advisories, its times in
ms per round and its max |out - final|). A variant whose edit no longer
matches the source fails loudly: keep the edits in step with the kernel.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "liteattention_torch" / "ops" / "csrc"
FWD = "flash_fwd.cu"

REFILL = "      refill(f);  // while the products run\n"
RELEASE = "      if (lane == 0) sm90::mbar_arrive(&vempty[stage]);  // this warp is done with stage j\n"
TURN_SYNC = "      sm90::named_sync(kTurn + wg, kThreads);\n"
TURN_ARRIVE = "      sm90::named_arrive(kTurn + 1 - wg, kThreads);\n"
TURN_FIRST = "    if (hl == 0 && wg == 1) sm90::named_arrive(kTurn, kThreads);\n"
FULL_WAIT = "      sm90::mbar_wait(&full[next], ((f + 1) / kStages) & 1);\n"
SOFTMAX = """      auto vote = [&](float mx_lo, float mx_hi) {
        if constexpr (COARSE) {
          coarse_vote(at, mx_lo, mx_hi);
        } else if constexpr (VOTES) {
          // Some valid row of this warp passes: the tile is kept.
          // Bitwise, not short-circuit: no branch on the way.
          const bool keep = ((r_lo < p.seqlen_q) & (mx_lo - mv_lo > p.thr)) |
                            ((r_hi < p.seqlen_q) & (mx_hi - mv_hi > p.thr));
          if (__any_sync(0xffffffffu, keep) && lane == 0) vrow[tile] = 0;
        }
      };
      tile_softmax<CAUSAL, DENSE, ALIBI, SEG, WINDOW, SOFTCAP>(
          s, p, range, seg, win, slope_log2, tile, walk.dead, warp_row0, r_lo, r_hi, m_lo, m_hi,
          l_lo, l_hi, alpha_lo, alpha_hi, vote);
"""
LOOP_HEAD = """    for (int j = 0; j + 1 < walk.n; ++j) {
      const int f = f0 + j;
      const int stage = f % kStages;
      const int next = (f + 1) % kStages;
"""
LOOP_BODY_AFTER_SOFTMAX = """      sm90::wgmma_wait<0>();
      sm90::fence_regs(od);
      sm90::fence_regs(pf);
      rescale_rows(o, alpha_lo, alpha_hi);
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) sm90::frag_a(pf[k], sd, k);
"""
K_RELEASE = (
    "      if (SPLIT && lane == 0) sm90::mbar_arrive(&empty[next]);  // this warp is done with K_{j+1}\n")
LAST_PV = """    if constexpr (SPLIT) sm90::mbar_wait(&vfull[(walk.n - 1) % 2], ((walk.n - 1) / 2) & 1);
    sm90::wgmma_fence();
    issue_pv<DV, kKeys>(od, pf, ring + (f0 + walk.n - 1) % kStages * L::kStage + L::kK);
    if constexpr (FOLD) refill(f0 + walk.n - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(od);
"""
LAUNCH = """  kernel<<<dim3(p.qtiles, p.heads / fold, batch), kThreads, smem, stream>>>(tm_q, tm_k, tm_v,
                                                                            tm_o, p, c);
  return cudaGetLastError();"""
STORE_END = """      sm90::bulk_wait_read();  // the Q buffer stays until the stores have read it
    }
    f_head += walk.n;
  }
}"""


def edit(text, old, new, count=1):
    if text.count(old) != count:
        raise SystemExit(f"b1_ablation: an edit no longer matches the source:\n{old}")
    return text.replace(old, new)


def wgmma_under_branch(s):
    """The first version's loop: one trip per tile, S_{j+1} and the rest of
    the step under `if (more)`, the last PV inside the loop."""
    s = edit(s, LOOP_HEAD, LOOP_HEAD.replace("j + 1 < walk.n", "j < walk.n")
             + "      const bool more = j + 1 < walk.n;\n")
    s = edit(s, FULL_WAIT, "      if (more) sm90::mbar_wait(&full[next], ((f + 1) / kStages) & 1);\n")
    s = edit(s, "      issue_s<DK, kKeys>(sd, q_desc, ring + next * L::kStage);\n",
             "      if (more) issue_s<DK, kKeys>(sd, q_desc, ring + next * L::kStage);\n")
    s = edit(s, "      sm90::wgmma_wait<1>();\n      sm90::fence_regs(sd);\n" + K_RELEASE + SOFTMAX,
             "      if (more) {\n        sm90::wgmma_wait<1>();\n        sm90::fence_regs(sd);\n"
             "  " + K_RELEASE + "  " + SOFTMAX.replace("\n      ", "\n        ").replace("\n  ", "\n    ")
             + "      }\n")
    s = edit(s, LOOP_BODY_AFTER_SOFTMAX, """      sm90::wgmma_wait<0>();
      sm90::fence_regs(od);
      sm90::fence_regs(pf);
      if (more) {
        rescale_rows(o, alpha_lo, alpha_hi);
#pragma unroll
        for (int k = 0; k < kKeys / 16; ++k) sm90::frag_a(pf[k], sd, k);
      }
""")
    return edit(s, LAST_PV, "")


def no_turns(s):
    s = edit(s, TURN_SYNC, "")
    s = edit(s, TURN_ARRIVE, "")
    return edit(s, TURN_FIRST, "")


def late_refill(s):
    """Thread 0 refills stage j with tile j + kStages at the end of its
    step j, once all eight warps have released it."""
    s = edit(s, REFILL, "")
    return edit(s, RELEASE, RELEASE + """      if (ct == 0 && f + kStages < n_dense) {
        sm90::mbar_wait(&empty[stage], (f / kStages) & 1);
        load_tile<DK, DV>(tm_k, tm_v, smem, full, stage, k0 + f + kStages, bhk0);
      }
""")


def scale_then_exp2(s):
    """Scores scaled by mask_scores (FMUL), then exp2(s - max) (FADD)."""
    s = edit(s, "  mask_scores(\n      s, 1.f, mask, col0,", "  mask_scores(\n      s, scale, mask, col0,")
    return edit(s, "alpha_lo, alpha_hi, scale);", "alpha_lo, alpha_hi);")


def producer_warp(s):
    """A ninth warp issues every load (288 threads: ptxas caps registers at
    224), the consumers never wait on an empty barrier."""
    s = edit(s, REFILL, "")
    s = edit(s, "__global__ void __launch_bounds__(kThreads, 1)\n    flash_fwd_kernel(",
             "__global__ void __launch_bounds__(kThreads + 32, 1)\n    flash_fwd_kernel(")
    s = edit(s, LAUNCH, LAUNCH.replace("kThreads, smem", "kThreads + 32, smem"))
    return edit(s, """  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(q_full, L::kQ);""", """  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == kWarps) {
    if (threadIdx.x == kThreads) {
      sm90::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int a = 0; a < DK / 64; ++a) {
        sm90::tma_load_3d(smem + L::q + a * kRowsQ * 128, &tm_q, q_full, 64 * a, q0,
                          b * p.heads + h0);
      }
      for (int j = 0; j < n_dense; ++j) {
        if (j >= kStages) sm90::mbar_wait(&empty[j % kStages], ((j - kStages) / kStages) & 1);
        load_tile<DK, DV>(tm_k, tm_v, smem, full, j % kStages, k0 + j, bhk0);
      }
    }
    return;
  }
  if (false) {
    sm90::mbar_expect_tx(q_full, L::kQ);""")


def multicast(s):
    """Non-causal CTAs run in clusters of two adjacent q-tiles: rank 0
    multicasts each K tile and rank 1 each V tile into both CTAs, which
    halves the K/V bytes read from L2; every warp releases a stage in both
    CTAs."""
    s = edit(s, "// K and V of k-tile `tile` into ring stage `stage` on one barrier (thread 0).\n"
             "template <int DK, int DV>\n",
             """__device__ __forceinline__ void tma_load_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "h"(uint16_t{3}),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void arrive_peer(uint64_t* bar, uint32_t cta) {
  asm volatile("{\\n.reg .b32 ra;\\nmapa.shared::cluster.u32 ra, %0, %1;\\n"
               "mbarrier.arrive.shared::cluster.b64 _, [ra];\\n}\\n" ::"r"(sm90::smem_u32(bar)),
               "r"(cta)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\\nbarrier.cluster.wait.acquire.aligned;\\n" ::
                   : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}

// K and V of k-tile `tile` into ring stage `stage` on one barrier (thread 0).
template <int DK, int DV, bool MC = false>
""")
    s = edit(s, """                                          int tile, int bhk) {
  sm90::mbar_expect_tx(full + stage, Smem<DK, DV>::kStage);
""", """                                          int tile, int bhk, uint32_t rank = 0) {
  sm90::mbar_expect_tx(full + stage, Smem<DK, DV>::kStage);
  if constexpr (MC) {
    using L = Smem<DK, DV>;
    constexpr int kKeys = Tiles<DK, DV>::kKeys;
    unsigned char* dst = smem + L::ring + stage * L::kStage + rank * L::kK;
#pragma unroll
    for (int a = 0; a < (rank == 0 ? DK : DV) / 64; ++a) {
      tma_load_mc(dst + a * kKeys * 128, rank == 0 ? &tm_k : &tm_v, full + stage, 64 * a,
                  tile * kKeys, bhk);
    }
    return;
  }
""")
    s = edit(s, "  using L = Smem<DK, DV>;\n  extern __shared__",
             "  using L = Smem<DK, DV>;\n  constexpr int kCluster = CAUSAL ? 1 : 2;\n"
             "  const uint32_t rank = kCluster == 1 ? 0 : cluster_rank();\n  extern __shared__")
    s = edit(s, "sm90::mbar_init(&empty[s], kWarps);", "sm90::mbar_init(&empty[s], kWarps * kCluster);")
    s = edit(s, "    sm90::mbar_fence_init();\n  }\n  __syncthreads();\n",
             "    sm90::mbar_fence_init();\n  }\n  if constexpr (kCluster > 1) {\n    cluster_sync();\n"
             "  } else {\n    __syncthreads();\n  }\n")
    s = edit(s, "load_tile<DK, DV>(tm_k, tm_v, smem, full, j, k0 + j, bhk0);",
             "load_tile<DK, DV, kCluster == 2>(tm_k, tm_v, smem, full, j, k0 + j, bhk0, rank);")
    s = edit(s, "load_tile<DK, DV>(tm_k, tm_v, smem, full, free, k0 + f - 1 + kStages, bhk0);",
             "load_tile<DK, DV, kCluster == 2>(tm_k, tm_v, smem, full, free, k0 + f - 1 + kStages, "
             "bhk0, rank);")
    s = edit(s, RELEASE, "      if (lane == 0) {\n        sm90::mbar_arrive(&vempty[stage]);\n"
             "        if constexpr (kCluster > 1) arrive_peer(&vempty[stage], rank ^ 1);\n      }\n")
    s = edit(s, STORE_END, STORE_END[:-2] + "\n  if constexpr (kCluster > 1) cluster_sync();\n}")
    # The host launch takes the kernel, not its CAUSAL flag: run() hands it
    # the cluster size the kernel was built for.
    s = edit(s, "template <int DK, int DV, bool FOLD, typename Kernel>\ncudaError_t launch(",
             "template <int DK, int DV, bool FOLD, int CLUSTER = 1, typename Kernel>\n"
             "cudaError_t launch(")
    s = edit(s, "  return launch<DK, DV, FOLD>(flash_fwd_kernel<",
             "  return launch<DK, DV, FOLD, CAUSAL ? 1 : 2>(flash_fwd_kernel<")
    return edit(s, LAUNCH, """  constexpr int kCluster = CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.qtiles + kCluster - 1) / kCluster * kCluster, p.heads / fold, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_q, tm_k, tm_v, tm_o, p, c);
  return err != cudaSuccess ? err : cudaGetLastError();""")


def no_softmax(s):
    return edit(s, SOFTMAX, "    alpha_lo = alpha_hi = 1.f;\n")


def no_refill(s):
    s = edit(s, REFILL, "")
    return edit(s, FULL_WAIT, "      if (f + 1 < kStages) sm90::mbar_wait(&full[next], 0);\n")


VARIANTS = {
    "final": None,
    "wgmma_under_branch": wgmma_under_branch,
    "no_turns": no_turns,
    "late_refill": late_refill,
    "scale_then_exp2": scale_then_exp2,
    "producer_warp": producer_warp,
    "multicast": multicast,
    "no_softmax": no_softmax,
    "no_refill": no_refill,
}
DIAGNOSTICS = ("no_softmax", "no_refill")
# name -> (batch, q heads, kv heads, Sq, Sk, D, causal, launches per timing)
SHAPES = {
    "wan_self 1x40x32760x128": (1, 40, 40, 32760, 32760, 128, False, 10),
    "wan_cross 1x40x32760 Sk 512": (1, 40, 40, 32760, 512, 128, False, 20),
    "gpt2 8x12x1024x64 causal": (8, 12, 12, 1024, 1024, 64, True, 50),
    "prefill 8x32/8x1024x128 causal": (8, 32, 8, 1024, 1024, 128, True, 50),
}


def build(names, work):
    """Each variant's sources into work/NAME, built alone in parallel; returns
    {name: (library, ptxas report)}."""
    sys.path.insert(0, str(ROOT))
    from liteattention_torch.ops import _build

    procs = {}
    for name in names:
        d = work / name
        shutil.copytree(CSRC, d)
        if VARIANTS[name] is not None:
            (d / FWD).write_text(VARIANTS[name]((d / FWD).read_text()))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d), "-o",
               str(d / "lib.so"), str(d / FWD), str(d / "flash_fwd_hd.cu"),
               str(d / "mla_fwd.cu"), str(CSRC / "flash_fwd_d256.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"b1_ablation: {name} did not build:\n{log[-4000:]}")
        report, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|in the function) '(\w+)'", line)
            kernel = m.group(1) if m else kernel
            # B1's dense instantiations (the list walks of B3 and B5 share the file).
            m = re.search(r"flash_fwd_kernelILi(\d+)ELi(\d+)ELb(\d)ELi0E", kernel or "")
            if not m:
                continue
            key = f"D{m.group(1)}/{m.group(2)} causal{m.group(3)}"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[key + " registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                report[key + " spill bytes"] = int(m.group(1))
            m = re.search(r"\((C\d+)\) Potential Performance Loss", line)
            if m:
                report.setdefault(key + " advisories", []).append(m.group(1))
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        lib.lite_flash_fwd_dense.argtypes = _build.SIGNATURES["lite_flash_fwd_dense"]
        lib.lite_flash_fwd_dense.restype = ctypes.c_int
        out[name] = (lib, report)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from liteattention_torch.ops import _build

    arg = sys.argv[1] if len(sys.argv) > 1 else "all"
    names = list(VARIANTS) if arg == "all" else ["final", *(n for n in arg.split(",") if n != "final")]
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    card = cs.nvidia_smi_line()
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        built = build(names, Path(tmp))
        dev = torch.device("cuda", 0)
        g = torch.Generator(device=dev).manual_seed(0)
        res = {n: {"ptxas": built[n][1], "ms": {}, "max_abs_diff": {}} for n in names}
        for shape, (b, hq, hk, sq, sk, d, causal, reps) in SHAPES.items():
            q = torch.randn(b, hq, sq, d, generator=g, device=dev).bfloat16()
            k, v = (torch.randn(b, hk, sk, d, generator=g, device=dev).bfloat16() for _ in range(2))
            calls, outs = {}, {}
            for name in names:
                out = torch.empty_like(q)
                lse = torch.empty(b, hq, sq, device=dev)
                lib = built[name][0]

                def call(lib=lib, out=out, lse=lse):
                    _build.check(lib.lite_flash_fwd_dense(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        b, hq, hk, sq, sk, d, d ** -0.5, int(causal), dev.index,
                        torch.cuda.current_stream(dev).cuda_stream), "b1_ablation")

                call()
                calls[name], outs[name] = call, out
            torch.cuda.synchronize()
            for name in names:
                res[name]["ms"][shape] = []
                if name not in DIAGNOSTICS:
                    diff = (outs[name].float() - outs["final"].float()).abs().max().item()
                    res[name]["max_abs_diff"][shape] = diff
            for r in range(rounds):
                for name in names if r % 2 == 0 else names[::-1]:
                    res[name]["ms"][shape].append(cs.queued_ms(calls[name], reps)[0])
            for name in names:
                print(f"  {shape:32s} {name:20s} "
                      + " ".join(f"{t:.4f}" for t in res[name]["ms"][shape]) + " ms", flush=True)
            del q, k, v, calls, outs
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
