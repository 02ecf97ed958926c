"""Multi-rank sequence-parallel LiteAttention demo.

The port of ``examples/seq_parallel_demo.py``. The keys (and the skip
mask's k-tiles) are split over the ranks of a ``DeviceMesh`` dim: each
rank runs the packer B2 and the lite kernel B3 on its shard, the partial
outputs merge by an ``all_reduce``, and every rank's mask shard evolves
where its keys are, as on one card.

Under ``torchrun`` on N cards (NCCL, one card a rank):

  torchrun --nproc-per-node N examples/torch_seq_parallel_demo.py

or on the CPU, spawning N gloo ranks itself:

  python examples/torch_seq_parallel_demo.py --device cpu --ranks 4

Options: ``--heads``, ``--head-dim``, ``--tiles`` (k-tiles a rank),
``--seed``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

from liteattention_torch.ops.tile_sizes import BlockSizes  # noqa: E402
from liteattention_torch.parallel import make_seq_parallel_attention  # noqa: E402

# Loose late thresholds so the demo's random-ish inputs skip visibly
# (real DiT activations skip at much tighter ones).
THRESHOLDS = [-10.0, -1.0, 0.2, 0.5]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", type=int, default=2, help="ranks to spawn with --device cpu")
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--tiles", type=int, default=2, help="128-key tiles a rank")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def demo(args, device):
    """Every rank: the same q, k, v from the seed, four steps; returns the
    whole masks' sparsity after each step (the same on every rank)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = DeviceMesh(device.type, list(range(n)), mesh_dim_names=("sp",))
    b, h, d = 1, args.heads, args.head_dim
    s = 128 * args.tiles * n
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    g = torch.Generator().manual_seed(args.seed)
    base = torch.randn(b, h, s, 1, generator=g)
    q = (base + 0.5 * torch.randn(b, h, s, d, generator=g)).to(device, dtype)
    k = (base + 0.5 * torch.randn(b, h, s, d, generator=g)).to(device, dtype)
    v = torch.randn(b, h, s, d, generator=g).to(device, dtype)
    if rank == 0:
        print(f"{n} ranks on {device.type}, {s} tokens ({s // 128} k-tiles, {args.tiles} a rank)")
    init_fn, step_fn = make_seq_parallel_attention(mesh, "sp", block_sizes=BlockSizes(128, 128))
    state = init_fn(b, h, s, s, d, q.element_size(), device=device)
    trace = []
    for t, thr in enumerate(THRESHOLDS):
        out, lse, state = step_fn(state, q, k, v, thr)
        live = state.do_mask.float().mean()
        dist.all_reduce(live, group=mesh.get_group("sp"))
        sparsity = 1.0 - live.item() / n
        trace.append(sparsity)
        if rank == 0:
            print(f"step {t}: thr={thr} sparsity={sparsity:.1%} out={tuple(out.shape)} "
                  f"finite={bool(torch.isfinite(out).all())}")
    return trace


def _spawned(rank, world, path, args, results):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=world)
    try:
        trace = demo(args, torch.device("cpu"))
        if rank == 0:
            results.extend(trace)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """Runs the demo; returns rank 0's sparsity per step (``--device cpu``)
    or this rank's (under torchrun)."""
    args = parse_args(argv)
    if args.device == "cpu":
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp, mp.get_context("spawn").Manager() as mgr:
            results = mgr.list()
            mp.start_processes(_spawned, args=(args.ranks, f"{tmp}/rendezvous", args, results),
                               nprocs=args.ranks, start_method="spawn")
            return list(results)
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")  # torchrun's environment names the group
    try:
        return demo(args, torch.device("cuda", local))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
