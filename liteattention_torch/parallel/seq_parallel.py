"""Sequence-parallel LiteAttention over a ``torch.distributed`` group
(KV split).

Counterpart of ``liteattention_tpu/parallel/seq_parallel.py``. Each rank
of the group holds:

* q for every token (replicated);
* the K/V of its own contiguous shard of the keys, ``Sk / n`` of them;
* the skip mask's k-tiles of that shard, ``[B, H, Qt, cdiv(Sk / n, 128)]``,
  tiled from the shard's own first key (as ``shard_map`` hands each device
  its shard), so the mask evolves where its keys are and no rank reads
  another's.

A step is the engine's path on the shard: the packer B2
(:func:`~liteattention_torch.ops.schedule_pack.pack_schedule`) lists the
shard mask's live tiles, the lite kernel B3 walks them over the K/V shard
and votes, :func:`~liteattention_torch.ops.combine.combine_attention_psum`
merges the ranks' partial (out, lse) with an ``all_reduce(MAX)`` and an
``all_reduce(SUM)``, and ``update_mask`` folds the votes into the shard.
JAX compacts the mask with XLA's ``compact_mask_gather`` here; the port
uses the engine's packer.

Where JAX names a mesh axis, the port takes a
``torch.distributed.device_mesh.DeviceMesh`` and a dim name (the group is
``mesh.get_group(name)``, the rank its index); where JAX names an axis
inside ``shard_map``, the port takes the ``ProcessGroup``. Nothing here
creates a group or reads a global one, and nothing moves a tensor off its
device to communicate: the group's backend carries the collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from liteattention_torch.ops.combine import combine_attention_psum
from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
from liteattention_torch.ops.mask import SkipMaskState, cdiv, init_mask, update_mask
from liteattention_torch.ops.schedule_pack import pack_schedule
from liteattention_torch.ops.tile_sizes import VOTE_TILE, BlockSizes, get_block_sizes


def seq_parallel_spec(axis_name: str = "sp"):
    """Placements of (state, q, k / v, out) on the mesh dim ``axis_name``
    under KV-split sequence parallelism, as DTensor placements: the mask
    sharded on its k-tile dim, K/V on the sequence dim, q and out
    replicated (JAX's ``PartitionSpec`` s over the same axis)."""
    # Imported here: torch.distributed.tensor costs a second to import.
    from torch.distributed.tensor import Replicate, Shard

    del axis_name  # one mesh dim: the placements hold for the dim named
    return dict(
        state=SkipMaskState(do_mask=Shard(3), step=Replicate()),
        q=Replicate(),
        kv=Shard(2),
        out=Replicate(),
    )


def _local_step(state, q, k, v, threshold, group, block_sizes, emit_votes, schedule):
    """One rank's step: B2 on its mask shard, B3 over its K/V shard, the
    cross-rank merge, and the votes folded into the shard."""
    bs = block_sizes or get_block_sizes(q.shape[-1], q.element_size(), kind="lite")
    kt = cdiv(k.shape[2], VOTE_TILE)
    if state.do_mask.shape[3] != kt:
        raise ValueError(
            f"the mask shard holds {state.do_mask.shape[3]} k-tiles but this rank's "
            f"{k.shape[2]} keys make {kt}")
    fidx, count = schedule if schedule is not None else pack_schedule(state.do_mask)
    out_l, lse_l, votes = lite_flash_attention(
        q, k, v, fidx, count, threshold, state.do_mask, block_sizes=bs,
        emit_votes=emit_votes,
    )
    out, lse = combine_attention_psum(out_l, lse_l, group)
    new_state = update_mask(state, votes) if emit_votes else state
    return out, lse, new_state


def seq_parallel_attention_step(
    state: SkipMaskState,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    threshold,
    group: dist.ProcessGroup,
    block_sizes: Optional[BlockSizes] = None,
    emit_votes: bool = True,
    schedule: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """One KV-split sequence-parallel lite step, for a model whose ranks
    each computed their own K/V shard (``WanModel`` with ``sp_axis``).

    Args:
      state: this rank's mask shard ``[B, H, Qt, cdiv(Sk_shard, 128)]``.
      q: ``[B, H, Sq, D]``, every token (the same on every rank).
      k, v: ``[B, Hk, Sk_shard, D]``, this rank's contiguous key shard.
      threshold: log2-space vote threshold.
      group: the ranks that split the keys, in key order.
      emit_votes: False runs the no-vote kernel and carries the shard over
        unchanged (the vote-stride amortization).
      schedule: optional cached ``pack_schedule(state.do_mask)``; a caller
        reuses it between vote steps, when the mask cannot change.

    Returns ``(out, new_state)``: out ``[B, H, Sq, D]`` the same on every
    rank, the new mask shard. (In JAX q, K, V and the mask are global
    arrays and ``shard_map`` hands each device its shard.)
    """
    out, _, new_state = _local_step(state, q, k, v, threshold, group, block_sizes,
                                    emit_votes, schedule)
    return out, new_state


def make_seq_parallel_attention(
    mesh,
    axis_name: str = "sp",
    block_sizes: Optional[BlockSizes] = None,
):
    """Build ``(init_fn, step_fn)`` for LiteAttention split over the keys
    along the dim ``axis_name`` of ``mesh`` (a ``DeviceMesh``).

    ``init_fn(batch, heads, seqlen_q, seqlen_k, head_dim, dtype_bytes=2,
    device=None)`` returns this rank's mask shard, all tiles live, on
    ``device`` (default: the mesh's device type, the current card for
    ``cuda``). It raises ``ValueError`` unless ``seqlen_k`` splits into
    ``n`` shards of whole ``block_k`` tiles, so every rank's tile geometry
    is the same (JAX asserts it).

    ``step_fn(state, q, k, v, threshold)`` takes q, k, v ``[B, H(k), S,
    D]`` whole on every rank (as JAX's global arrays), runs this rank's
    key shard and returns ``(out, lse, new_state)``: out and lse the same
    on every rank, the new mask shard.
    """
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    kv_dim = seq_parallel_spec(axis_name)["kv"].dim

    def init_fn(
        batch: int,
        heads: int,
        seqlen_q: int,
        seqlen_k: int,
        head_dim: int,
        dtype_bytes: int = 2,
        device=None,
    ) -> SkipMaskState:
        bs = block_sizes or get_block_sizes(head_dim, dtype_bytes, kind="lite")
        if seqlen_k % (n * bs.block_k):
            raise ValueError(
                f"seqlen_k={seqlen_k} must divide evenly into {n} shards of "
                f"block_k={bs.block_k} tiles")
        if device is None:
            device = torch.device(mesh.device_type)
        return init_mask(batch, heads, seqlen_q, seqlen_k // n, VOTE_TILE, VOTE_TILE,
                         device=device)

    def step_fn(state: SkipMaskState, q, k, v, threshold):
        if k.shape[kv_dim] % n or v.shape[kv_dim] != k.shape[kv_dim]:
            raise ValueError(f"{k.shape[kv_dim]} keys do not split into {n} shards")
        shard = k.shape[kv_dim] // n
        lo = rank * shard
        k_sh = k.narrow(kv_dim, lo, shard)
        v_sh = v.narrow(kv_dim, lo, shard)
        return _local_step(state, q, k_sh, v_sh, threshold, group, block_sizes, True, None)

    return init_fn, step_fn


__all__ = [
    "make_seq_parallel_attention",
    "seq_parallel_attention_step",
    "seq_parallel_spec",
]
