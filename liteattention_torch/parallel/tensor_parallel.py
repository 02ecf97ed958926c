"""Tensor-parallel building blocks (Megatron-style) over a
``torch.distributed`` group.

Counterpart of ``liteattention_tpu/parallel/tensor_parallel.py``. Each
function works on this rank's local shards, as the JAX functions do
inside ``shard_map``, with JAX's ``psum`` / ``all_gather`` /
``psum_scatter`` as ``all_reduce`` / ``all_gather_into_tensor`` /
``reduce_scatter_tensor`` over ``group``:

* column-parallel: the weight split on its output features, the output
  feature-split (no collective);
* row-parallel: the weight split on its input features, the partial
  products summed (``all_reduce``), or reduce-scattered over the sequence
  dim (Megatron sequence parallelism).

Weights are ``nn.Linear``'s ``[out, in]`` (JAX's kernels are ``[in,
out]``); embedding tables ``[rows, dim]`` in both. The collectives run in
the tensors' own dtype, on their own device: the group's backend carries
them.

Every function is differentiable, with Megatron's conjugate collectives
(``parallel/_collectives.py``): a rank's gradient of its shard is its
slice of the whole model's gradient, and the gradient of a tensor every
rank holds alike (a bias added after a sum, a replicated input passed
through ``copy_to_group``) is the whole gradient on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from liteattention_torch.parallel._collectives import (
    all_gather_dim,
    all_reduce,
    copy_to_group,
    reduce_scatter_dim,
)


def column_parallel_dense(
    x: torch.Tensor,
    w_local: torch.Tensor,
    b_local: Optional[torch.Tensor] = None,
    gather_input_group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """``x @ w_local.T (+ b_local)``: the output's features split as
    ``w_local`` ``[out / n, in]``. With ``gather_input_group`` the input is
    first all-gathered over the sequence dim (it arrives sequence-split:
    Megatron sequence parallelism; its gradient is reduce-scattered back).
    Without it, ``x``'s gradient is this rank's part; where ``x`` is whole
    on every rank, pass it through ``copy_to_group`` first to sum it."""
    if gather_input_group is not None:
        x = all_gather_dim(x, x.dim() - 2, gather_input_group)
    return F.linear(x, w_local, b_local)


def row_parallel_dense(
    x_local: torch.Tensor,
    w_local: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    group: Optional[dist.ProcessGroup] = None,
    scatter_output: bool = False,
) -> torch.Tensor:
    """``sum over ranks (x_local @ w_local.T) (+ b)``, ``w_local`` ``[out,
    in / n]``; ``scatter_output`` reduce-scatters over the sequence dim
    instead (the output sequence-split; ``b``'s gradient, from each rank's
    sequence slice, is then summed over the group)."""
    if group is None:
        raise ValueError("row_parallel_dense needs the tensor-parallel group")
    partial = F.linear(x_local, w_local)
    if scatter_output:
        y = reduce_scatter_dim(partial, partial.dim() - 2, group)
        b = None if b is None else copy_to_group(b, group)
    else:
        y = all_reduce(partial, group)
    if b is not None:
        y = y + b
    return y


def _vocab_lookup(ids, emb_local, group):
    """This rank's rows of the vocab-split table, zero where an id is not
    among them."""
    v_loc = emb_local.shape[0]
    local = ids - dist.get_rank(group) * v_loc
    ok = (local >= 0) & (local < v_loc)
    emb = F.embedding(torch.where(ok, local, 0), emb_local)
    return torch.where(ok[..., None], emb, 0.0).to(emb_local.dtype)


def vocab_parallel_embedding(
    ids: torch.Tensor, emb_local: torch.Tensor, group: dist.ProcessGroup
) -> torch.Tensor:
    """Embedding lookup with the vocab split over ``group``: rank ``r``
    holds rows ``[r V / n, (r + 1) V / n)`` (``emb_local`` ``[V / n,
    D]``); each rank looks up its rows, zeroes the rest, and an
    ``all_reduce`` adds the one nonzero shard. The whole ``[.., D]`` on
    every rank."""
    return all_reduce(_vocab_lookup(ids, emb_local, group), group)


def column_parallel_embedding(ids: torch.Tensor, emb_local: torch.Tensor) -> torch.Tensor:
    """Embedding lookup with the embedding dim split (every vocab row, a
    slice of its features): no collective, the output feature-split."""
    return F.embedding(ids, emb_local)


def parallel_gpt2_embeddings(
    input_ids: torch.Tensor,
    word_emb_local: torch.Tensor,
    pos_emb_local: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    group: Optional[dist.ProcessGroup] = None,
    sequence_parallel: bool = False,
) -> torch.Tensor:
    """Word (vocab-split) plus position (feature-split) embeddings with one
    collective: each rank adds its position features into its own feature
    block of its partial word embedding before the sum, so the
    ``all_reduce`` (or, with ``sequence_parallel``, the reduce-scatter over
    the sequence, giving ``[B, S / n, D]``) both sums the vocab shards and
    puts the position features in place.

    ``input_ids`` int ``[B, S]``; ``word_emb_local`` ``[V / n, D]``;
    ``pos_emb_local`` ``[P, D / n]``; ``position_ids`` default ``arange(S)``.
    """
    if group is None:
        raise ValueError("parallel_gpt2_embeddings needs the tensor-parallel group")
    emb = _vocab_lookup(input_ids, word_emb_local, group)
    if pos_emb_local is not None:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        d_loc = pos_emb_local.shape[1]
        pe = F.embedding(position_ids, pos_emb_local).to(emb.dtype)
        lo = dist.get_rank(group) * d_loc
        emb = emb.clone()
        emb[..., lo:lo + d_loc] += pe.expand(*emb.shape[:-1], d_loc)
    if sequence_parallel:
        return reduce_scatter_dim(emb, emb.dim() - 2, group)
    return all_reduce(emb, group)


def vocab_parallel_logits(x: torch.Tensor, word_emb_local: torch.Tensor) -> torch.Tensor:
    """The tied LM head against the vocab-split table: this rank's logits
    ``[.., V / n]`` (no collective). ``x``'s gradient is this rank's part,
    as for :func:`column_parallel_dense`."""
    return x @ word_emb_local.T


def shard_rows(w: torch.Tensor, rank: int, tp: int, sections=None) -> torch.Tensor:
    """Rank ``rank``'s rows of ``w`` (dim 0) split in ``tp`` equal parts:
    the shard of a column-parallel weight ``[out, in]``, a bias, or a
    vocab-split table. ``sections`` (row counts of consecutive blocks,
    such as q | k | v or gate | up) splits each block and concatenates the
    rank's parts. ``ValueError`` where a block does not split evenly (a
    remainder would be dropped)."""
    sections = [w.shape[0]] if sections is None else list(sections)
    if sum(sections) != w.shape[0]:
        raise ValueError(f"sections {sections} do not cover the {w.shape[0]} rows")
    parts, off = [], 0
    for rows in sections:
        if rows % tp:
            raise ValueError(f"{rows} rows do not split evenly over {tp} ranks")
        loc = rows // tp
        parts.append(w[off + rank * loc: off + (rank + 1) * loc])
        off += rows
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def shard_cols(w: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s columns of ``w`` ``[rows, cols]`` split in ``tp``
    equal parts: the shard of a row-parallel weight ``[out, in]`` or of a
    feature-split table (``ValueError`` if the columns do not split)."""
    return shard_rows(w.T, rank, tp).T


__all__ = [
    "column_parallel_dense",
    "row_parallel_dense",
    "vocab_parallel_embedding",
    "column_parallel_embedding",
    "parallel_gpt2_embeddings",
    "vocab_parallel_logits",
    "shard_rows",
    "shard_cols",
]
