"""User-facing LiteAttention API.

Counterpart of ``liteattention_tpu/lite_attention.py``: a drop-in
attention module for video-diffusion DiT inference that carries a
persistent skip mask across denoising timesteps.

* Functional core (:func:`lite_attention_init` /
  :func:`lite_attention_step`): the mask is an explicit
  :class:`~liteattention_torch.ops.mask.SkipMaskState` threaded through
  the caller's denoising loop.
* Stateful wrapper (:class:`LiteAttention`): the reference class surface
  (``__call__``, ``set_threshold``, ``reset_skip_state``,
  ``enable_skip_optimization``, ``get_skip_percentage``).

The wrapper takes ``[B, S, H, D]`` tensors; the kernels run on
``[B, H, S, D]``. On CUDA tensors every attention call goes through the
port's kernels (dense B1, packer B2, lite B3); on CPU tensors through
their plain versions.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import torch

from liteattention_torch.ops.flash_fwd import flash_attention
from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention
from liteattention_torch.ops.mask import (
    SkipMaskState,
    cdiv,
    init_mask,
    must_do_mask,
    sparsity,
    update_mask,
)
from liteattention_torch.ops.schedule_pack import pack_schedule
from liteattention_torch.ops.tile_sizes import VOTE_TILE, BlockSizes, get_block_sizes


def effective_blocks(bs: BlockSizes, seqlen_q: int, seqlen_k: int):
    """Clamp compute tiles to the (128-padded) sequence lengths."""
    bq = min(bs.block_q, max(128, cdiv(seqlen_q, 128) * 128))
    bk = min(bs.block_k, max(128, cdiv(seqlen_k, 128) * 128))
    return bq, bk


def lite_attention_init(
    batch: int,
    heads: int,
    seqlen_q: int,
    seqlen_k: int,
    head_dim: int,
    dtype_bytes: int = 2,
    must_skip_ranges: Optional[Sequence[Tuple[int, int]]] = None,
    block_sizes: Optional[BlockSizes] = None,
    device=None,
) -> SkipMaskState:
    """Create the initial (all-do) skip-mask state at the fine 128 x 128
    granularity (independent of the compute tile), on ``device`` (default
    ``cuda``)."""
    del head_dim, dtype_bytes, block_sizes
    return init_mask(
        batch, heads, seqlen_q, seqlen_k, VOTE_TILE, VOTE_TILE,
        must_skip_ranges=must_skip_ranges, device=device,
    )


def lite_attention_step(
    state: SkipMaskState,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    threshold: Union[float, torch.Tensor],
    scale: Optional[float] = None,
    must_do: Optional[torch.Tensor] = None,
    enable_skipping: bool = True,
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
    emit_votes: bool = True,
    schedule: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """One denoising-step attention call with skip-mask evolution.

    Consumes the mask of step t-1, computes attention over its live
    tiles only, and returns the (monotonically shrunken) mask for step
    t+1. Newly skippable tiles are still computed this step.

    Args:
      state: from :func:`lite_attention_init` or a prior step.
      q, k, v: ``[B, H, S, D]``.
      threshold: log2-space skip threshold.
      must_do: optional bool mask broadcastable to ``[B, H, Qt, Kt]``
        protecting tiles from being newly skipped.
      enable_skipping: False runs the dense kernel and returns the state
        unchanged.
      emit_votes: False compiles the vote chain out and carries the mask
        over unchanged (the ``vote_stride`` amortization).
      schedule: optional cached ``pack_schedule(state.do_mask)``; callers
        reuse it between vote steps, when the mask cannot change.

    Returns:
      ``(out, new_state)`` or ``(out, lse, new_state)``.
    """
    bs = block_sizes or get_block_sizes(
        q.shape[-1], q.element_size(),
        kind="lite" if enable_skipping else "dense",
    )
    if not enable_skipping:
        out, lse = flash_attention(
            q, k, v, scale=scale, block_sizes=bs, return_lse=True
        )
        new_state = state
    else:
        if schedule is None:
            schedule = pack_schedule(state.do_mask)
        fidx, count = schedule
        out, lse, votes = lite_flash_attention(
            q, k, v, fidx, count, threshold, state.do_mask, scale=scale,
            block_sizes=bs, emit_votes=emit_votes,
        )
        if emit_votes:
            new_state = update_mask(state, votes, must_do=must_do)
        else:
            new_state = state
    if return_lse:
        return out, lse, new_state
    return out, new_state


def _ranges_from_flat_list(flat: Sequence[int]) -> List[Tuple[int, int]]:
    """Flat inclusive ``[hi, lo, hi, lo, ...]`` pairs (either order) ->
    half-open ranges."""
    if len(flat) % 2:
        raise ValueError("range list must hold (start, end) pairs")
    out = []
    for i in range(0, len(flat), 2):
        a, b = int(flat[i]), int(flat[i + 1])
        out.append((min(a, b), max(a, b) + 1))
    return out


def _flag(name: str) -> bool:
    return os.getenv(name, "FALSE") != "FALSE"


class LiteAttention:
    """Stateful LiteAttention wrapper (reference-class API).

    Args:
      enable_skipping: enable the temporal skip optimization.
      threshold: log2-space skip threshold; must be negative unless
        ``LITE_ATTENTION_DEBUG`` is set.
      max_batch_size: validated against; the mask is sized to the batch.
      block_sizes: optional tile override (``block_q`` 128; ``block_k``
        sets the vote step width).
      vote_stride: vote (and evolve the mask) every N-th call; between
        vote calls the cached schedule and the no-vote kernel run.
      vote_backoff_cap: adaptive cadence (0 = off): the stride doubles up
        to the cap each time a vote leaves the mask unchanged and resets
        to ``vote_stride`` when a vote shrinks it or the threshold
        changes.
      adaptive_geometry: accepted for API parity. The JAX engine picks a
        narrower compute tile when the union over a tile's fine q-rows is
        loose; on Hopper a CTA already owns one fine q-row (qsubs = 1),
        so there is no union and the flag is an exact no-op.
      kv_compact: accepted for API parity and a no-op: K/V union
        compaction (kernel B6 of the JAX package) is not ported yet.
    """

    def __init__(
        self,
        enable_skipping: bool = True,
        threshold: float = -10.0,
        max_batch_size: int = 4,
        block_sizes: Optional[BlockSizes] = None,
        vote_stride: int = 1,
        vote_backoff_cap: int = 0,
        adaptive_geometry: bool = False,
        kv_compact: bool = True,
    ):
        if vote_stride < 1:
            raise ValueError("vote_stride must be >= 1")
        if vote_backoff_cap and vote_backoff_cap < vote_stride:
            raise ValueError("vote_backoff_cap must be 0 or >= vote_stride")
        self._state: Optional[SkipMaskState] = None
        self._last_key = None
        self._last_percentage = 0.0
        self._read_mask = None
        self._call_count = 0
        self._sched_cache = None
        self.enable_skipping = enable_skipping
        self.max_batch_size = max_batch_size
        self.block_sizes = block_sizes
        self.vote_stride = vote_stride
        self.vote_backoff_cap = int(vote_backoff_cap)
        self._cur_stride = vote_stride
        self._since_vote = 0
        self._last_vote_live = None
        self.adaptive_geometry = bool(adaptive_geometry)
        self.kv_compact = bool(kv_compact)
        self.set_threshold(threshold)

    @staticmethod
    def ceil_div(x: int, y: int) -> int:
        return cdiv(x, y)

    def set_threshold(self, threshold: float):
        """Update the skip threshold; thresholds >= 0 (other than +inf)
        need ``LITE_ATTENTION_DEBUG``."""
        if (
            float(threshold) >= 0
            and threshold != float("inf")
            and not _flag("LITE_ATTENTION_DEBUG")
        ):
            raise ValueError(
                "threshold must be negative when debug mode is not enabled"
            )
        if getattr(self, "threshold", None) != float(threshold):
            # A new threshold can shrink the mask further: drop the
            # backoff to the base cadence so votes pick it up promptly.
            self._cur_stride = self.vote_stride
            self._last_vote_live = None
        self.threshold = float(threshold)

    def reset_skip_state(self):
        """Drop the persistent mask."""
        self._state = None
        self._last_key = None
        self._last_percentage = 0.0
        self._read_mask = None
        self._call_count = 0
        self._sched_cache = None
        self._cur_stride = self.vote_stride
        self._since_vote = 0
        self._last_vote_live = None

    def enable_skip_optimization(self, enable: bool = True):
        """Toggle skipping; disabled runs the dense path."""
        self.enable_skipping = enable

    def get_skip_percentage(self) -> float:
        """Fraction of tiles skipped in the most recent call."""
        return float(self._last_percentage)

    @property
    def state(self) -> Optional[SkipMaskState]:
        return self._state

    def __call__(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        scale: Optional[float] = None,
        return_softmax_lse: bool = False,
        must_do_list: Optional[Sequence[int]] = None,
        must_skip_list: Optional[Sequence[int]] = None,
    ):
        """Attention forward with temporal skip-mask evolution.

        Args:
          query, key, value: ``[batch, seq_len, heads, head_dim]``.
          must_do_list: flat inclusive (start, end) sequence-index pairs
            that are never skipped.
          must_skip_list: flat pairs pre-skipped at (re)initialization.

        Returns:
          out ``[batch, seq_len, heads, head_dim]`` (+ lse ``[B, H, S]``
          when ``return_softmax_lse``).
        """
        b, s, h, d = query.shape
        if b > self.max_batch_size:
            raise ValueError(
                "batch size must be <= max_batch_size (modify "
                "max_batch_size in the LiteAttention constructor)"
            )
        q = query.transpose(1, 2)
        k = key.transpose(1, 2)
        v = value.transpose(1, 2)
        sk = k.shape[2]
        bs = self.block_sizes or get_block_sizes(
            d, q.element_size(),
            kind="lite" if self.enable_skipping else "dense",
        )
        key_sig = (b, s, sk, h, d, str(q.dtype), bs)
        if self.enable_skipping and (
            self._state is None or self._last_key != key_sig
        ):
            if self._last_key is not None and _flag("LITE_ATTENTION_VERBOSE"):
                print("[Warning]: reinitialized skip list during the forward pass")
            ranges = (
                _ranges_from_flat_list(must_skip_list) if must_skip_list else None
            )
            self._state = lite_attention_init(
                b, h, s, sk, d, q.element_size(), must_skip_ranges=ranges,
                block_sizes=bs, device=q.device,
            )
            self._last_key = key_sig
            self._sched_cache = None

        must_do = None
        if must_do_list is not None and self.enable_skipping:
            must_do = must_do_mask(
                _ranges_from_flat_list(must_do_list), sk, VOTE_TILE,
                device=q.device,
            )

        state = self._state
        if self.enable_skipping:
            self._read_mask = state.do_mask
            # The mask only changes on vote calls: reuse the schedule.
            if self._sched_cache is None:
                self._sched_cache = pack_schedule(state.do_mask)
        # Vote on the first call after (re)init, then every vote_stride-th
        # call (or on the adaptive backoff cadence).
        if self.vote_backoff_cap > 0:
            emit = self._call_count == 0 or self._since_vote >= self._cur_stride
        else:
            emit = self._call_count % self.vote_stride == 0
        self._call_count += 1
        self._since_vote += 1
        out, lse, new_state = lite_attention_step(
            state, q, k, v, threshold=self.threshold, scale=scale,
            must_do=must_do, enable_skipping=self.enable_skipping,
            block_sizes=bs, return_lse=True, emit_votes=emit,
            schedule=self._sched_cache if self.enable_skipping else None,
        )
        if self.enable_skipping:
            self._state = new_state
            if emit:
                # update_mask is a monotone AND, so an unchanged skipped
                # fraction means an unchanged mask: keep the schedule.
                live = float(sparsity(new_state.do_mask))
                if live != self._last_vote_live:
                    self._sched_cache = None
                self._since_vote = 0
                if self.vote_backoff_cap > 0:
                    if live == self._last_vote_live:
                        self._cur_stride = min(
                            self._cur_stride * 2, self.vote_backoff_cap
                        )
                    else:
                        self._cur_stride = self.vote_stride
                self._last_vote_live = live
            self._last_percentage = float(sparsity(self._read_mask))
            if _flag("LITE_ATTENTION_VERBOSE"):
                print(
                    "[Info]: Percentage of tiles skipped: "
                    f"{self._last_percentage:.2%}"
                )
        out = out.transpose(1, 2)
        if return_softmax_lse:
            return out, lse
        return out


__all__ = [
    "LiteAttention",
    "effective_blocks",
    "lite_attention_init",
    "lite_attention_step",
]
