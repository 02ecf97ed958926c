"""Denoising pipeline: flow-matching sampler with skip-state carry.

Counterpart of ``liteattention_tpu/models/pipeline.py`` (``denoise``,
``denoise_two_expert``, ``flow_timesteps``, ``linear_threshold_schedule``).
The JAX ``lax.scan`` becomes a Python loop: the per-layer skip states
are carried from step to step, each step consumes the masks written by
the previous one, and the cond and uncond passes of classifier-free
guidance keep separate states. With ``vote_stride`` N only every N-th step votes; the compacted
schedules are rebuilt (kernel B2) only after a vote step, when the masks
can have changed. With ``kv_compact`` they are union-compacted schedules
(kernel B6 relays K and V in every self-attention call).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from liteattention_torch.models.wan import WanModel, init_skip_states
from liteattention_torch.ops.kv_compact import kv_union_map
from liteattention_torch.ops.schedule_pack import pack_schedule
from liteattention_torch.ops.tile_sizes import VOTE_TILE


def linear_threshold_schedule(
    num_steps: int, start: float = -10.0, end: float = -2.0
) -> torch.Tensor:
    """Per-timestep skip thresholds, loosening over the trajectory."""
    return torch.linspace(start, end, num_steps)


def flow_timesteps(
    num_steps: int, shift: float = 5.0, t_max: float = 1000.0
) -> torch.Tensor:
    """Wan-style shifted rectified-flow timesteps in [0, 1000]."""
    sigmas = torch.linspace(1.0, 1.0 / num_steps, num_steps)
    sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return sigmas * t_max


def _sparsity_of(states, group=None) -> torch.Tensor:
    """The mean over layers of each mask's skipped share; with ``group``
    (sequence parallel: each state a rank's equal shard) of the whole
    mask's, the ranks' shares averaged by an ``all_reduce``."""
    live = torch.stack([s.do_mask.float().mean() for s in states.values()])
    if group is not None:
        torch.distributed.all_reduce(live, group=group)
        live = live / group.size()
    return (1.0 - live).mean()


def _compact(states, kv_compact):
    """Each layer's schedule: ``(fidx, count)``, or with ``kv_compact`` the
    union-compacted ``(fidx, count, cidx, inv)``."""
    if states is None:
        return None
    out = {}
    for i, st in states.items():
        if kv_compact:
            kv_map, inv, _ = kv_union_map(st.do_mask)
            out[i] = (*pack_schedule(st.do_mask, kv_map), inv)
        else:
            out[i] = pack_schedule(st.do_mask)
    return out


@torch.no_grad()
def denoise(
    model: WanModel,
    noise: torch.Tensor,
    text: torch.Tensor,
    null_text: Optional[torch.Tensor] = None,
    num_steps: int = 50,
    guidance_scale: float = 5.0,
    thresholds: Optional[Sequence[float]] = None,
    enable_skipping: bool = True,
    timestep_shift: float = 5.0,
    step_range: Optional[Tuple[int, int]] = None,
    initial_states: Optional[Dict[int, Any]] = None,
    initial_states_uncond: Optional[Dict[int, Any]] = None,
    image_ctx: Optional[torch.Tensor] = None,
    latent_cond: Optional[torch.Tensor] = None,
    vote_stride: int = 1,
    kv_compact: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the denoising trajectory with LiteAttention state carry.

    Args:
      noise: ``[B, F, H, W, C]`` initial latent noise.
      text / null_text: conditioning (and optional CFG negative) encoder
        states ``[B, L, text_dim]``; CFG applies when ``null_text`` is
        given.
      thresholds: per-step skip thresholds (default linear schedule).
      enable_skipping: False runs the dense baseline.
      step_range: run only steps ``[lo, hi)`` of the schedule.
      initial_states(_uncond): skip states to start from.
      vote_stride: vote (and evolve the masks) on every N-th step.
      image_ctx / latent_cond: I2V conditioning (CLIP image tokens and
        extra latent channels), passed to every model call, both CFG
        branches included (the negative branch drops only the text).
      kv_compact: union-compact K/V (kernel B6) in every self-attention
        call, when the token count is a multiple of 128 (JAX's static
        gate: there is no union-density readback, unlike
        :class:`~liteattention_torch.LiteAttention`). The latents do not
        change. A sequence-parallel model (``cfg.sp_axis``) does not
        compact, as in JAX.

    With ``cfg.sp_axis`` every rank of the model's sequence-parallel group
    calls with the same inputs, the states are each rank's mask shards
    (default :func:`init_skip_states` with the model's mesh), and the
    sparsity is the whole masks', the same on every rank.

    Returns:
      (denoised latents, telemetry with ``sparsity_per_step`` (sparsity
      of the cond states after each step), ``final_sparsity``,
      ``final_states``, ``final_states_uncond``).
    """
    cfg = model.cfg
    b = noise.shape[0]
    grid = tuple(noise.shape[1:4])
    if thresholds is None:
        thresholds = linear_threshold_schedule(num_steps)
    thresholds = [float(t) for t in thresholds]
    ts = flow_timesteps(num_steps, shift=timestep_shift)
    sigmas = ts / 1000.0
    sigma_next = torch.cat([sigmas[1:], torch.zeros(1)])
    use_cfg = null_text is not None

    mesh = getattr(model, "mesh", None)
    group = mesh.get_group(cfg.sp_axis) if mesh is not None else None
    states_c = states_u = None
    if enable_skipping:
        states_c = initial_states or init_skip_states(cfg, b, grid, noise.device, mesh)
        if use_cfg:
            states_u = initial_states_uncond or init_skip_states(
                cfg, b, grid, noise.device, mesh
            )

    lo, hi = step_range if step_range is not None else (0, num_steps)
    ts, sigmas, sigma_next = ts[lo:hi], sigmas[lo:hi], sigma_next[lo:hi]
    thresholds = thresholds[lo:hi]
    n = len(ts)
    stride = max(1, min(vote_stride, n)) if enable_skipping else 1
    pt, ph, pw = cfg.patch_size
    n_tok = (grid[0] // pt) * (grid[1] // ph) * (grid[2] // pw)
    use_kvc = kv_compact and n_tok % VOTE_TILE == 0 and group is None
    sched_c, sched_u = _compact(states_c, use_kvc), _compact(states_u, use_kvc)

    cond = dict(image_ctx=image_ctx, latent_cond=latent_cond)
    x = noise
    trace = []
    for j in range(n):
        emit = j % stride == 0
        tt = torch.full((b,), float(ts[j]), dtype=torch.float32, device=x.device)
        v_c, states_c = model(
            x, tt, text, states_c, thresholds[j], emit_votes=emit,
            schedules=sched_c, **cond,
        )
        if use_cfg:
            v_u, states_u = model(
                x, tt, null_text, states_u, thresholds[j], emit_votes=emit,
                schedules=sched_u, **cond,
            )
            v = v_u + guidance_scale * (v_c - v_u)
        else:
            v = v_c
        # Rectified-flow Euler step: x <- x + (sigma_next - sigma) * v.
        dt = (sigma_next[j] - sigmas[j]).item()
        x = (x.float() + dt * v.float()).to(x.dtype)
        if enable_skipping and emit and j + 1 < n:
            # The masks may have shrunk: recompact for the next steps.
            sched_c, sched_u = _compact(states_c, use_kvc), _compact(states_u, use_kvc)
        trace.append(
            _sparsity_of(states_c, group) if enable_skipping
            else torch.zeros((), device=x.device)
        )
    sparsity_trace = torch.stack(trace)
    telemetry = {
        "sparsity_per_step": sparsity_trace,
        "final_sparsity": sparsity_trace[-1],
        "final_states": states_c,
        "final_states_uncond": states_u,
    }
    return x, telemetry


def denoise_two_expert(
    model_high: WanModel,
    model_low: WanModel,
    noise: torch.Tensor,
    text: torch.Tensor,
    null_text: Optional[torch.Tensor] = None,
    num_steps: int = 50,
    boundary: float = 0.875,
    guidance_scale: float = 5.0,
    guidance_scale_low: Optional[float] = None,
    thresholds: Optional[Sequence[float]] = None,
    enable_skipping: bool = True,
    timestep_shift: float = 5.0,
    image_ctx: Optional[torch.Tensor] = None,
    latent_cond: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Wan2.2-A14B two-expert denoising: the high-noise expert runs the
    steps whose sigma is at least ``boundary``, the low-noise expert the
    rest, and the skip states of both CFG branches carry across the
    switch (the masks are not reset).

    The JAX function takes one model and two parameter trees; this one
    takes the two experts as two :class:`WanModel` s of the same
    geometry.

    Returns (latents, telemetry with ``sparsity_per_step`` over both
    segments, ``final_sparsity``, ``final_states`` and
    ``num_high_noise_steps``).
    """
    # The switch step is schedule math: the sigmas of flow_timesteps.
    sig = np.linspace(1.0, 1.0 / num_steps, num_steps)
    sig = timestep_shift * sig / (1.0 + (timestep_shift - 1.0) * sig)
    n_high = int(np.sum(sig >= boundary))
    if thresholds is None:
        thresholds = linear_threshold_schedule(num_steps)
    if guidance_scale_low is None:
        guidance_scale_low = guidance_scale
    common = dict(num_steps=num_steps, thresholds=thresholds,
                  enable_skipping=enable_skipping, timestep_shift=timestep_shift,
                  image_ctx=image_ctx, latent_cond=latent_cond)
    x, tel_hi = denoise(
        model_high, noise, text, null_text, guidance_scale=guidance_scale,
        step_range=(0, n_high), **common,
    )
    x, tel_lo = denoise(
        model_low, x, text, null_text, guidance_scale=guidance_scale_low,
        step_range=(n_high, num_steps), initial_states=tel_hi["final_states"],
        initial_states_uncond=tel_hi["final_states_uncond"], **common,
    )
    telemetry = {
        "sparsity_per_step": torch.cat(
            [tel_hi["sparsity_per_step"], tel_lo["sparsity_per_step"]]
        ),
        "final_sparsity": tel_lo["final_sparsity"],
        "final_states": tel_lo["final_states"],
        "num_high_noise_steps": n_high,
    }
    return x, telemetry


__all__ = ["denoise", "denoise_two_expert", "flow_timesteps", "linear_threshold_schedule"]
