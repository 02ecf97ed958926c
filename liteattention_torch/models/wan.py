"""Wan2.1-style video-diffusion DiT with LiteAttention self-attention.

Counterpart of ``liteattention_tpu/models/wan.py`` (text-to-video only).
Patchified 3D latents, adaLN-modulated blocks with 3D-RoPE
self-attention and text cross-attention, sized by :class:`WanConfig`
(defaults: Wan2.1-14B geometry, dim 5120, 40 heads x 128, 40 blocks, ffn
13824, umT5 text dim 4096).

Self-attention runs the lite (skip) kernel when a mask state is passed
and the dense kernel otherwise; text cross-attention always runs the
dense kernel. Linear layers stay ``nn.Linear`` (cuBLAS), as the JAX
package left them to XLA. Parameters that the JAX model computes in
``cfg.dtype`` are held in ``cfg.dtype``; the time MLPs, modulation
biases and norm scales stay fp32, as in the JAX model.

Not ported yet (they raise): the I2V branches (``i2v_decoupled``,
``image_ctx``, ``latent_cond``), sequence parallelism (``sp_axis``),
``remat`` and the training probe ``attn_probe_rows``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from liteattention_torch.device import resolve_device
from liteattention_torch.lite_attention import (
    lite_attention_init,
    lite_attention_step,
)
from liteattention_torch.models.convert import state_dict_from_flax
from liteattention_torch.ops.flash_fwd import flash_attention
from liteattention_torch.ops.tile_sizes import BlockSizes, get_block_sizes


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Geometry of a Wan2.x-family DiT."""

    dim: int = 5120
    ffn_dim: int = 13824
    num_heads: int = 40
    head_dim: int = 128
    num_layers: int = 40
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    text_len: int = 512
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    freq_dim: int = 256
    qk_norm: bool = True
    eps: float = 1e-6
    dtype: Any = torch.bfloat16
    block_sizes: Optional[BlockSizes] = None
    i2v_decoupled: bool = False
    remat: bool = False
    attn_probe_rows: int = 0
    sp_axis: Optional[str] = None

    def attn_block_sizes(self, kind: str = "lite") -> BlockSizes:
        return self.block_sizes or get_block_sizes(self.head_dim, 2, kind=kind)

    @staticmethod
    def tiny() -> "WanConfig":
        """Small config for tests."""
        return WanConfig(
            dim=128, ffn_dim=256, num_heads=2, head_dim=64, num_layers=2,
            text_dim=64, text_len=16, freq_dim=32,
            block_sizes=BlockSizes(128, 128),
        )


def timestep_embedding(t: torch.Tensor, dim: int, max_period=10000.0):
    """Sinusoidal timestep embedding (fp32)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _rope_split(head_dim: int) -> Tuple[int, int, int]:
    """Split head_dim across (t, h, w) rotary axes; 44/42/42 at 128."""
    d_hw = 2 * (head_dim // 6)
    return head_dim - 2 * d_hw, d_hw, d_hw


def rope_3d_freqs(
    grid: Tuple[int, int, int], head_dim: int, theta: float = 10000.0,
    device=None,
) -> torch.Tensor:
    """Per-token rotation angles for 3D RoPE, fp32 ``[N, head_dim // 2]``."""
    f, h, w = grid
    d_t, d_h, d_w = _rope_split(head_dim)

    def axis_freqs(n, d):
        exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
        inv = 1.0 / (theta ** exps)
        return torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None]

    ft = axis_freqs(f, d_t)[:, None, None, :].expand(f, h, w, d_t // 2)
    fh = axis_freqs(h, d_h)[None, :, None, :].expand(f, h, w, d_h // 2)
    fw = axis_freqs(w, d_w)[None, None, :, :].expand(f, h, w, d_w // 2)
    return torch.cat([ft, fh, fw], dim=-1).reshape(f * h * w, head_dim // 2)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[B, N, H, D]`` by per-token angles ``[N, D/2]``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm over the last dim: fp32 math, fp32 scale, output in
    ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (n * self.weight).to(self.dtype)


def _layer_norm(x, eps, dtype, weight=None, bias=None):
    """LayerNorm in fp32, output in ``dtype`` (the JAX model's form)."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(dtype)


class CtxProj(nn.Module):
    """Two-layer tanh-gelu MLP projecting encoder states to model dim."""

    def __init__(self, in_dim: int, dim: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        x = F.gelu(self.fc1(x.to(self.dtype)), approximate="tanh")
        return self.fc2(x)


def _bhsd(x, num_heads):
    b, n, _ = x.shape
    return x.reshape(b, n, num_heads, -1).transpose(1, 2)


def _bnhd(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class WanSelfAttention(nn.Module):
    """3D-RoPE self-attention: lite kernel with a mask state, dense
    kernel without."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        lin = dict(dtype=cfg.dtype, device=device)
        self.q = nn.Linear(cfg.dim, inner, **lin)
        self.k = nn.Linear(cfg.dim, inner, **lin)
        self.v = nn.Linear(cfg.dim, inner, **lin)
        self.o = nn.Linear(inner, cfg.dim, **lin)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)
            self.k_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)

    def forward(self, x, freqs, state=None, threshold=-10.0, emit_votes=True,
                schedule=None):
        cfg = self.cfg
        b, n, _ = x.shape
        q, k, v = self.q(x), self.k(x), self.v(x)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q = apply_rope(q.reshape(b, n, cfg.num_heads, cfg.head_dim), freqs)
        k = apply_rope(k.reshape(b, n, cfg.num_heads, cfg.head_dim), freqs)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), _bhsd(v, cfg.num_heads)
        if state is None:
            oh = flash_attention(qh, kh, vh, block_sizes=cfg.attn_block_sizes("dense"))
            new_state = None
        else:
            oh, new_state = lite_attention_step(
                state, qh, kh, vh, threshold=threshold,
                block_sizes=cfg.attn_block_sizes("lite"),
                emit_votes=emit_votes, schedule=schedule,
            )
        return self.o(_bnhd(oh)), new_state


class WanCrossAttention(nn.Module):
    """Text cross-attention, always dense."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        lin = dict(dtype=cfg.dtype, device=device)
        self.q = nn.Linear(cfg.dim, inner, **lin)
        self.k = nn.Linear(cfg.dim, inner, **lin)
        self.v = nn.Linear(cfg.dim, inner, **lin)
        self.o = nn.Linear(inner, cfg.dim, **lin)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)
            self.k_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)

    def forward(self, x, ctx):
        cfg = self.cfg
        q, k, v = self.q(x), self.k(ctx), self.v(ctx)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        oh = flash_attention(
            _bhsd(q, cfg.num_heads), _bhsd(k, cfg.num_heads),
            _bhsd(v, cfg.num_heads), block_sizes=cfg.attn_block_sizes("dense"),
        )
        return self.o(_bnhd(oh))


def _modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


class WanBlock(nn.Module):
    """adaLN-modulated DiT block: self-attn -> cross-attn -> FFN."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mod_bias = nn.Parameter(torch.zeros(6, cfg.dim, device=device))
        self.self_attn = WanSelfAttention(cfg, device)
        self.cross_attn = WanCrossAttention(cfg, device)
        # norm3 is affine (Wan's cross_attn_norm); norm1/norm2 are not.
        self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps, device=device)
        lin = dict(dtype=cfg.dtype, device=device)
        self.ffn_up = nn.Linear(cfg.dim, cfg.ffn_dim, **lin)
        self.ffn_down = nn.Linear(cfg.ffn_dim, cfg.dim, **lin)

    def forward(self, x, ctx, t_mod, freqs, state=None, threshold=-10.0,
                emit_votes=True, schedule=None):
        cfg = self.cfg
        mod = (t_mod + self.mod_bias[None]).float()
        sh1, sc1, g1, sh2, sc2, g2 = [
            mod[:, i].to(cfg.dtype)[:, None, :] for i in range(6)
        ]
        h_attn, new_state = self.self_attn(
            _modulate(_layer_norm(x, cfg.eps, cfg.dtype), sh1, sc1),
            freqs, state, threshold, emit_votes, schedule,
        )
        x = x + g1 * h_attn
        x = x + self.cross_attn(
            _layer_norm(x, cfg.eps, cfg.dtype, self.norm3.weight, self.norm3.bias),
            ctx,
        )
        h = _modulate(_layer_norm(x, cfg.eps, cfg.dtype), sh2, sc2)
        h = self.ffn_down(F.gelu(self.ffn_up(h), approximate="tanh"))
        return x + g2 * h, new_state


class WanModel(nn.Module):
    """Wan2.x-family DiT backbone (T2V).

    ``forward(latents, t, text, skip_states, threshold)`` with latents
    ``[B, F, H, W, C]``, timesteps ``t`` ``[B]``, text ``[B, L,
    text_dim]`` and optional per-layer skip states ``{layer:
    SkipMaskState}``. Returns (velocity prediction ``[B, F, H, W,
    C_out]``, new skip states or None). Parameters go on ``device``
    (default ``cuda``).
    """

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        if cfg.i2v_decoupled or cfg.remat or cfg.attn_probe_rows or cfg.sp_axis:
            raise NotImplementedError(
                "WanModel: i2v_decoupled, remat, attn_probe_rows and sp_axis "
                "are not ported yet"
            )
        self.cfg = cfg
        pt, ph, pw = cfg.patch_size
        lin = dict(dtype=cfg.dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.patch_embed = nn.Linear(pt * ph * pw * cfg.in_channels, cfg.dim, **lin)
        self.text_proj = CtxProj(cfg.text_dim, cfg.dim, cfg.dtype, device)
        self.time_mlp_1 = nn.Linear(cfg.freq_dim, cfg.dim, **f32)
        self.time_mlp_2 = nn.Linear(cfg.dim, cfg.dim, **f32)
        self.time_mod = nn.Linear(cfg.dim, 6 * cfg.dim, **f32)
        self.blocks = nn.ModuleList(
            WanBlock(cfg, device) for _ in range(cfg.num_layers)
        )
        self.final_mod_bias = nn.Parameter(torch.zeros(2, cfg.dim, device=device))
        self.proj_out = nn.Linear(cfg.dim, pt * ph * pw * cfg.out_channels, **lin)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Random weights from ``generator``: lecun-normal linear weights,
        zero biases, unit norm scales, N(0, 0.02) modulation biases (the
        JAX model's initializers)."""
        for name, p in self.named_parameters():
            if name.endswith("mod_bias"):
                p.normal_(0.0, 0.02, generator=generator)
            elif p.dim() == 2:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def forward(
        self,
        latents: torch.Tensor,
        t: torch.Tensor,
        text: torch.Tensor,
        skip_states: Optional[Dict[int, Any]] = None,
        threshold=-10.0,
        image_ctx: Optional[torch.Tensor] = None,
        latent_cond: Optional[torch.Tensor] = None,
        emit_votes: bool = True,
        schedules: Optional[Dict[int, Any]] = None,
    ):
        if image_ctx is not None or latent_cond is not None:
            raise NotImplementedError("WanModel: I2V inputs are not ported yet")
        cfg = self.cfg
        b, f, hh, ww, c = latents.shape
        pt, ph, pw = cfg.patch_size
        gf, gh, gw = f // pt, hh // ph, ww // pw

        # Patchify: [B, F, H, W, C] -> [B, N, dim].
        x = latents.reshape(b, gf, pt, gh, ph, gw, pw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, gf * gh * gw, pt * ph * pw * c)
        x = self.patch_embed(x.to(cfg.dtype))
        ctx = self.text_proj(text)

        te = timestep_embedding(t, cfg.freq_dim)
        te = self.time_mlp_2(F.silu(self.time_mlp_1(te)))
        t_mod = self.time_mod(F.silu(te)).reshape(b, 6, cfg.dim)

        freqs = rope_3d_freqs((gf, gh, gw), cfg.head_dim, device=latents.device)
        new_states: Dict[int, Any] = {}
        for i, block in enumerate(self.blocks):
            st = skip_states.get(i) if skip_states is not None else None
            sched = schedules.get(i) if schedules is not None else None
            x, st_new = block(x, ctx, t_mod, freqs, st, threshold, emit_votes, sched)
            if st_new is not None:
                new_states[i] = st_new

        # Final modulated projection (shift/scale = bias + raw time
        # embedding) and unpatchify.
        fm = self.final_mod_bias[None] + te[:, None, :]
        shift, scale = [fm[:, i].to(cfg.dtype)[:, None, :] for i in range(2)]
        x = _modulate(_layer_norm(x, cfg.eps, cfg.dtype), shift, scale)
        x = self.proj_out(x)
        x = x.reshape(b, gf, gh, gw, pt, ph, pw, cfg.out_channels)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, f, hh, ww, cfg.out_channels)
        return x, (new_states if skip_states is not None else None)


def init_skip_states(
    cfg: WanConfig, batch: int, grid: Tuple[int, int, int], device=None
) -> Dict[int, Any]:
    """Per-layer skip-mask states for a latent grid (one persistent
    LiteAttention state per block), on ``device`` (default ``cuda``)."""
    n = (
        (grid[0] // cfg.patch_size[0])
        * (grid[1] // cfg.patch_size[1])
        * (grid[2] // cfg.patch_size[2])
    )
    return {
        i: lite_attention_init(
            batch, cfg.num_heads, n, n, cfg.head_dim, 2,
            block_sizes=cfg.attn_block_sizes(), device=device,
        )
        for i in range(cfg.num_layers)
    }


def wan_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """Flax ``WanModel`` params -> this module's ``state_dict``
    (:func:`~liteattention_torch.models.convert.state_dict_from_flax`)."""
    return state_dict_from_flax(params)


__all__ = [
    "WanConfig",
    "WanModel",
    "WanBlock",
    "init_skip_states",
    "rope_3d_freqs",
    "apply_rope",
    "timestep_embedding",
    "wan_state_dict_from_jax",
]
