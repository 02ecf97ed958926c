"""Wan2.1-style video-diffusion DiT with LiteAttention self-attention.

Counterpart of ``liteattention_tpu/models/wan.py``. Patchified 3D
latents, adaLN-modulated blocks with 3D-RoPE self-attention and text
cross-attention, sized by :class:`WanConfig` (defaults: Wan2.1-14B
geometry, dim 5120, 40 heads x 128, 40 blocks, ffn 13824, umT5 text dim
4096).

Image-to-video: ``latent_cond`` channels are concatenated to the latents
before patchify, and CLIP image tokens (``image_ctx``) go through
:class:`ImgProj`. With ``cfg.i2v_decoupled`` (Wan2.1-I2V) they feed an
image branch of the cross-attention with its own K/V projections, whose
output is added to the text branch's; otherwise (the Wan2.2 shared
context) they are prepended to the text tokens. Unlike the Flax model,
which sizes its layers from the first inputs, this one needs the widths
up front: ``cfg.in_channels`` is the patch embedding's input, noise plus
conditioning channels (36 = 16 + 20 for Wan2.1-I2V-14B), and
``WanModel(image_dim=)`` is the width of the image tokens (1280 for
CLIP ViT-H/14).

Self-attention runs the lite (skip) kernel when a mask state is passed
and the dense kernel otherwise; text cross-attention always runs the
dense kernel. Linear layers are cuBLAS products, as the JAX package left
them to XLA. The linears that the JAX model computes in ``cfg.dtype``
are held in ``cfg.dtype`` for inference and compute in it whatever their
parameters' dtype (:class:`~liteattention_torch.modules.dense.Dense`), so
``model.float()`` gives JAX's training setup: fp32 parameters, bf16
products. The time MLPs, modulation biases and norm scales stay fp32,
as in the JAX model.

Training: ``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant) whenever gradients are
enabled. ``cfg.attn_probe_rows`` makes each self-attention layer compute
exact fp32 softmax statistics of a strided sample of query rows; after a
forward, ``WanModel.intermediates`` holds them per layer under the JAX
names ``attn_entropy`` and ``attn_tile_excess``, differentiable.

Sequence parallelism (``cfg.sp_axis``, a dim name of the ``DeviceMesh``
the model is built with, ``WanModel(cfg, mesh=mesh)``): the ranks of that
dim split the keys of every self-attention that runs with a skip state.
Each rank computes q for every token and K/V for its own contiguous token
shard (rope at those tokens' global positions), holds the k-tiles of its
shard of each layer's mask (:func:`init_skip_states` with ``mesh``), and
merges its partial attention with the others'
(:func:`~liteattention_torch.parallel.seq_parallel.seq_parallel_attention_step`);
everything else runs whole on every rank, so every rank returns the whole
output. The token count must split evenly over the ranks; a shard need
not be a whole number of 128-key tiles (its mask is tiled from its own
first key, as JAX's ``shard_map`` tiles each shard). Dense calls (no skip
state) run whole on every rank, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from liteattention_torch.device import resolve_device
from liteattention_torch.lite_attention import (
    lite_attention_init,
    lite_attention_step,
)
from liteattention_torch.models.convert import state_dict_from_flax
from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.flash_fwd import LOG2E, flash_attention
from liteattention_torch.ops.mask import init_mask
from liteattention_torch.ops.tile_sizes import VOTE_TILE, BlockSizes, get_block_sizes
from liteattention_torch.parallel._collectives import shard_dim
from liteattention_torch.parallel.seq_parallel import seq_parallel_attention_step


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


def _dense(in_dim: int, out_dim: int, dtype, device) -> Dense:
    """A linear held in ``dtype`` that computes in ``dtype``; after
    ``model.float()`` its fp32 parameters are cast for each product."""
    return Dense(in_dim, out_dim, dtype=dtype, device=device, param_dtype=dtype)


def _layer_norm(x, eps, dtype, weight=None, bias=None):
    """LayerNorm in fp32, output in ``dtype`` (the JAX model's form)."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(dtype)


class ImgProj(nn.Module):
    """Wan-I2V CLIP-token projection (Wan's MLPProj): LayerNorm -> Linear
    -> exact GELU -> Linear -> LayerNorm, both norms affine at eps 1e-6
    (Flax ``nn.LayerNorm``'s default, not torch's 1e-5)."""

    eps = 1e-6

    def __init__(self, in_dim: int, dim: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm_in = nn.LayerNorm(in_dim, eps=self.eps, device=device)
        self.fc1 = _dense(in_dim, in_dim, dtype, device)
        self.fc2 = _dense(in_dim, dim, dtype, device)
        self.norm_out = nn.LayerNorm(dim, eps=self.eps, device=device)

    def forward(self, x):
        x = _layer_norm(x.to(self.dtype), self.eps, self.dtype,
                        self.norm_in.weight, self.norm_in.bias)
        x = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return _layer_norm(x, self.eps, self.dtype, self.norm_out.weight, self.norm_out.bias)


class CtxProj(nn.Module):
    """Two-layer tanh-gelu MLP projecting encoder states to model dim."""

    def __init__(self, in_dim: int, dim: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = _dense(in_dim, dim, dtype, device)
        self.fc2 = _dense(dim, dim, dtype, device)

    def forward(self, x):
        x = F.gelu(self.fc1(x.to(self.dtype)), approximate="tanh")
        return self.fc2(x)


def _bhsd(x, num_heads):
    b, n, _ = x.shape
    return x.reshape(b, n, num_heads, -1).transpose(1, 2)


def _bnhd(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _attention_probe(qh: torch.Tensor, kh: torch.Tensor, rows: int) -> Dict[str, torch.Tensor]:
    """Exact softmax statistics of ``min(rows, N)`` query rows at stride
    ``max(N // rows, 1)`` (the JAX model's training probe), differentiable:
    ``attn_entropy``, the mean row entropy ``lse - sum(p * s)`` in nats,
    and, when the keys hold more than one 128-key tile,
    ``attn_tile_excess``, the mean of ``softplus(tile max - row max + 3)``
    in the kernel's log2 units, comparable to the skip threshold.

    The scores are fp32 at full precision, as JAX's ``Precision.HIGHEST``:
    on the card the product needs TF32 off (PyTorch's default), and a call
    with ``torch.backends.cuda.matmul.allow_tf32`` on raises.
    """
    if qh.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "attn_probe_rows: TF32 matmuls are on, but the probe's scores are exact "
            "fp32; set torch.backends.cuda.matmul.allow_tf32 = False"
        )
    n, d = qh.shape[2], qh.shape[3]
    r = min(rows, n)
    qp = qh[:, :, :: max(n // r, 1)][:, :, :r].float()
    s = torch.einsum("bhrd,bhnd->bhrn", qp, kh.float()) * (1.0 / float(d) ** 0.5)
    p = torch.softmax(s, dim=-1)
    probe = {"attn_entropy": (torch.logsumexp(s, dim=-1) - (p * s).sum(-1)).mean()}
    nt = n // VOTE_TILE
    if nt > 1:
        s2 = s * LOG2E
        tile_max = s2[..., : nt * VOTE_TILE].unflatten(-1, (nt, VOTE_TILE)).amax(-1)
        excess = tile_max - s2.amax(-1, keepdim=True)
        probe["attn_tile_excess"] = F.softplus(excess + 3.0).mean()
    return probe


class WanSelfAttention(nn.Module):
    """3D-RoPE self-attention: lite kernel with a mask state, dense
    kernel without."""

    def __init__(self, cfg: WanConfig, device=None, sp_group=None):
        super().__init__()
        self.cfg = cfg
        self.sp_group = sp_group
        inner = cfg.num_heads * cfg.head_dim
        self.q = _dense(cfg.dim, inner, cfg.dtype, device)
        self.k = _dense(cfg.dim, inner, cfg.dtype, device)
        self.v = _dense(cfg.dim, inner, cfg.dtype, device)
        self.o = _dense(inner, cfg.dim, cfg.dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)
            self.k_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)

    def forward(self, x, freqs, state=None, threshold=-10.0, emit_votes=True,
                schedule=None):
        cfg = self.cfg
        b, n, _ = x.shape
        sp = self.sp_group is not None and state is not None
        xk, fk = x, freqs
        if sp:  # K/V of this rank's token shard only
            xk, fk = shard_dim(x, 1, self.sp_group), shard_dim(freqs, 0, self.sp_group)
        q, k, v = self.q(x), self.k(xk), self.v(xk)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q = apply_rope(q.reshape(b, n, cfg.num_heads, cfg.head_dim), freqs)
        k = apply_rope(k.reshape(b, xk.shape[1], cfg.num_heads, cfg.head_dim), fk)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), _bhsd(v, cfg.num_heads)
        self.probe = (
            _attention_probe(qh, kh, cfg.attn_probe_rows)
            if cfg.attn_probe_rows > 0 and state is None else {}
        )
        if sp:
            oh, new_state = seq_parallel_attention_step(
                state, qh, kh, vh, threshold, self.sp_group,
                cfg.attn_block_sizes("lite"), emit_votes=emit_votes, schedule=schedule,
            )
        elif state is None:
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
    """Text cross-attention, always dense. With ``cfg.i2v_decoupled`` the
    image tokens take their own ``k_img``/``v_img`` projections (and
    ``k_img_norm`` under qk_norm), and the two branches' attention outputs
    are summed before ``o``."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        self.q = _dense(cfg.dim, inner, cfg.dtype, device)
        self.k = _dense(cfg.dim, inner, cfg.dtype, device)
        self.v = _dense(cfg.dim, inner, cfg.dtype, device)
        self.o = _dense(inner, cfg.dim, cfg.dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)
            self.k_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)
        if cfg.i2v_decoupled:
            self.k_img = _dense(cfg.dim, inner, cfg.dtype, device)
            self.v_img = _dense(cfg.dim, inner, cfg.dtype, device)
            if cfg.qk_norm:
                self.k_img_norm = RMSNorm(inner, cfg.eps, cfg.dtype, device)

    def _branch(self, qh, tokens, k_proj, v_proj, k_norm):
        cfg = self.cfg
        k = k_proj(tokens)
        if cfg.qk_norm:
            k = k_norm(k)
        return flash_attention(
            qh, _bhsd(k, cfg.num_heads), _bhsd(v_proj(tokens), cfg.num_heads),
            block_sizes=cfg.attn_block_sizes("dense"),
        )

    def forward(self, x, ctx, ctx_img=None):
        cfg = self.cfg
        q = self.q(x)
        if cfg.qk_norm:
            q = self.q_norm(q)
        qh = _bhsd(q, cfg.num_heads)
        oh = self._branch(qh, ctx, self.k, self.v, getattr(self, "k_norm", None))
        if cfg.i2v_decoupled:
            oh = oh + self._branch(
                qh, ctx_img, self.k_img, self.v_img, getattr(self, "k_img_norm", None)
            )
        return self.o(_bnhd(oh))


def _modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


class WanBlock(nn.Module):
    """adaLN-modulated DiT block: self-attn -> cross-attn -> FFN."""

    def __init__(self, cfg: WanConfig, device=None, sp_group=None):
        super().__init__()
        self.cfg = cfg
        self.mod_bias = nn.Parameter(torch.zeros(6, cfg.dim, device=device))
        self.self_attn = WanSelfAttention(cfg, device, sp_group)
        self.cross_attn = WanCrossAttention(cfg, device)
        # norm3 is affine (Wan's cross_attn_norm); norm1/norm2 are not.
        self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps, device=device)
        self.ffn_up = _dense(cfg.dim, cfg.ffn_dim, cfg.dtype, device)
        self.ffn_down = _dense(cfg.ffn_dim, cfg.dim, cfg.dtype, device)

    def forward(self, x, ctx, t_mod, freqs, state=None, threshold=-10.0,
                emit_votes=True, schedule=None, ctx_img=None):
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
            ctx, ctx_img,
        )
        h = _modulate(_layer_norm(x, cfg.eps, cfg.dtype), sh2, sc2)
        h = self.ffn_down(F.gelu(self.ffn_up(h), approximate="tanh"))
        return x + g2 * h, new_state


def _run_block(block, *args):
    """``block(*args)`` and the probe its self-attention kept, taken off
    the module so that a remat recompute in the backward leaves no graph
    behind (the recompute runs to the end: no early stop): (x, new state,
    probe)."""
    x, st = block(*args)
    return x, st, vars(block.self_attn).pop("probe", {})


class WanModel(nn.Module):
    """Wan2.x-family DiT backbone.

    ``forward(latents, t, text, skip_states, threshold, image_ctx,
    latent_cond)`` with latents ``[B, F, H, W, C]``, timesteps ``t``
    ``[B]``, text ``[B, L, text_dim]``, optional per-layer skip states
    ``{layer: SkipMaskState}``, and for I2V CLIP tokens ``image_ctx``
    ``[B, L_img, image_dim]`` and conditioning channels ``latent_cond``
    ``[B, F, H, W, C_cond]`` (``C + C_cond == cfg.in_channels``). Returns
    (velocity prediction ``[B, F, H, W, C_out]``, new skip states or
    None). ``image_dim`` builds the image projection ``img_proj``; it is
    required with ``cfg.i2v_decoupled``. Parameters go on ``device``
    (default ``cuda``). With ``cfg.sp_axis``, ``mesh`` is the
    ``DeviceMesh`` whose dim of that name splits the self-attention keys
    (the skip states then hold each rank's mask shard:
    :func:`init_skip_states` with ``mesh``).

    With ``cfg.attn_probe_rows`` a forward leaves ``self.intermediates``:
    ``{"attn_entropy": [...], "attn_tile_excess": [...]}``, one 0-d tensor
    per block whose self-attention ran dense (what JAX sows into its
    ``intermediates`` collection).
    """

    def __init__(self, cfg: WanConfig, device=None, image_dim: Optional[int] = None,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        if cfg.sp_axis and mesh is None:
            raise ValueError("WanModel: cfg.sp_axis needs the DeviceMesh (mesh=) whose dim "
                             f"{cfg.sp_axis!r} splits the keys")
        self.mesh = mesh if cfg.sp_axis else None
        sp_group = mesh.get_group(cfg.sp_axis) if cfg.sp_axis else None
        if cfg.i2v_decoupled and image_dim is None:
            raise ValueError("WanModel: cfg.i2v_decoupled needs image_dim (the image token width)")
        self.cfg = cfg
        pt, ph, pw = cfg.patch_size
        f32 = dict(dtype=torch.float32, device=device)
        self.patch_embed = _dense(pt * ph * pw * cfg.in_channels, cfg.dim, cfg.dtype, device)
        self.text_proj = CtxProj(cfg.text_dim, cfg.dim, cfg.dtype, device)
        if image_dim is not None:
            self.img_proj = ImgProj(image_dim, cfg.dim, cfg.dtype, device)
        self.time_mlp_1 = nn.Linear(cfg.freq_dim, cfg.dim, **f32)
        self.time_mlp_2 = nn.Linear(cfg.dim, cfg.dim, **f32)
        self.time_mod = nn.Linear(cfg.dim, 6 * cfg.dim, **f32)
        self.blocks = nn.ModuleList(
            WanBlock(cfg, device, sp_group) for _ in range(cfg.num_layers)
        )
        self.final_mod_bias = nn.Parameter(torch.zeros(2, cfg.dim, device=device))
        self.proj_out = _dense(cfg.dim, pt * ph * pw * cfg.out_channels, cfg.dtype, device)

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
        cfg = self.cfg
        if latent_cond is not None:
            latents = torch.cat([latents, latent_cond.to(latents.dtype)], dim=-1)
        b, f, hh, ww, c = latents.shape
        if c != cfg.in_channels:
            raise ValueError(
                f"WanModel: latents carry {c} channels (noise plus latent_cond) but "
                f"cfg.in_channels is {cfg.in_channels}, the patch embedding's input width"
            )
        pt, ph, pw = cfg.patch_size
        gf, gh, gw = f // pt, hh // ph, ww // pw

        # Patchify: [B, F, H, W, C] -> [B, N, dim].
        x = latents.reshape(b, gf, pt, gh, ph, gw, pw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, gf * gh * gw, pt * ph * pw * c)
        x = self.patch_embed(x.to(cfg.dtype))
        ctx = self.text_proj(text)
        ctx_img = None
        if image_ctx is not None:
            if not hasattr(self, "img_proj"):
                raise ValueError("WanModel: image_ctx needs a model built with image_dim")
            img = self.img_proj(image_ctx)
            if cfg.i2v_decoupled:
                ctx_img = img
            else:
                ctx = torch.cat([img, ctx], dim=1)
        elif cfg.i2v_decoupled:
            raise ValueError("cfg.i2v_decoupled=True requires image_ctx")

        te = timestep_embedding(t, cfg.freq_dim)
        te = self.time_mlp_2(F.silu(self.time_mlp_1(te)))
        t_mod = self.time_mod(F.silu(te)).reshape(b, 6, cfg.dim)

        freqs = rope_3d_freqs((gf, gh, gw), cfg.head_dim, device=latents.device)
        new_states: Dict[int, Any] = {}
        # Only a pass that builds a graph has activations to drop.
        remat = cfg.remat and torch.is_grad_enabled()
        probes = []
        for i, block in enumerate(self.blocks):
            st = skip_states.get(i) if skip_states is not None else None
            sched = schedules.get(i) if schedules is not None else None
            args = (x, ctx, t_mod, freqs, st, threshold, emit_votes, sched, ctx_img)
            if remat:
                with set_checkpoint_early_stop(False):
                    x, st_new, probe = checkpoint(_run_block, block, *args, use_reentrant=False)
            else:
                x, st_new, probe = _run_block(block, *args)
            probes.append(probe)
            if st_new is not None:
                new_states[i] = st_new
        if cfg.attn_probe_rows > 0:
            self.intermediates = {
                name: [p[name] for p in probes if name in p]
                for name in ("attn_entropy", "attn_tile_excess")
            }

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
    cfg: WanConfig, batch: int, grid: Tuple[int, int, int], device=None, mesh=None
) -> Dict[int, Any]:
    """Per-layer skip-mask states for a latent grid (one persistent
    LiteAttention state per block), on ``device`` (default ``cuda``).

    With ``cfg.sp_axis`` and ``mesh``, each state is this rank's mask
    shard: the k-tiles of its contiguous shard of the tokens, tiled from
    the shard's first token, ``[B, H, Qt, cdiv(N / n, 128)]``. (JAX puts
    the whole mask's k-tile axis on the mesh, which needs ``cdiv(N, 128)``
    divisible by ``n``; the shards are the same wherever it is.)"""
    n = (
        (grid[0] // cfg.patch_size[0])
        * (grid[1] // cfg.patch_size[1])
        * (grid[2] // cfg.patch_size[2])
    )
    if cfg.sp_axis is not None and mesh is not None:
        ranks = mesh.get_group(cfg.sp_axis).size()
        if n % ranks:
            raise ValueError(f"init_skip_states: {n} tokens do not split evenly over the "
                             f"{ranks} sequence-parallel ranks")
        return {
            i: init_mask(batch, cfg.num_heads, n, n // ranks, VOTE_TILE, VOTE_TILE,
                         device=device)
            for i in range(cfg.num_layers)
        }
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
