"""GPT-family causal transformer on the flash kernels.

Counterpart of ``liteattention_tpu/models/gpt.py`` (``GPTConfig``,
``GPTModel``, ``GPTLMHeadModel``, ``gpt_loss_fn``). One configurable
backbone: learned positions, GQA, plain or gated MLP, pre-norm with an
fp32 residual stream, post-norm (OPT-350m, with projected embeddings),
the parallel block (GPT-J/NeoX), RMSNorm, tied or untied LM head, ALiBi
positions (Baichuan-13B, BTLM: B1's ALiBi channel forward, B7's backward,
so they train through :func:`gpt_loss_fn` and ``training/trainer.py``;
BTLM's head dim 80 runs on the card too, through B1's and B7's D-80
instantiations; GPT-J's 256 through B1's, B7's and the decode kernel's
D-256 ones).
Parameters are fp32 and every product runs in ``cfg.dtype``; the
embedding is looked up in ``cfg.dtype``, the tied head computes
``hidden @ wte.T`` in ``cfg.dtype`` and the logits come back fp32, as in
the JAX model. Rotary positions (LLaMA, GPT-J, NeoX, Falcon) rotate q
and k inside ``MHA``. Every training attention call is causal B1 forward
and B7 backward.

Decoding: ``forward(input_ids, inference_params)`` threads an
:class:`~liteattention_torch.modules.mha.InferenceParams` cache through
the blocks (learned positions and rotary start at its
``seqlen_offset``); ``GPTLMHeadModel.generate`` runs
:func:`~liteattention_torch.utils.generation.greedy_decode`, whose
single-token steps go through the decode kernel B8 (with ALiBi, as every
multi-token step, through B1 over the cache with a per-batch bound).

Dropout: ``GPTConfig.dropout`` is JAX's attention and residual dropout
(``MHA(dropout=)``, ``Block(resid_dropout1=, resid_dropout2=)``; no
embedding dropout, as in JAX). It runs in ``forward(input_ids,
deterministic=False, generator=g)``, every mask drawn from the
``torch.Generator`` ``g`` on the model's device; the attention's through
B1's and B7's dropout instantiations. ``deterministic`` defaults to True,
as in JAX, and ``gpt_loss_fn`` (so the trainer and the CLI) stays
deterministic, as JAX's does. With ``remat`` each block's recompute
replays the block's draws.

Not ported yet (the model raises on it): MoE; the tensor-parallel forward
is left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from liteattention_torch.device import resolve_device
from liteattention_torch.losses.cross_entropy import cross_entropy_loss
from liteattention_torch.models.convert import state_dict_from_flax
from liteattention_torch.modules.block import Block
from liteattention_torch.modules.dense import Dense
from liteattention_torch.modules.mha import MHA, InferenceParams
from liteattention_torch.modules.mlp import GatedMlp, Mlp
from liteattention_torch.ops.activations import gelu_approx
from liteattention_torch.ops.norms import layer_norm, rms_norm


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Geometry knobs of the GPT family (the JAX ``GPTConfig``'s fields)."""

    vocab_size: int = 50304
    max_position_embeddings: int = 2048  # 0 = rotary only
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_heads_kv: Optional[int] = None
    ffn_dim: Optional[int] = None
    rotary_emb_dim: int = 0
    rotary_emb_base: float = 10000.0
    rotary_emb_interleaved: bool = False
    mlp_relu: bool = False
    word_embed_proj_dim: Optional[int] = None
    prenorm: bool = True
    lm_head_bias: bool = False
    gated_mlp: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    parallel_block: bool = False
    parallel_block_tied_norm: bool = True
    attn_bias: bool = True
    mlp_bias: bool = True
    mlp_gelu_exact: bool = False
    use_rms_norm: bool = False
    use_alibi: bool = False
    embeddings_multiplier: float = 1.0
    logits_multiplier: float = 1.0
    scale_qk_dot_by_d: bool = False
    tie_embeddings: bool = True
    dropout: float = 0.0
    eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # Recompute each block's activations in the backward
    # (torch.utils.checkpoint) instead of storing them.
    remat: bool = False

    @staticmethod
    def llama(dim=512, num_layers=4, num_heads=8, vocab=32000):
        return GPTConfig(
            vocab_size=vocab, max_position_embeddings=0, dim=dim,
            num_layers=num_layers, num_heads=num_heads,
            ffn_dim=int(dim * 8 / 3) // 64 * 64, rotary_emb_dim=dim // num_heads,
            gated_mlp=True, use_rms_norm=True, tie_embeddings=False,
        )

    @staticmethod
    def tiny():
        return GPTConfig(
            vocab_size=512, max_position_embeddings=256, dim=128,
            num_layers=2, num_heads=2,
        )


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError("GPT: ['moe_experts'] not ported yet")


def _block(cfg: GPTConfig, layer_idx: int, device) -> Block:
    head_dim = cfg.dim // cfg.num_heads
    mha = MHA(
        cfg.dim, cfg.num_heads, num_heads_kv=cfg.num_heads_kv, causal=True,
        qkv_proj_bias=cfg.attn_bias, out_proj_bias=cfg.attn_bias,
        softmax_scale=1.0 / head_dim if cfg.scale_qk_dot_by_d else None,
        rotary_emb_dim=cfg.rotary_emb_dim, rotary_emb_base=cfg.rotary_emb_base,
        rotary_emb_interleaved=cfg.rotary_emb_interleaved, use_alibi=cfg.use_alibi,
        dropout=cfg.dropout, layer_idx=layer_idx, dtype=cfg.dtype, device=device,
    )
    ffn = cfg.ffn_dim or 4 * cfg.dim
    if cfg.gated_mlp:
        mlp = GatedMlp(cfg.dim, ffn, bias1=cfg.mlp_bias, bias2=cfg.mlp_bias,
                       dtype=cfg.dtype, device=device)
    else:
        if cfg.mlp_relu:
            act = F.relu
        elif cfg.mlp_gelu_exact:
            act = F.gelu
        else:
            act = gelu_approx
        mlp = Mlp(cfg.dim, ffn, activation=act, bias1=cfg.mlp_bias,
                  bias2=cfg.mlp_bias, dtype=cfg.dtype, device=device)
    return Block(
        cfg.dim, mha, mlp, prenorm=cfg.prenorm, parallel_block=cfg.parallel_block,
        parallel_block_tied_norm=cfg.parallel_block_tied_norm,
        resid_dropout1=cfg.dropout, resid_dropout2=cfg.dropout,
        use_rms_norm=cfg.use_rms_norm, residual_in_fp32=True, eps=cfg.eps,
        dtype=cfg.dtype, device=device,
    )


def _replaying(blk: nn.Module, generator: torch.Generator):
    """``blk`` for ``torch.utils.checkpoint`` with dropout: checkpoint
    restores the default generators' state for the recompute, not an
    explicit one's. So the recompute runs ``generator`` from the state the
    first call began at (it draws the same masks and seeds) and then puts
    back the state it found."""
    start, ran = generator.get_state(), []

    def run(*args, **kwargs):
        if not ran:
            ran.append(True)
            return blk(*args, **kwargs)
        now = generator.get_state()
        generator.set_state(start)
        try:  # checkpoint may stop the recompute early by raising inside blk
            return blk(*args, **kwargs)
        finally:
            generator.set_state(now)

    return run


class GPTModel(nn.Module):
    """Embedding + block stack + final norm; ``forward(input_ids)`` ->
    hidden ``[B, S, dim]`` in ``cfg.dtype``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.word_embed_proj_dim or cfg.dim, **f32)
        if cfg.word_embed_proj_dim:
            self.project_in = Dense(cfg.word_embed_proj_dim, cfg.dim, False, cfg.dtype, device)
        if cfg.max_position_embeddings:
            self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.dim, **f32)
        self.blocks = nn.ModuleList(_block(cfg, i, device) for i in range(cfg.num_layers))
        if cfg.prenorm:  # the post-norm stack ends normalized already
            self.ln_f_scale = nn.Parameter(torch.ones(cfg.dim, device=device))
            if not cfg.use_rms_norm:
                self.ln_f_bias = nn.Parameter(torch.zeros(cfg.dim, device=device))

    def forward(self, input_ids: torch.Tensor,
                inference_params: Optional[InferenceParams] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        drop = cfg.dropout > 0.0 and not deterministic and inference_params is None
        if drop and generator is None:
            raise ValueError("GPT: dropout (deterministic=False) requires a torch.Generator "
                             "(generator=)")
        x = F.embedding(input_ids, self.wte.weight).to(cfg.dtype)
        if cfg.embeddings_multiplier != 1.0:
            x = x * cfg.embeddings_multiplier
        if cfg.word_embed_proj_dim:
            x = self.project_in(x)
        if cfg.max_position_embeddings:
            offset = inference_params.seqlen_offset if inference_params is not None else 0
            pos = torch.arange(offset, offset + input_ids.shape[1], device=input_ids.device)
            x = x + F.embedding(pos, self.wpe.weight).to(cfg.dtype)[None]
        residual = None
        kw = {} if inference_params is None else {"inference_params": inference_params}
        if drop:
            kw = dict(deterministic=False, generator=generator)
        for blk in self.blocks:
            if cfg.remat and torch.is_grad_enabled() and inference_params is None:
                out = checkpoint(_replaying(blk, generator) if drop else blk, x, residual,
                                 use_reentrant=False, **kw)
            else:
                out = blk(x, residual, **kw)
            x, residual = out if cfg.prenorm else (out, None)
        if not cfg.prenorm:
            return x
        final = (x.float() + residual).to(cfg.dtype)
        if cfg.use_rms_norm:
            return rms_norm(final, self.ln_f_scale, eps=cfg.eps)
        return layer_norm(final, self.ln_f_scale, self.ln_f_bias, eps=cfg.eps)


class GPTLMHeadModel(nn.Module):
    """``GPTModel`` + LM head; ``forward(input_ids)`` -> fp32 logits
    ``[B, S, vocab]``. Parameters go on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.transformer = GPTModel(cfg, device)
        if cfg.word_embed_proj_dim:
            self.project_out = Dense(cfg.dim, cfg.word_embed_proj_dim, False, cfg.dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.dim, cfg.vocab_size, cfg.lm_head_bias, cfg.dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``, the JAX model's initializers
        up to truncation: ``N(0, 1/fan_in)`` for Dense kernels and
        embedding tables (fan_in = the row width either way), zero biases,
        unit norm scales."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, input_ids: torch.Tensor,
                inference_params: Optional[InferenceParams] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """fp32 logits; ``deterministic=False`` turns on the config's
        dropout, drawn from ``generator`` (a ``torch.Generator`` on the
        model's device, required then), as JAX's ``apply(...,
        deterministic=False, rngs={"dropout": key})``."""
        cfg = self.cfg
        hidden = self.transformer(input_ids, inference_params, deterministic, generator)
        if cfg.word_embed_proj_dim:
            hidden = self.project_out(hidden)
        if cfg.tie_embeddings:
            logits = hidden @ self.transformer.wte.weight.to(hidden.dtype).T
        else:
            logits = self.lm_head(hidden)
        if cfg.logits_multiplier != 1.0:
            logits = logits * cfg.logits_multiplier
        return logits.float()

    def generate(
        self,
        input_ids: torch.Tensor,
        max_length: int,
        top_k: int = 1,
        top_p: float = 0.0,
        temperature: float = 1.0,
        rng: Optional[torch.Generator] = None,
        eos_token_id: Optional[int] = None,
        **kwargs,
    ) -> torch.Tensor:
        """KV-cached decoding up to ``max_length`` total tokens (JAX
        ``GPTLMHeadModel.generate``): ``top_k=1`` (the default) is greedy;
        pass ``rng`` with temperature / top_k / top_p to sample."""
        from liteattention_torch.utils.generation import greedy_decode

        greedy = rng is None or temperature == 0.0 or top_k == 1
        return greedy_decode(
            self, input_ids, max_new_tokens=max_length - input_ids.shape[1],
            max_seqlen=max_length, rng=None if greedy else rng,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, **kwargs,
        )


def gpt_loss_fn(model: GPTLMHeadModel, input_ids: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy: logits at position i predict label i+1."""
    logits = model(input_ids)
    return cross_entropy_loss(logits[:, :-1], labels[:, 1:])


def gpt_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """Flax ``GPTLMHeadModel`` params -> this module's ``state_dict``
    (``transformer/wte/embedding`` -> ``transformer.wte.weight``,
    ``block_i/mha/Wqkv/kernel`` -> ``blocks.i.mha.Wqkv.weight``
    transposed, ``norm1_scale`` and ``ln_f_bias`` as they are; see
    :func:`~liteattention_torch.models.convert.state_dict_from_flax`)."""
    return state_dict_from_flax(params)


__all__ = [
    "GPTConfig",
    "GPTModel",
    "GPTLMHeadModel",
    "gpt_loss_fn",
    "gpt_state_dict_from_jax",
]
