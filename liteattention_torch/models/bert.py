"""BERT-family encoder on the flash kernels.

Counterpart of ``liteattention_tpu/models/bert.py`` (``BertConfig``,
``BertModel``, ``BertForPreTraining``): word, position and token-type
embeddings, a post-norm encoder and the pooler, then the MLM head (tied to
the word embeddings) and the NSP head. Right-padded batches ride B1's
per-batch key bound: ``seqlens = attention_mask.sum(-1)`` becomes
``kv_bound``, so each row attends only its own sequence's keys and a valid
row equals the sequence run alone; no unpad / repad round trip. Parameters
are fp32 and every product runs in ``cfg.dtype``; gelu is the tanh
approximation, as in JAX. It trains: the gradient runs B7 with the same
bound (``flash_bwd.bound_launches``), so the padded keys get exactly 0
and each sequence's gradient is the one it has alone; JAX has no BERT
loss, so the MLM + NSP loss is the caller's. The module names are
the Flax tree's, so JAX parameters load through
:func:`~liteattention_torch.models.convert.state_dict_from_flax`
(``layer_i`` -> ``layers.i``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from liteattention_torch.device import resolve_device
from liteattention_torch.modules.dense import Dense
from liteattention_torch.ops.activations import gelu_approx
from liteattention_torch.ops.flash_fwd import flash_attention_masked
from liteattention_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX ``BertConfig``'s fields but ``block_sizes``, a tiling knob of
    the JAX kernel (B1 runs 128 x 128)."""

    vocab_size: int = 30522
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    eps: float = 1e-12
    dtype: Any = torch.bfloat16

    @staticmethod
    def tiny():
        return BertConfig(
            vocab_size=256, dim=64, num_layers=2, num_heads=2, ffn_dim=128,
            max_position_embeddings=128,
        )


class LayerNorm(nn.Module):
    """fp32 scale and bias; statistics in fp32, output in the input's dtype."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.Wqkv = Dense(cfg.dim, 3 * cfg.dim, True, cfg.dtype, device)
        self.out = Dense(cfg.dim, cfg.dim, True, cfg.dtype, device)

    def forward(self, x, seqlens):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (
            t.reshape(b, s, cfg.num_heads, -1).transpose(1, 2)
            for t in self.Wqkv(x).chunk(3, dim=-1)
        )
        out = flash_attention_masked(q, k, v, kv_bound=seqlens)
        return self.out(out.transpose(1, 2).reshape(b, s, cfg.dim))


class BertLayer(nn.Module):
    """Post-norm encoder layer: ``norm1(x + attn(x))``, then ``norm2(x +
    mlp(x))``."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.attention = BertSelfAttention(cfg, device)
        self.norm1 = LayerNorm(cfg.dim, cfg.eps, device)
        self.ffn_up = Dense(cfg.dim, cfg.ffn_dim, True, cfg.dtype, device)
        self.ffn_down = Dense(cfg.ffn_dim, cfg.dim, True, cfg.dtype, device)
        self.norm2 = LayerNorm(cfg.dim, cfg.eps, device)

    def forward(self, x, seqlens):
        x = self.norm1(x + self.attention(x, seqlens))
        return self.norm2(x + self.ffn_down(gelu_approx(self.ffn_up(x))))


class BertModel(nn.Module):
    """Embeddings + encoder + pooler; ``forward(input_ids, attention_mask,
    token_type_ids)`` -> (hidden ``[B, S, dim]``, pooled ``[B, dim]``) in
    ``cfg.dtype``. ``attention_mask`` ``[B, S]`` marks each row's valid
    prefix (right padding); None means every token is valid."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, **f32)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim, **f32)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.dim, **f32)
        self.emb_norm = LayerNorm(cfg.dim, cfg.eps, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device) for _ in range(cfg.num_layers))
        self.pooler = Dense(cfg.dim, cfg.dim, True, cfg.dtype, device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is not None:
            seqlens = attention_mask.to(torch.int32).sum(-1, dtype=torch.int32)
        else:
            seqlens = torch.full((b,), s, dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = F.embedding(input_ids, self.word_embeddings.weight).to(cfg.dtype)
        pos = torch.arange(s, device=dev)
        x = x + F.embedding(pos, self.position_embeddings.weight).to(cfg.dtype)[None]
        x = x + F.embedding(token_type_ids, self.token_type_embeddings.weight).to(cfg.dtype)
        x = self.emb_norm(x)
        for layer in self.layers:
            x = layer(x, seqlens)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForPreTraining(nn.Module):
    """``BertModel`` as ``bert`` + the MLM head (dense, tanh-gelu, norm,
    then the tied word embeddings) and the NSP head; ``forward`` ->
    (MLM logits ``[B, S, vocab]``, NSP logits ``[B, 2]``), fp32."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device)
        self.mlm_transform = Dense(cfg.dim, cfg.dim, True, cfg.dtype, device)
        self.mlm_norm = LayerNorm(cfg.dim, cfg.eps, device)
        self.nsp = Dense(cfg.dim, 2, True, cfg.dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: ``N(0, 1/fan_in)`` for Dense
        kernels and embedding tables (the row width), zero biases, unit
        norm scales (``GPTLMHeadModel.reset_parameters``'s rule)."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, 1.0 / p.shape[1] ** 0.5, generator=generator)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        hidden, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        h = self.mlm_norm(gelu_approx(self.mlm_transform(hidden)))
        wte = self.bert.word_embeddings.weight
        mlm_logits = (h @ wte.T.to(h.dtype)).float()
        return mlm_logits, self.nsp(pooled).float()


__all__ = ["BertConfig", "BertModel", "BertForPreTraining"]
