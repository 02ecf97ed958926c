"""Autoregressive decoding: sampling, greedy / sampled decode with a KV
cache, int8 cache quantization and speculative decoding.

Counterpart of ``liteattention_tpu/utils/generation.py``. The model is
any callable ``model(input_ids, inference_params) -> logits [B, S, V]``
(a :class:`~liteattention_torch.models.gpt.GPTLMHeadModel`); its
parameters live in the module, so the JAX ``params`` arguments go. JAX
``rng`` keys become ``torch.Generator``s (the two draw different numbers
from one seed). The loop runs eagerly under ``torch.inference_mode()``:
one prefill, then single-token steps against a fixed-capacity cache
whose new rows are written in place (CUDA graphs are later work).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from liteattention_torch.modules.mha import InferenceParams
from liteattention_torch.ops.kv_quant import quantize_kv_cache_native


def _filter_logits(lf: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Top-k, then top-p filtering of fp32 logits ``[..., V]`` (the
    dropped entries become -inf)."""
    if top_k > 0:
        kth = torch.sort(lf, dim=-1).values[..., -top_k, None]
        lf = torch.where(lf < kth, -torch.inf, lf)
    if top_p > 0.0:
        sorted_lf = torch.sort(lf, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lf, dim=-1)
        inside = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(inside, sorted_lf, torch.inf).amin(dim=-1, keepdim=True)
        lf = torch.where(lf < cutoff, -torch.inf, lf)
    return lf


def _categorical(lf: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    """One draw per row of the logits ``[..., V]`` (-inf = excluded)."""
    probs = torch.softmax(lf, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=rng).reshape(probs.shape[:-1])


def sample_token(
    logits: torch.Tensor,
    rng: Optional[torch.Generator],
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    """Next tokens from ``[B, V]`` logits: greedy when ``rng`` is None or
    ``temperature`` is 0; else logits / temperature, top-k, then top-p on
    the scaled logits (the order :func:`sample_speculative` scores)."""
    if rng is None or temperature == 0.0:
        return logits.argmax(dim=-1)
    return _categorical(_filter_logits(logits.float() / temperature, top_k, top_p), rng)


def sample_speculative(
    logits: torch.Tensor,
    logits_draft: torch.Tensor,
    tokens_draft: torch.Tensor,
    rng: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
):
    """Speculative rejection sampling (Algorithm 1 of arXiv:2211.17192).

    ``logits [B, S+1, V]`` are the main model's distributions at the S
    draft positions and the bonus position; ``logits_draft [B, S, V]``
    those each draft token was drawn from. Returns ``(tokens [B, S+1],
    num_generated [B])``: the accepted draft prefix, then one token from
    the residual ``max(p - q, 0)`` (or the bonus on full acceptance).
    Greedy mode (no ``rng`` or temperature 0) is exact prefix matching
    against the main argmax."""
    b, sp1, _ = logits.shape
    s = sp1 - 1
    if logits_draft.shape[:2] != (b, s) or tokens_draft.shape != (b, s):
        raise ValueError("draft logits / tokens must be [B, S, V] / [B, S]")
    dev = logits.device
    if rng is None or temperature == 0.0:
        main_tok = logits.argmax(dim=-1)
        accepted = tokens_draft == main_tok[:, :-1]
        first_rej = torch.where(
            accepted.all(dim=-1), s, accepted.int().argmin(dim=-1)
        )
        resample = main_tok.gather(1, first_rej[:, None])[:, 0]
    else:
        probs = torch.softmax(_filter_logits(logits.float() / temperature, top_k, top_p), -1)
        probs_draft = torch.softmax(
            _filter_logits(logits_draft.float() / temperature, top_k, top_p), -1
        )
        u = torch.rand((b, s), generator=rng, device=dev)
        idx = tokens_draft.long()[..., None]
        p_main = probs[:, :-1].gather(-1, idx)[..., 0]
        p_draft = probs_draft.gather(-1, idx)[..., 0]
        accepted = u * p_draft <= p_main
        first_rej = torch.where(
            accepted.all(dim=-1), s, accepted.int().argmin(dim=-1)
        )
        residual = (probs[:, :-1] - probs_draft).clamp_min(0.0)
        resample_probs = torch.cat([residual, probs[:, -1:]], dim=1)
        pick = first_rej[:, None, None].expand(b, 1, probs.shape[-1])
        row = resample_probs.gather(1, pick)[:, 0]
        # Identical p and q leave an empty residual: fall back to p.
        p_row = probs.gather(1, pick)[:, 0]
        row = torch.where(row.sum(-1, keepdim=True) > 1e-9, row, p_row)
        logp = torch.where(row > 0, torch.log(row.clamp_min(1e-37)), -torch.inf)
        resample = _categorical(logp, rng)
    tokens = torch.cat([tokens_draft, torch.zeros_like(tokens_draft[:, :1])], dim=1)
    at = torch.arange(sp1, device=dev)[None] == first_rej[:, None]
    tokens = torch.where(at, resample[:, None].to(tokens.dtype), tokens)
    return tokens, first_rej + 1


def quantize_inference_cache(inference_params: InferenceParams) -> None:
    """int8-quantize every layer's decode cache (after prefill): per
    (batch, head, channel) scales over the prefill region (the zeroed
    capacity beyond it never raises the absmax). Later single-token MHA
    steps append with the frozen scales and stream half the bytes."""
    cache = inference_params.key_value_memory_dict
    for layer, entry in cache.items():
        if len(entry) == 2:
            cache[layer] = tuple(quantize_kv_cache_native(*entry))


@torch.inference_mode()
def greedy_decode(
    model: Callable,
    input_ids: torch.Tensor,
    max_new_tokens: int,
    max_seqlen: int,
    rng: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    eos_token_id: Optional[int] = None,
    quantize_cache: bool = False,
):
    """Prefill, then single-token steps with a persistent KV cache.

    ``model(ids, inference_params) -> logits``. Greedy unless ``rng`` and
    a temperature are given. ``quantize_cache=True`` int8-quantizes the
    cache once after prefill (:func:`quantize_inference_cache`).
    Returns the tokens ``[B, prompt + new]``.
    """
    b, prompt_len = input_ids.shape
    inference_params = InferenceParams(max_seqlen=max_seqlen, max_batch_size=b)
    logits = model(input_ids, inference_params)
    inference_params.seqlen_offset = prompt_len
    if quantize_cache:
        quantize_inference_cache(inference_params)
    tokens = [input_ids]
    finished = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    next_tok = sample_token(logits[:, -1], rng, temperature, top_k, top_p)
    del logits
    for i in range(max_new_tokens):
        tokens.append(next_tok[:, None])
        if eos_token_id is not None:
            finished |= next_tok == eos_token_id
        if i == max_new_tokens - 1 or (eos_token_id is not None and bool(finished.all())):
            break
        logits = model(next_tok[:, None], inference_params)
        inference_params.seqlen_offset += 1
        next_tok = sample_token(logits[:, -1], rng, temperature, top_k, top_p)
    return torch.cat(tokens, dim=1)


@torch.inference_mode()
def decode_speculative(
    model: Callable,
    model_draft: Callable,
    input_ids: torch.Tensor,
    max_new_tokens: int,
    max_seqlen: int,
    speculative_lookahead: int = 3,
    rng: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    return_stats: bool = False,
):
    """Speculative decoding with a draft model, batch size 1.

    Each round the draft proposes ``speculative_lookahead`` tokens in
    single-token steps against its own cache; the main model scores them
    and the bonus position in one multi-token step; and
    :func:`sample_speculative` accepts a prefix. Rejected rows roll back
    by moving ``seqlen_offset``: both caches have a fixed capacity and the
    stale rows are overwritten before they are attended. The draft's
    first step of a round takes 1 token (the last accepted) or, after a
    fully accepted round, 2 (the draft token it never ingested and the
    bonus). In greedy mode the output equals :func:`greedy_decode` of the
    main model token for token, whatever the draft.

    ``return_stats=True`` also returns ``{"accepted_per_round": [...],
    "rounds": N}``.
    """
    b, prompt_len = input_ids.shape
    if b != 1:
        raise ValueError("speculative decoding takes batch size 1")
    if max_new_tokens <= 0:
        stats = {"accepted_per_round": [], "rounds": 0}
        return (input_ids, stats) if return_stats else input_ids
    lookahead = max(1, speculative_lookahead)
    inf_main = InferenceParams(max_seqlen=max_seqlen, max_batch_size=b)
    inf_draft = InferenceParams(max_seqlen=max_seqlen, max_batch_size=b)
    logits = model(input_ids, inf_main)
    inf_main.seqlen_offset = prompt_len
    model_draft(input_ids, inf_draft)
    inf_draft.seqlen_offset = prompt_len

    last = sample_token(logits[:, -1], rng, temperature, top_k, top_p)
    out = [input_ids, last[:, None]]
    n_done = 1
    hist = prompt_len  # tokens strictly before `last`, cached in main
    pending = None  # the draft-unseen token before `last` (full accept)
    accepted_per_round = []
    while n_done < max_new_tokens:
        n_look = min(lookahead, max_new_tokens - n_done)
        x = last[:, None] if pending is None else torch.stack([pending, last], dim=1)
        d_tokens, d_logits = [], []
        for _ in range(n_look):
            lg = model_draft(x, inf_draft)
            inf_draft.seqlen_offset += x.shape[1]
            d_logits.append(lg[:, -1])
            tok = sample_token(lg[:, -1], rng, temperature, top_k, top_p)
            d_tokens.append(tok)
            x = tok[:, None]
        tokens_draft = torch.stack(d_tokens, dim=1)
        logits_draft = torch.stack(d_logits, dim=1)
        lg_main = model(torch.cat([last[:, None], tokens_draft], dim=1), inf_main)
        inf_main.seqlen_offset += n_look + 1
        toks, n_acc = sample_speculative(
            lg_main, logits_draft, tokens_draft, rng, temperature, top_k, top_p
        )
        n = min(int(n_acc[0]), max_new_tokens - n_done)
        out.append(toks[:, :n])
        last = toks[:, n - 1]
        accepted_per_round.append(n)
        n_done += n
        hist += n
        inf_main.seqlen_offset = hist
        if n == n_look + 1:
            pending = tokens_draft[:, n_look - 1]
        else:
            pending = None
            inf_draft.seqlen_offset = hist
    seq = torch.cat(out, dim=1)
    if return_stats:
        return seq, {"accepted_per_round": accepted_per_round,
                     "rounds": len(accepted_per_round)}
    return seq


__all__ = [
    "greedy_decode",
    "sample_token",
    "sample_speculative",
    "decode_speculative",
    "InferenceParams",
    "quantize_inference_cache",
]
