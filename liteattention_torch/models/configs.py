"""Model-family configs on the GPT backbone.

Counterpart of ``liteattention_tpu/models/configs.py``: each constructor
encodes one family's geometry as a :class:`GPTConfig`. They are only
data; the model raises on the features it does not take yet (rotary
positions for GPT-J, NeoX, Falcon, LLaMA, Baichuan-7B; ALiBi for
Baichuan-13B and BTLM).
"""

from __future__ import annotations

from liteattention_torch.models.gpt import GPTConfig


def gpt2_config(dim=768, num_layers=12, num_heads=12, vocab=50257,
                max_pos=1024) -> GPTConfig:
    """GPT-2 (reference models/gpt.py GPT2 path)."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=max_pos, dim=dim,
        num_layers=num_layers, num_heads=num_heads, tie_embeddings=True,
    )


def opt_config(dim=768, num_layers=12, num_heads=12, vocab=50272,
               max_pos=2048, word_embed_proj_dim=None,
               prenorm=True) -> GPTConfig:
    """OPT (reference models/opt.py): learned positions, ReLU-family MLP
    geometry, tied embeddings. The 350m layout sets
    ``word_embed_proj_dim`` (projected embeddings) and
    ``prenorm=False`` (do_layer_norm_before=False, no final norm) --
    reference opt_config_to_gpt2_config."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=max_pos, dim=dim,
        num_layers=num_layers, num_heads=num_heads, tie_embeddings=True,
        mlp_relu=True, word_embed_proj_dim=word_embed_proj_dim,
        prenorm=prenorm,
    )


def gptj_config(dim=4096, num_layers=28, num_heads=16, vocab=50400,
                rotary_dim=64) -> GPTConfig:
    """GPT-J (reference models/gptj.py): partial INTERLEAVED rotary,
    parallel attention+MLP block with one shared norm, bias-free
    attention projections, biased MLP and lm_head, untied embeddings,
    exact-erf gelu is NOT used (gelu_new/tanh)."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=0, dim=dim,
        num_layers=num_layers, num_heads=num_heads,
        rotary_emb_dim=rotary_dim, rotary_emb_interleaved=True,
        parallel_block=True, parallel_block_tied_norm=True,
        attn_bias=False, mlp_bias=True, lm_head_bias=True,
        tie_embeddings=False,
    )


def gpt_neox_config(dim=6144, num_layers=44, num_heads=64,
                    vocab=50432) -> GPTConfig:
    """GPT-NeoX (reference models/gpt_neox.py): rotary (25% of head dim),
    parallel block."""
    head_dim = dim // num_heads
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=0, dim=dim,
        num_layers=num_layers, num_heads=num_heads,
        rotary_emb_dim=head_dim // 4, parallel_block=True,
        parallel_block_tied_norm=False,  # HF use_parallel_residual
        mlp_gelu_exact=True,
        tie_embeddings=False,
    )


def falcon_config(dim=4544, num_layers=32, num_heads=71,
                  vocab=65024) -> GPTConfig:
    """Falcon (reference models/falcon.py): rotary, MQA (one KV head),
    parallel block."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=0, dim=dim,
        num_layers=num_layers, num_heads=num_heads, num_heads_kv=1,
        rotary_emb_dim=dim // num_heads, parallel_block=True,
        attn_bias=False, mlp_bias=False, mlp_gelu_exact=True,
        tie_embeddings=True,
    )


def llama_config(dim=4096, num_layers=32, num_heads=32, num_heads_kv=None,
                 vocab=32000, ffn_dim=11008) -> GPTConfig:
    """LLaMA 1/2/3 (reference models/llama.py): rotary, RMSNorm, SwiGLU,
    untied embeddings, optional GQA."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=0, dim=dim,
        num_layers=num_layers, num_heads=num_heads,
        num_heads_kv=num_heads_kv, ffn_dim=ffn_dim,
        rotary_emb_dim=dim // num_heads, gated_mlp=True,
        attn_bias=False, mlp_bias=False,
        use_rms_norm=True, tie_embeddings=False,
    )


def bigcode_config(dim=6144, num_layers=40, num_heads=48,
                   vocab=49152, max_pos=8192) -> GPTConfig:
    """StarCoder/bigcode (reference models/bigcode.py): MQA + learned
    positions."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=max_pos, dim=dim,
        num_layers=num_layers, num_heads=num_heads, num_heads_kv=1,
        tie_embeddings=True,
    )


__all__ = [
    "gpt2_config",
    "opt_config",
    "gptj_config",
    "gpt_neox_config",
    "falcon_config",
    "llama_config",
    "bigcode_config",
    "baichuan_config",
    "btlm_config",
]


def baichuan_config(dim=4096, num_layers=32, num_heads=32,
                    vocab=125696) -> GPTConfig:
    """Baichuan (reference models/baichuan.py): LLaMA geometry with
    RMSNorm + SwiGLU; 7B (dim < 5000) uses rotary, 13B uses ALiBi --
    the same hidden-size inference hack as the reference
    (models/baichuan.py:116-143)."""
    use_rotary = dim < 5000
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=0, dim=dim,
        num_layers=num_layers, num_heads=num_heads,
        ffn_dim=int(dim * 8 / 3) // 128 * 128,
        rotary_emb_dim=dim // num_heads if use_rotary else 0,
        use_alibi=not use_rotary, gated_mlp=True, use_rms_norm=True,
        attn_bias=False, mlp_bias=False,
        tie_embeddings=False,
        eps=1e-6,  # HF rms_norm_eps (reference passes it through,
        # models/baichuan.py:134)
    )


def btlm_config(dim=2560, num_layers=32, num_heads=32, vocab=50257,
                mup_width_scale=0.1, mup_embeddings_scale=14.6,
                mup_output_alpha=2.22) -> GPTConfig:
    """BTLM-3B (reference models/btlm.py): ALiBi positions, SwiGLU, muP
    multipliers (embeddings scale, output alpha * width scale on the
    logits, 1/d attention scaling; models/btlm.py:81-100)."""
    return GPTConfig(
        vocab_size=vocab, max_position_embeddings=0, dim=dim,
        num_layers=num_layers, num_heads=num_heads,
        gated_mlp=True, use_alibi=True,
        embeddings_multiplier=mup_embeddings_scale,
        logits_multiplier=mup_output_alpha * mup_width_scale,
        scale_qk_dot_by_d=True, tie_embeddings=True,
        attn_bias=True, mlp_bias=True,
    )
