"""Checkpoint remapping: official Wan2.1/2.2 torch checkpoints -> the
port's ``WanModel`` state dict; HF GPT-2, LLaMA, GPT-NeoX, Falcon, OPT,
GPTBigCode, Baichuan, BTLM and GPT-J checkpoints -> the port's
``GPTLMHeadModel`` state dict.

Counterpart of ``liteattention_tpu/utils/pretrained.py`` (every
``remap_state_dict_*`` and ``state_dict_from_pretrained``): the same
tensors, under the port's keys. The Wan key layout is
Wan-Video/Wan2.1 ``wan/modules/model.py``: ``patch_embedding`` (Conv3d),
``text_embedding.{0,2}``, ``time_embedding.{0,2}``, ``time_projection.1``,
``blocks.N.{self_attn,cross_attn}.{q,k,v,o,norm_q,norm_k}``,
``blocks.N.{norm3,ffn.0,ffn.2,modulation}``, ``head.{head,modulation}``,
(I2V) ``img_emb.proj.{0,1,3,4}`` and (Wan2.1-I2V)
``cross_attn.{k_img,v_img,norm_k_img}``. Torch Linear weights are already
``[out, in]``, as the port's ``nn.Linear`` keeps them; the Conv3d patch
kernel ``[dim, C, pt, ph, pw]`` becomes a Linear over features ordered
(pt, ph, pw, C), the model's patchify order. No checkpoint is fetched:
the caller hands in a state dict, or :func:`state_dict_from_pretrained`
reads a local directory or the local HF cache. Each remap returns the
checkpoint's tensors where they lie, in their dtype (a key that fuses or
reorders several is a new tensor there; an array becomes an fp32 CPU
tensor); ``load_state_dict`` casts them to the model's parameters. A
checkpoint built on the card is remapped there.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    """A checkpoint entry: a torch tensor as it is (its device and dtype,
    detached), an array as an fp32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def remap_state_dict_wan(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Official Wan checkpoint -> ``WanModel(cfg).state_dict()`` keys
    (``load_state_dict`` casts them). A checkpoint with the
    decoupled image K/V (``k_img``) needs ``cfg.i2v_decoupled``, and one
    without needs it off: a mismatch raises ``ValueError``. Build the model
    with ``image_dim`` when the checkpoint has ``img_emb`` keys."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    has_img_kv = any("k_img" in k for k in sd)
    decoupled = bool(getattr(cfg, "i2v_decoupled", False))
    if has_img_kv != decoupled:
        raise ValueError(
            "checkpoint/config mismatch: decoupled image-K/V keys "
            f"{'present' if has_img_kv else 'absent'} but cfg.i2v_decoupled={decoupled}; "
            f"construct WanConfig(i2v_decoupled={has_img_kv}) for this checkpoint"
        )
    out: Dict[str, torch.Tensor] = {}

    def lin(dst, src):
        out[dst + ".weight"] = sd[src + ".weight"]
        if src + ".bias" in sd:
            out[dst + ".bias"] = sd[src + ".bias"]

    def norm(dst, src):
        out[dst + ".weight"] = sd[src + ".weight"]
        out[dst + ".bias"] = sd[src + ".bias"]

    w = sd["patch_embedding.weight"]
    out["patch_embed.weight"] = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1).contiguous()
    out["patch_embed.bias"] = sd["patch_embedding.bias"]
    lin("text_proj.fc1", "text_embedding.0")
    lin("text_proj.fc2", "text_embedding.2")
    lin("time_mlp_1", "time_embedding.0")
    lin("time_mlp_2", "time_embedding.2")
    lin("time_mod", "time_projection.1")
    if "img_emb.proj.0.weight" in sd:
        norm("img_proj.norm_in", "img_emb.proj.0")
        lin("img_proj.fc1", "img_emb.proj.1")
        lin("img_proj.fc2", "img_emb.proj.3")
        norm("img_proj.norm_out", "img_emb.proj.4")

    def attn(dst, src):
        for w in ("q", "k", "v", "o"):
            lin(f"{dst}.{w}", f"{src}.{w}")
        if src + ".norm_q.weight" in sd:
            out[dst + ".q_norm.weight"] = sd[src + ".norm_q.weight"]
            out[dst + ".k_norm.weight"] = sd[src + ".norm_k.weight"]
        if src + ".k_img.weight" in sd:
            lin(dst + ".k_img", src + ".k_img")
            lin(dst + ".v_img", src + ".v_img")
            if src + ".norm_k_img.weight" in sd:
                out[dst + ".k_img_norm.weight"] = sd[src + ".norm_k_img.weight"]

    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        out[pre + ".mod_bias"] = sd[pre + ".modulation"].reshape(6, -1)
        attn(pre + ".self_attn", pre + ".self_attn")
        attn(pre + ".cross_attn", pre + ".cross_attn")
        norm(pre + ".norm3", pre + ".norm3")
        lin(pre + ".ffn_up", pre + ".ffn.0")
        lin(pre + ".ffn_down", pre + ".ffn.2")
    lin("proj_out", "head.head")
    out["final_mod_bias"] = sd["head.modulation"].reshape(2, -1)
    return out


def remap_state_dict_hf_baichuan(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF Baichuan checkpoint -> ``GPTLMHeadModel(cfg).state_dict()``
    keys. LLaMA geometry with the fused ``W_pack`` projection,
    whose rows are already q | k | v; the gated MLP's ``fc1`` is gate | up;
    no linear biases. A vocabulary above 70 000 is Baichuan2's normalised
    head (``F.normalize(lm_head.weight)`` every forward in HF): the weights
    are frozen at inference, so the rows are normalised once here, as JAX
    does. 7B (rotary) and 13B (ALiBi) differ only in ``cfg``."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    out = {"transformer.wte.weight": sd["model.embed_tokens.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"model.layers.{i}.", f"transformer.blocks.{i}."
        out[dst + "norm1_scale"] = sd[src + "input_layernorm.weight"]
        out[dst + "norm2_scale"] = sd[src + "post_attention_layernorm.weight"]
        out[dst + "mha.Wqkv.weight"] = sd[src + "self_attn.W_pack.weight"]
        out[dst + "mha.out_proj.weight"] = sd[src + "self_attn.o_proj.weight"]
        out[dst + "mlp.fc1.weight"] = torch.cat(
            [sd[src + "mlp.gate_proj.weight"], sd[src + "mlp.up_proj.weight"]])
        out[dst + "mlp.fc2.weight"] = sd[src + "mlp.down_proj.weight"]
    out["transformer.ln_f_scale"] = sd["model.norm.weight"]
    head = sd["lm_head.weight"]
    if head.shape[0] > 70000:
        head = head / head.norm(dim=1, keepdim=True).clamp_min(1e-12)
    out["lm_head.weight"] = head
    return out


def remap_state_dict_hf_btlm(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF BTLM-3B checkpoint -> ``GPTLMHeadModel(cfg).state_dict()``
    keys. GPT-2's Conv1D weights are ``[in, out]`` and are
    transposed; ``c_fc`` is the gate and ``c_fc2`` the up branch of the
    gated MLP; ALiBi positions (no ``wpe``) and tied embeddings. The muP
    multipliers live in ``btlm_config``, not in the weights."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    out = {"transformer.wte.weight": sd["transformer.wte.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"transformer.h.{i}.", f"transformer.blocks.{i}."
        for j in (1, 2):
            out[dst + f"norm{j}_scale"] = sd[src + f"ln_{j}.weight"]
            out[dst + f"norm{j}_bias"] = sd[src + f"ln_{j}.bias"]
        for name, conv in (("mha.Wqkv", "attn.c_attn"), ("mha.out_proj", "attn.c_proj"),
                           ("mlp.fc2", "mlp.c_proj")):
            out[dst + name + ".weight"] = sd[src + conv + ".weight"].T.contiguous()
            out[dst + name + ".bias"] = sd[src + conv + ".bias"]
        out[dst + "mlp.fc1.weight"] = torch.cat(
            [sd[src + "mlp.c_fc.weight"], sd[src + "mlp.c_fc2.weight"]], dim=1).T.contiguous()
        out[dst + "mlp.fc1.bias"] = torch.cat(
            [sd[src + "mlp.c_fc.bias"], sd[src + "mlp.c_fc2.bias"]])
    out["transformer.ln_f_scale"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    return out


def remap_state_dict_hf_gptj(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF GPT-J checkpoint (``GPTJForCausalLM``) -> ``GPTLMHeadModel(cfg).
    state_dict()`` keys. The tied-norm parallel block:
    the one ``ln_1`` is ``norm1``; the bias-free ``q_proj`` / ``k_proj`` /
    ``v_proj`` fuse into ``Wqkv`` (rows q | k | v); ``fc_in`` / ``fc_out``
    are the biased MLP; the untied ``lm_head`` keeps its bias. Rotary
    (partial, interleaved) lives in ``gptj_config``, not in the weights."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    out = {"transformer.wte.weight": sd["transformer.wte.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"transformer.h.{i}.", f"transformer.blocks.{i}."
        out[dst + "norm1_scale"] = sd[src + "ln_1.weight"]
        out[dst + "norm1_bias"] = sd[src + "ln_1.bias"]
        out[dst + "mha.Wqkv.weight"] = torch.cat(
            [sd[src + f"attn.{w}_proj.weight"] for w in "qkv"])
        out[dst + "mha.out_proj.weight"] = sd[src + "attn.out_proj.weight"]
        for name, hf in (("fc1", "fc_in"), ("fc2", "fc_out")):
            out[dst + f"mlp.{name}.weight"] = sd[src + f"mlp.{hf}.weight"]
            out[dst + f"mlp.{name}.bias"] = sd[src + f"mlp.{hf}.bias"]
    out["transformer.ln_f_scale"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    out["lm_head.weight"] = sd["lm_head.weight"]
    out["lm_head.bias"] = sd["lm_head.bias"]
    return out


def _block_keys(i: int) -> str:
    return f"transformer.blocks.{i}."


def remap_state_dict_hf_gpt2(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF GPT-2 checkpoint (``GPT2LMHeadModel.transformer``'s state dict:
    ``wte``, ``wpe``, ``h.i.*``, ``ln_f``) -> ``GPTLMHeadModel(cfg).
    state_dict()`` keys. GPT-2's Conv1D weights are
    ``[in, out]`` and are transposed; embeddings are tied."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    out = {"transformer.wte.weight": sd["wte.weight"], "transformer.wpe.weight": sd["wpe.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"h.{i}.", _block_keys(i)
        for j in (1, 2):
            out[dst + f"norm{j}_scale"] = sd[src + f"ln_{j}.weight"]
            out[dst + f"norm{j}_bias"] = sd[src + f"ln_{j}.bias"]
        for name, conv in (("mha.Wqkv", "attn.c_attn"), ("mha.out_proj", "attn.c_proj"),
                           ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[dst + name + ".weight"] = sd[src + conv + ".weight"].T.contiguous()
            out[dst + name + ".bias"] = sd[src + conv + ".bias"]
    out["transformer.ln_f_scale"] = sd["ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["ln_f.bias"]
    return out


def remap_state_dict_hf_llama(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF LLaMA checkpoint -> ``GPTLMHeadModel(cfg).state_dict()``
    keys: ``q_proj`` / ``k_proj`` / ``v_proj`` fuse into
    ``Wqkv`` (rows q | k | v), ``gate_proj`` / ``up_proj`` into ``fc1``
    (gate | up); RMSNorm scales; no biases; an untied ``lm_head``."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    out = {"transformer.wte.weight": sd["model.embed_tokens.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"model.layers.{i}.", _block_keys(i)
        out[dst + "norm1_scale"] = sd[src + "input_layernorm.weight"]
        out[dst + "norm2_scale"] = sd[src + "post_attention_layernorm.weight"]
        out[dst + "mha.Wqkv.weight"] = torch.cat(
            [sd[src + f"self_attn.{w}_proj.weight"] for w in "qkv"])
        out[dst + "mha.out_proj.weight"] = sd[src + "self_attn.o_proj.weight"]
        out[dst + "mlp.fc1.weight"] = torch.cat(
            [sd[src + "mlp.gate_proj.weight"], sd[src + "mlp.up_proj.weight"]])
        out[dst + "mlp.fc2.weight"] = sd[src + "mlp.down_proj.weight"]
    out["transformer.ln_f_scale"] = sd["model.norm.weight"]
    out["lm_head.weight"] = sd["lm_head.weight"]
    return out


def remap_state_dict_hf_gpt_neox(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF GPT-NeoX checkpoint -> ``GPTLMHeadModel(cfg).state_dict()``
    keys. NeoX stores ``query_key_value`` head-interleaved,
    rows ``(heads, 3, head_dim)``; they are regrouped to q | k | v. The
    parallel block's norms are separate (``input_layernorm`` -> norm1,
    ``post_attention_layernorm`` -> norm2); ``embed_out`` is the untied
    head."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    h = cfg.num_heads
    d = cfg.dim // h
    out = {"transformer.wte.weight": sd["gpt_neox.embed_in.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"gpt_neox.layers.{i}.", _block_keys(i)
        w = sd[src + "attention.query_key_value.weight"]
        b = sd[src + "attention.query_key_value.bias"]
        out[dst + "mha.Wqkv.weight"] = (
            w.reshape(h, 3, d, -1).transpose(0, 1).reshape(3 * h * d, -1).contiguous())
        out[dst + "mha.Wqkv.bias"] = b.reshape(h, 3, d).transpose(0, 1).reshape(-1).contiguous()
        out[dst + "mha.out_proj.weight"] = sd[src + "attention.dense.weight"]
        out[dst + "mha.out_proj.bias"] = sd[src + "attention.dense.bias"]
        for j, hf in ((1, "input_layernorm"), (2, "post_attention_layernorm")):
            out[dst + f"norm{j}_scale"] = sd[src + hf + ".weight"]
            out[dst + f"norm{j}_bias"] = sd[src + hf + ".bias"]
        for name, hf in (("fc1", "dense_h_to_4h"), ("fc2", "dense_4h_to_h")):
            out[dst + f"mlp.{name}.weight"] = sd[src + f"mlp.{hf}.weight"]
            out[dst + f"mlp.{name}.bias"] = sd[src + f"mlp.{hf}.bias"]
    out["transformer.ln_f_scale"] = sd["gpt_neox.final_layer_norm.weight"]
    out["transformer.ln_f_bias"] = sd["gpt_neox.final_layer_norm.bias"]
    out["lm_head.weight"] = sd["embed_out.weight"]
    return out


def remap_state_dict_hf_falcon(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF Falcon (7B-style: MQA, a parallel block with one tied norm, no
    linear biases, tied embeddings) checkpoint -> ``GPTLMHeadModel(cfg).
    state_dict()`` keys. Falcon stores
    ``query_key_value`` grouped, rows ``(kv_heads, group + 2, head_dim)``:
    each group's q heads, then its k, then its v; they are split to
    q | k | v."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    h = cfg.num_heads
    hk = cfg.num_heads_kv or h
    d = cfg.dim // h
    out = {"transformer.wte.weight": sd["transformer.word_embeddings.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"transformer.h.{i}.", _block_keys(i)
        w = sd[src + "self_attention.query_key_value.weight"].reshape(hk, h // hk + 2, d, -1)
        out[dst + "mha.Wqkv.weight"] = torch.cat([
            w[:, :-2].reshape(h * d, -1), w[:, -2].reshape(hk * d, -1),
            w[:, -1].reshape(hk * d, -1)])
        out[dst + "mha.out_proj.weight"] = sd[src + "self_attention.dense.weight"]
        out[dst + "norm1_scale"] = sd[src + "input_layernorm.weight"]
        out[dst + "norm1_bias"] = sd[src + "input_layernorm.bias"]
        out[dst + "mlp.fc1.weight"] = sd[src + "mlp.dense_h_to_4h.weight"]
        out[dst + "mlp.fc2.weight"] = sd[src + "mlp.dense_4h_to_h.weight"]
    out["transformer.ln_f_scale"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    return out


def remap_state_dict_hf_opt(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF OPT checkpoint -> ``GPTLMHeadModel(cfg).state_dict()`` keys. The
    position table drops HF's 2 offset rows; the biased
    q / k / v fuse into ``Wqkv``; ``final_layer_norm`` of a layer is norm2;
    embeddings are tied. The 350m layout (``project_in`` / ``project_out``,
    post-norm, no final norm) needs ``GPTConfig(word_embed_proj_dim=...,
    prenorm=False)``; OPT-175B's ``decoder.layer_norm`` is the final norm."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    pre0 = "model.decoder." if any(k.startswith("model.decoder.") for k in sd) else "decoder."
    out = {"transformer.wte.weight": sd[pre0 + "embed_tokens.weight"]}
    if pre0 + "project_in.weight" in sd:
        if not cfg.word_embed_proj_dim:
            raise ValueError("checkpoint has project_in/out (the OPT-350m layout); construct "
                             "GPTConfig(word_embed_proj_dim=..., prenorm=False)")
        out["transformer.project_in.weight"] = sd[pre0 + "project_in.weight"]
        out["project_out.weight"] = sd[pre0 + "project_out.weight"]
    out["transformer.wpe.weight"] = sd[pre0 + "embed_positions.weight"][2:]
    for i in range(cfg.num_layers):
        src, dst = f"{pre0}layers.{i}.", _block_keys(i)
        out[dst + "mha.Wqkv.weight"] = torch.cat(
            [sd[src + f"self_attn.{w}_proj.weight"] for w in "qkv"])
        out[dst + "mha.Wqkv.bias"] = torch.cat(
            [sd[src + f"self_attn.{w}_proj.bias"] for w in "qkv"])
        out[dst + "mha.out_proj.weight"] = sd[src + "self_attn.out_proj.weight"]
        out[dst + "mha.out_proj.bias"] = sd[src + "self_attn.out_proj.bias"]
        for j, hf in ((1, "self_attn_layer_norm"), (2, "final_layer_norm")):
            out[dst + f"norm{j}_scale"] = sd[src + hf + ".weight"]
            out[dst + f"norm{j}_bias"] = sd[src + hf + ".bias"]
        for name in ("fc1", "fc2"):
            out[dst + f"mlp.{name}.weight"] = sd[src + f"{name}.weight"]
            out[dst + f"mlp.{name}.bias"] = sd[src + f"{name}.bias"]
    for final in ("final_layer_norm", "layer_norm"):
        if pre0 + final + ".weight" in sd:
            out["transformer.ln_f_scale"] = sd[pre0 + final + ".weight"]
            out["transformer.ln_f_bias"] = sd[pre0 + final + ".bias"]
            break
    else:
        if cfg.prenorm:
            raise ValueError("checkpoint has no final layer norm (do_layer_norm_before=False); "
                             "construct GPTConfig(prenorm=False)")
    return out


def remap_state_dict_hf_bigcode(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """HF GPTBigCode (StarCoder) checkpoint -> ``GPTLMHeadModel(cfg).
    state_dict()`` keys. GPT-2-shaped with MQA:
    ``c_attn`` is already q | k | v, and its Linear weights are ``[out,
    in]`` as the port keeps them; learned positions; tied embeddings."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    out = {"transformer.wte.weight": sd["transformer.wte.weight"],
           "transformer.wpe.weight": sd["transformer.wpe.weight"]}
    for i in range(cfg.num_layers):
        src, dst = f"transformer.h.{i}.", _block_keys(i)
        for j in (1, 2):
            out[dst + f"norm{j}_scale"] = sd[src + f"ln_{j}.weight"]
            out[dst + f"norm{j}_bias"] = sd[src + f"ln_{j}.bias"]
        for name, hf in (("mha.Wqkv", "attn.c_attn"), ("mha.out_proj", "attn.c_proj"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[dst + name + ".weight"] = sd[src + hf + ".weight"]
            out[dst + name + ".bias"] = sd[src + hf + ".bias"]
    out["transformer.ln_f_scale"] = sd["transformer.ln_f.weight"]
    out["transformer.ln_f_bias"] = sd["transformer.ln_f.bias"]
    return out


def state_dict_from_pretrained(model_name: str) -> Dict[str, torch.Tensor]:
    """A HF causal LM's state dict (CPU tensors), read by ``transformers``
    (imported here, not at module import) from a local directory or the
    local HF cache: ``local_files_only``, so nothing is fetched."""
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(model_name, local_files_only=True)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


__all__ = ["remap_state_dict_wan", "remap_state_dict_hf_gpt2", "remap_state_dict_hf_llama",
           "remap_state_dict_hf_gpt_neox", "remap_state_dict_hf_falcon", "remap_state_dict_hf_opt",
           "remap_state_dict_hf_bigcode", "remap_state_dict_hf_baichuan",
           "remap_state_dict_hf_btlm", "remap_state_dict_hf_gptj", "state_dict_from_pretrained"]
