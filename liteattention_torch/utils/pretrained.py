"""Checkpoint remapping: official Wan2.1/2.2 torch checkpoints -> the
port's ``WanModel`` state dict; HF Baichuan and BTLM checkpoints -> the
port's ``GPTLMHeadModel`` state dict.

Counterpart of ``liteattention_tpu/utils/pretrained.py``'s
``remap_state_dict_wan``, ``remap_state_dict_hf_baichuan`` and
``remap_state_dict_hf_btlm`` (the other families' remaps are not ported
yet): the same tensors, under the port's keys. The Wan key layout is
Wan-Video/Wan2.1 ``wan/modules/model.py``: ``patch_embedding`` (Conv3d),
``text_embedding.{0,2}``, ``time_embedding.{0,2}``, ``time_projection.1``,
``blocks.N.{self_attn,cross_attn}.{q,k,v,o,norm_q,norm_k}``,
``blocks.N.{norm3,ffn.0,ffn.2,modulation}``, ``head.{head,modulation}``,
(I2V) ``img_emb.proj.{0,1,3,4}`` and (Wan2.1-I2V)
``cross_attn.{k_img,v_img,norm_k_img}``. Torch Linear weights are already
``[out, in]``, as the port's ``nn.Linear`` keeps them; the Conv3d patch
kernel ``[dim, C, pt, ph, pw]`` becomes a Linear over features ordered
(pt, ph, pw, C), the model's patchify order. No checkpoint is fetched:
the caller hands in a state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    """A checkpoint entry (torch tensor or array) as an fp32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def remap_state_dict_wan(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Official Wan checkpoint -> ``WanModel(cfg).state_dict()`` keys (fp32
    CPU tensors; ``load_state_dict`` casts them). A checkpoint with the
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
    """HF Baichuan checkpoint -> ``GPTLMHeadModel(cfg).state_dict()`` keys
    (fp32 CPU tensors). LLaMA geometry with the fused ``W_pack`` projection,
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
    """HF BTLM-3B checkpoint -> ``GPTLMHeadModel(cfg).state_dict()`` keys
    (fp32 CPU tensors). GPT-2's Conv1D weights are ``[in, out]`` and are
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


__all__ = ["remap_state_dict_wan", "remap_state_dict_hf_baichuan", "remap_state_dict_hf_btlm"]
