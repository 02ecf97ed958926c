"""Flax param trees -> ``state_dict``s of the port's modules.

Flax ``Dense`` kernels are ``[in, out]`` and become ``[out, in]`` Linear
weights; ``scale`` (norms) and ``embedding`` (``nn.Embed``) become
``weight``; ``block_i`` (GPT) becomes ``blocks.i`` and ``layer_i`` (BERT)
``layers.i``; every other leaf keeps its name (``bias``, ``norm1_scale``,
``ln_f_bias``, ...). Tensors come back
fp32 on the CPU; ``load_state_dict`` casts them to each parameter's dtype
and device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """``params``: the Flax variable tree (or its ``"params"`` subtree) as
    nested dicts of numpy-convertible arrays."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, val in tree.items():
            stack, _, idx = name.partition("_")
            if stack in ("block", "layer") and idx.isdigit():
                name = f"{stack}s.{idx}"
            if isinstance(val, dict):
                walk(val, f"{prefix}{name}.")
                continue
            arr = torch.from_numpy(np.array(val, dtype=np.float32))
            if name == "kernel":
                out[prefix + "weight"] = arr.T.contiguous()
            elif name in ("scale", "embedding"):
                out[prefix + "weight"] = arr
            else:
                out[prefix + name] = arr

    walk(params, "")
    return out


__all__ = ["state_dict_from_flax"]
