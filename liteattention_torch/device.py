"""Where the port's entry points put their tensors.

The port runs on the card: an entry point given no device takes
``cuda``, and fails loudly where there is none, rather than carrying on
on the CPU. Tests and CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when it is None; a CUDA device without a
    GPU raises. ``cuda`` without an index becomes the current card
    (``cuda:0``), the device its tensors report."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


__all__ = ["resolve_device"]
