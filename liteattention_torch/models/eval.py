"""Quality of temporal-sparse denoising against the dense run.

Counterpart of ``liteattention_tpu/models/eval.py``. The reference
judges LiteAttention by VBench scores of decoded Wan video; this harness
measures the layer the engine touches: how far the sparse denoising
trajectory ends from the dense one from the same noise, beside the
sparsity it reached, on any weights (random ones included).

Metrics of a threshold setting: the relative L2 and the PSNR of the
sparse final latents against the dense ones, the latent proxies of
VBench's temporal-flicker and subject-consistency axes, and the mean,
final and per-step sparsity. :func:`threshold_sweep` is the reference's
threshold table (a sweep over constant thresholds).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from liteattention_torch.models.pipeline import denoise
from liteattention_torch.models.wan import WanModel


def latent_psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR between two latent tensors, the peak taken from ``b`` (the
    dense run)."""
    af, bf = a.float(), b.float()
    mse = ((af - bf) ** 2).mean()
    peak = bf.abs().max()
    return 10.0 * torch.log10((peak**2 / mse.clamp_min(1e-20)).clamp_min(1e-20))


def relative_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a - b| / |b|`` over the whole tensor, fp32."""
    af, bf = a.float(), b.float()
    return torch.linalg.vector_norm(af - bf) / torch.linalg.vector_norm(bf).clamp_min(1e-20)


def temporal_flicker_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Latent proxy of VBench's temporal-flicker axis: the relative L2
    between the two runs' frame differences ``x[:, 1:] - x[:, :-1]``
    (axis 1 holds the frames of ``[B, F, H, W, C]``). A sparse run that
    keeps each frame but jitters between frames scores badly here even
    when its rel-L2 is small."""
    da = torch.diff(a.float(), dim=1)
    db = torch.diff(b.float(), dim=1)
    return torch.linalg.vector_norm(da - db) / torch.linalg.vector_norm(db).clamp_min(1e-20)


def subject_consistency_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Latent proxy of VBench's subject-consistency axis: each run's
    frame-to-frame cosine similarity of its spatially pooled features
    ``mean_{H,W}(x)`` (``[B, F, C]``), and the mean absolute difference of
    the two profiles. A sparse run that drifts the subject between frames
    scores badly here."""

    def profile(x):
        feats = x.float().mean(dim=(2, 3))
        f0, f1 = feats[:, :-1], feats[:, 1:]
        num = (f0 * f1).sum(-1)
        den = (torch.linalg.vector_norm(f0, dim=-1) * torch.linalg.vector_norm(f1, dim=-1))
        return num / den.clamp_min(1e-20)

    return (profile(a) - profile(b)).abs().mean()


def evaluate_sparsity_quality(
    model: WanModel,
    noise: torch.Tensor,
    text: torch.Tensor,
    null_text: Optional[torch.Tensor] = None,
    num_steps: int = 20,
    thresholds: Optional[Sequence[float]] = None,
    **denoise_kwargs,
) -> Dict[str, Any]:
    """One sparse-against-dense comparison at a threshold schedule: a dense
    and a sparse :func:`~liteattention_torch.models.pipeline.denoise` from
    the same noise. Returns 0-d tensors (and the per-step sparsity)."""
    dense_out, _ = denoise(
        model, noise, text, null_text, num_steps=num_steps,
        enable_skipping=False, **denoise_kwargs,
    )
    sparse_out, tel = denoise(
        model, noise, text, null_text, num_steps=num_steps,
        thresholds=thresholds, enable_skipping=True, **denoise_kwargs,
    )
    return {
        "relative_l2": relative_l2(sparse_out, dense_out),
        "psnr_db": latent_psnr(sparse_out, dense_out),
        "temporal_flicker": temporal_flicker_delta(sparse_out, dense_out),
        "subject_consistency_delta": subject_consistency_delta(sparse_out, dense_out),
        "mean_sparsity": tel["sparsity_per_step"].mean(),
        "final_sparsity": tel["final_sparsity"],
        "sparsity_per_step": tel["sparsity_per_step"],
    }


def threshold_sweep(
    model: WanModel,
    noise: torch.Tensor,
    text: torch.Tensor,
    thresholds_list: Sequence[float] = (-10.0, -3.0, -1.0),
    num_steps: int = 20,
    **kwargs,
) -> List[Dict[str, Any]]:
    """The sparsity / quality trade-off over constant thresholds: one
    :func:`evaluate_sparsity_quality` per threshold, scalars as floats."""
    results = []
    for thr in thresholds_list:
        r = evaluate_sparsity_quality(
            model, noise, text, num_steps=num_steps,
            thresholds=[float(thr)] * num_steps, **kwargs,
        )
        r["threshold"] = thr
        results.append({
            k: (float(v) if not torch.is_tensor(v) or v.dim() == 0 else v)
            for k, v in r.items()
        })
    return results


__all__ = ["evaluate_sparsity_quality", "threshold_sweep", "latent_psnr",
           "relative_l2", "temporal_flicker_delta", "subject_consistency_delta"]
