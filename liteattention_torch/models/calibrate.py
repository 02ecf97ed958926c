"""Error-calibrated threshold selection.

Counterpart of ``liteattention_tpu/models/calibrate.py``. The reference's
thresholds are calibrated per timestep by its users, who sweep them
offline and keep the per-step values that hold quality at parity
(reference README.md:93-98,148-153). This module runs that loop:

* :func:`calibrate_constant_threshold`: the loosest constant threshold
  whose whole-trajectory deviation from the dense run stays within a
  rel-L2 budget (bisection over the threshold with
  :func:`~liteattention_torch.models.eval.evaluate_sparsity_quality`);
* :func:`calibrate_schedule`: a per-step schedule built from it, tight
  early, held, and loosened over the last steps.

Calibration runs on one prototype noise and prompt; the schedule is then
reused for the workload.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from liteattention_torch.models.eval import evaluate_sparsity_quality
from liteattention_torch.models.wan import WanModel

# calibrate_schedule lowers a constant whose delta-0 schedule misses the
# budget by this much, at most this many times.
TIGHTEN_STEP, TIGHTEN_TRIES = 1.0, 4


def calibrate_constant_threshold(
    model: WanModel,
    noise: torch.Tensor,
    text: torch.Tensor,
    target_rel_l2: float = 0.05,
    lo: float = -12.0,
    hi: float = 2.0,
    iters: int = 5,
    num_steps: int = 10,
    **denoise_kwargs,
) -> Dict[str, Any]:
    """Bisection for the loosest constant threshold within the budget.

    Sound because the deviation does not decrease as the threshold
    loosens: a looser threshold only removes more tiles, and the mask
    update only removes tiles. Returns ``threshold``, ``relative_l2`` and
    ``mean_sparsity`` (floats), with a ``warning`` when even ``lo`` misses
    the budget.
    """

    def deviation(thr: float) -> Tuple[float, float]:
        r = evaluate_sparsity_quality(
            model, noise, text, num_steps=num_steps,
            thresholds=[float(thr)] * num_steps, **denoise_kwargs,
        )
        return float(r["relative_l2"]), float(r["mean_sparsity"])

    err_hi, sp_hi = deviation(hi)
    if err_hi <= target_rel_l2:
        return {"threshold": hi, "relative_l2": err_hi, "mean_sparsity": sp_hi}
    err_lo, sp_lo = deviation(lo)
    if err_lo > target_rel_l2:
        return {
            "threshold": lo, "relative_l2": err_lo, "mean_sparsity": sp_lo,
            "warning": "budget unattainable even at the tightest threshold",
        }
    best = (lo, err_lo, sp_lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        err, sp = deviation(mid)
        if err <= target_rel_l2:
            best = (mid, err, sp)
            lo = mid
        else:
            hi = mid
    return {"threshold": best[0], "relative_l2": best[1], "mean_sparsity": best[2]}


def calibrate_schedule(
    model: WanModel,
    noise: torch.Tensor,
    text: torch.Tensor,
    num_steps: int,
    target_rel_l2: float = 0.05,
    tighten_frac: float = 0.3,
    loosen_frac: float = 0.5,
    loosen_hi: float = 6.0,
    loosen_iters: int = 4,
    probe_steps: Optional[int] = None,
    **kwargs,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Per-step schedule: the constant calibration, then late-step
    loosening.

    1. The first ``tighten_frac`` of the steps ramp from (threshold - 4)
       up to the calibrated constant (masks form conservatively while the
       latent is noise);
    2. a hold at the constant;
    3. the last ``loosen_frac`` of the steps ramp up by ``delta`` in [0,
       ``loosen_hi``], bisected to the largest value that keeps the whole
       schedule's deviation within the budget (monotone, as above).

    The constant is bisected at the full step count (``probe_steps``
    overrides it): the deviation grows with the steps. The schedule at
    delta 0 need not meet the budget where the constant does (its ramp and
    hold differ from a constant run, and the run's deviation is noisy
    near the budget's border): then the constant is lowered by
    ``TIGHTEN_STEP`` until the delta-0 schedule meets the budget, at most
    ``TIGHTEN_TRIES`` times, and a schedule that still misses ships with a
    ``warning``. (The JAX function ships the missing schedule without
    one.) Returns (the schedule, fp32 ``[num_steps]``; the shipped
    schedule's threshold, ``loosen_delta``, rel-L2, sparsity, flicker and
    PSNR, with the constant's ``warning`` if it had one, or this one).
    """
    result = calibrate_constant_threshold(
        model, noise, text, target_rel_l2=target_rel_l2,
        num_steps=probe_steps or num_steps, **kwargs,
    )
    thr = result["threshold"]
    # lo / hi / iters steer the bisection above; they are not denoise's.
    denoise_kwargs = {k: v for k, v in kwargs.items() if k not in ("lo", "hi", "iters")}

    n_ramp = max(int(num_steps * tighten_frac), 1)
    n_loose = min(max(int(num_steps * loosen_frac), 1), num_steps - n_ramp)

    def build(delta: float) -> torch.Tensor:
        n_hold = num_steps - n_ramp - n_loose
        return torch.cat([
            torch.linspace(thr - 4.0, thr, n_ramp),
            torch.full((n_hold,), float(thr)),
            torch.linspace(thr, thr + delta, n_loose + 1)[1:],
        ])

    def evaluate(delta: float) -> Dict[str, Any]:
        # What is reported belongs to the schedule that ships.
        return evaluate_sparsity_quality(
            model, noise, text, num_steps=num_steps, thresholds=build(delta),
            **denoise_kwargs,
        )

    final0 = evaluate(0.0)
    tries = 0
    while float(final0["relative_l2"]) > target_rel_l2 and tries < TIGHTEN_TRIES:
        thr -= TIGHTEN_STEP  # build() reads thr
        tries += 1
        final0 = evaluate(0.0)
    best = (0.0, final0)
    if float(final0["relative_l2"]) <= target_rel_l2 and n_loose > 0:
        e_hi = evaluate(loosen_hi)
        if float(e_hi["relative_l2"]) <= target_rel_l2:
            best = (loosen_hi, e_hi)
        else:
            lo_d, hi_d = 0.0, loosen_hi
            for _ in range(loosen_iters):
                mid = 0.5 * (lo_d + hi_d)
                e = evaluate(mid)
                if float(e["relative_l2"]) <= target_rel_l2:
                    best = (mid, e)
                    lo_d = mid
                else:
                    hi_d = mid
    delta, final = best
    sched_result = {
        "threshold": thr,
        "loosen_delta": float(delta),
        "relative_l2": float(final["relative_l2"]),
        "mean_sparsity": float(final["mean_sparsity"]),
        "final_sparsity": float(final["final_sparsity"]),
        "temporal_flicker": float(final["temporal_flicker"]),
        "psnr_db": float(final["psnr_db"]),
    }
    if "warning" in result:
        sched_result["warning"] = result["warning"]
    elif sched_result["relative_l2"] > target_rel_l2:
        sched_result["warning"] = (
            f"the delta-0 schedule misses the budget even {tries} x {TIGHTEN_STEP} below the "
            "calibrated constant")
    return build(delta), sched_result


__all__ = ["calibrate_constant_threshold", "calibrate_schedule"]
