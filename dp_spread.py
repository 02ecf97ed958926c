#!/usr/bin/env python3
"""How far rounding alone parts ``chip_smoke.py``'s phase 23 (a) runs, on
one NVIDIA GPU.

    python3 dp_spread.py

Runs (a)'s 4-step ZeRO-2 + bfloat16-wire data-parallel run of gpt2s-moe
(two gloo ranks sharing card 0, through ``train.py run.data_parallel``)
``DP_REPEATS`` times and the one-rank run ``ONE_REPEATS`` times, on the
same global batches, and prints for each step the loss's absolute and the
grad norm's relative difference of every data-parallel run against every
one-rank run, of the one-rank runs against each other (B7's atomic dQ is
their only difference) and of the data-parallel runs against each other.
Writes the card and the readings to ``chiprun_out/dp_spread.json``.
``chip_smoke.DP_MOVED_GN_RTOL`` comes from these readings.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DP_REPEATS, ONE_REPEATS = 3, 2


def _diff(a, b):
    """Per step: |loss a - loss b| and |grad norm a - b| / grad norm b."""
    return {"loss": [abs(x["loss"] - y["loss"]) for x, y in zip(a["recs"], b["recs"])],
            "grad_norm": [abs(x["grad_norm"] - y["grad_norm"]) / y["grad_norm"]
                          for x, y in zip(a["recs"], b["recs"])]}


def _body(rank, dev, mesh, card):
    import chip_smoke as cs

    name, steps, extra = cs.DP_RUNS[0]
    dps = [cs._dp_train_run(rank, card, name, steps, extra)[0] for _ in range(DP_REPEATS)]
    if rank:
        return {}
    ones = [cs._dp_train_run(rank, card, "one rank", steps, [], data_parallel=False)[0]
            for _ in range(ONE_REPEATS)]
    return {"run": name, "steps": steps,
            "dp_vs_one": [_diff(d, o) for d in dps for o in ones],
            "one_vs_one": [_diff(o, ones[0]) for o in ones[1:]],
            "dp_vs_dp": [_diff(d, dps[0]) for d in dps[1:]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from liteattention_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    _build.build_kernels()
    result = cs._spawn_ranks(cs.SP_RANKS, "gloo", card, body=_body, label="dp_spread")[0]
    for key in ("dp_vs_one", "one_vs_one", "dp_vs_dp"):
        for i, d in enumerate(result[key]):
            print(f"{key} #{i}: loss {[f'{x:.2e}' for x in d['loss']]}, grad norm "
                  f"{[f'{x:.2e}' for x in d['grad_norm']]} [{card}]", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dp_spread.json").write_text(json.dumps({"card": card, **result}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
