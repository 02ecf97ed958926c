#!/usr/bin/env python3
"""What GPT-J-6B's recompute comparison sees of cache faults of each size,
on one NVIDIA GPU.

    python3 gptj_fault_sweep.py

Serves GPT-J-6B as ``chip_smoke.py``'s phase 14 (c) does (the same seeds:
28 layers at full width, 8 requests x 1024 prompt tokens, 32 greedy steps
into a 2048 cache, bf16 then int8), then plants each fault after the
prefill and reads the rel-L2 of the first ``FAULT_STEPS`` teacher-forced
step logits against a full recompute without a cache, as
``chip_smoke.recompute_fault_readings`` does: every step k positions late,
and the prompt's last n K/V rows zeroed, for several k and n. Prints the
card and one JSON line per cache, and writes both to
``chiprun_out/gptj_fault_sweep.json``. ``chip_smoke.GPTJ_FAULT_LATE`` and
``GPTJ_FAULT_ROWS`` are the smallest sizes here that read at least 1.5x
``SERVE_RECOMPUTE_TOL`` on both caches.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LATE_BY = (1, 4, 16, 64, 128)
ROWS = (1, 16, 64, 128, 256)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from liteattention_torch.models.configs import gptj_config
    from liteattention_torch.models.gpt import GPTLMHeadModel
    from liteattention_torch.utils.generation import greedy_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg = gptj_config()
    model = GPTLMHeadModel(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(64))
    model.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(65)
    ids = torch.randint(0, cfg.vocab_size, (cs.GPTJ_BATCH, cs.GPTJ_PROMPT), generator=g,
                        device=dev)
    prompt, capacity, n = cs.GPTJ_PROMPT, cs.GPTJ_CONTEXT, cs.FAULT_STEPS

    def late(k):
        def fault(inf):
            inf.seqlen_offset += k
        return fault

    def rows(r):
        def fault(inf):
            for kc, vc, *_ in inf.key_value_memory_dict.values():
                kc[:, :, prompt - r : prompt] = 0
                vc[:, :, prompt - r : prompt] = 0
        return fault

    out = {"card": card}
    for quantize in (False, True):
        timer = cs.StepTimer(model)
        toks = greedy_decode(timer, ids, cs.GPTJ_NEW, capacity, quantize_cache=quantize)
        with torch.inference_mode():
            full = torch.cat([model(toks[i : i + 1, :-1])[:, prompt - 1 :].clone()
                              for i in range(cs.GPTJ_BATCH)])
        ref = full[:, 1:n]
        res = {"sound": cs.rel_l2(timer.logits(), full),
               "sound_first_steps": cs.rel_l2(timer.logits()[:, 1:n], ref)}
        faults = [(f"late_{k}", late(k)) for k in LATE_BY] + [(f"rows_{r}", rows(r)) for r in ROWS]
        for name, fault in faults:
            got, _ = cs.teacher_forced_logits(model, toks[:, : prompt + n], prompt, capacity,
                                              quantize=quantize, fault=fault)
            res[name] = cs.rel_l2(got[:, 1:], ref)
        cache = "int8" if quantize else "bf16"
        out[cache] = res
        print(cache, json.dumps(res), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "gptj_fault_sweep.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
