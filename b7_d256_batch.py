#!/usr/bin/env python3
"""How B7's one pass at head dim 256 scales with the batch, on one NVIDIA
GPU.

    python3 b7_d256_batch.py

Times ``flash_attention_bwd`` (the whole backward: delta, the main kernel
of ``csrc/flash_bwd_d256.cu``, the dQ conversion) by
``chip_smoke.device_ms`` at causal 16 heads x 2048 x 256 bf16: channel-free
at GPT-J's batch 2 and at batch 8, then at batch 8 with the key range over
every key and at ``chip_smoke.py`` phase 25 (e)'s padded lengths
(Gemma-7B's fine-tuning batch). Prints the card and one JSON line, and
writes it to ``chiprun_out/b7_d256_batch.json``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADS, SEQ, D = 16, 2048, 256
PADDED_LENGTHS = (1168, 1981, 565, 1390, 1283, 1717, 930, 2044)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from liteattention_torch.ops import _build
    from liteattention_torch.ops.flash_bwd import flash_attention_bwd
    from liteattention_torch.ops.flash_fwd import flash_attention_masked

    _build.build_kernels()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    res = {"card": chip_smoke.nvidia_smi_line()}
    print(res["card"])
    full = torch.full((8,), SEQ, dtype=torch.int32, device=dev)
    padded = torch.tensor(PADDED_LENGTHS, dtype=torch.int32, device=dev)
    for name, batch, kw in (("channel_free_b2", 2, {}), ("channel_free_b8", 8, {}),
                            ("range_every_key_b8", 8, dict(kv_bound=full)),
                            ("range_padded_b8", 8, dict(kv_bound=padded))):
        q, k, v, dout = (torch.randn(batch, HEADS, SEQ, D, generator=g, device=dev).bfloat16()
                         for _ in range(4))
        out, lse = flash_attention_masked(q, k, v, causal=True, return_lse=True, **kw)
        res[f"{name}_ms"] = chip_smoke.device_ms(
            lambda: flash_attention_bwd(q, k, v, out, lse, dout, D**-0.5, True, **kw), 20)[0]
        del q, k, v, dout, out, lse
    line = json.dumps(res)
    print(line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "b7_d256_batch.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
