"""``python -m liteattention_torch.train --config ... run.data_parallel=true``
at two gloo ranks against the same command at world size 1.

The config tree's GPT-2 geometry cut to width 64, 2 layers, 2 heads, vocab
128, 4 x 32 tokens a step, 3 steps (``--device cpu``). The ranks run in
one spawn of 2 (``tests/_torch_dist_train.py``), each calling
``liteattention_torch.train.run`` under the process group already set up;
the one-rank run is this process's. The model computes in bfloat16 (the
config's dtype): each rank's weight gradients are products over its half
batch rounded to bfloat16, so they differ from the one rank's at
bfloat16's rounding (2^-9 relative), as the bfloat16 wire's do, and AdamW's
normalised update turns a gradient that is rounding noise into a step of
either sign. Tolerances, for the plain run and for ZeRO-2 with the
bfloat16 wire alike: loss 1e-4 and grad norm 1e-3 relative, the
parameters two learning rates a step; every rank's parameters bit-equal.
"""

import os

import numpy as np
import pytest
import torch

from _torch_dist_train import run_ranks
from liteattention_torch import train

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                    "config.yaml")
OVERRIDES = ["model.dim=64", "model.num_layers=2", "model.num_heads=2", "model.vocab=128",
             "run.seqlen=32", "run.batch_size=4", "run.steps=3", "optimizer.learning_rate=5e-4"]
FLAGS = ["--device", "cpu", "--log-every", "1"]
DP = ["run.data_parallel=true"]
ZERO2_BF16 = ["trainer.shard_grads=true", "trainer.grad_comm_dtype=bfloat16"]


def _argv(*extra):
    return ["--config", ROOT, *OVERRIDES, *extra, *FLAGS]
LR = 5e-4


@pytest.fixture(scope="module")
def ranks():
    return run_ranks({2: [("plain", dict(fn="train_cli", argv=_argv(*DP))),
                          ("zero2_bf16", dict(fn="train_cli", argv=_argv(*DP, *ZERO2_BF16)))]})[2]


@pytest.fixture(scope="module")
def one_rank():
    recs = []
    trainer = train.run(_argv(), log_fn=recs.append)
    return recs, {k: v.detach().float().numpy() for k, v in trainer.model.state_dict().items()}


def _check(ranks, one_rank, name):
    recs, params = one_rank
    gn_tol, param_tol = 1e-3, 2 * LR * 3
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["world"] == 2
        assert [x["step"] for x in got["recs"]] == [1, 2, 3]
        for g, w in zip(got["recs"], recs):
            assert abs(g["loss"] - w["loss"]) <= 1e-4 * w["loss"], (r, g, w)
            assert abs(g["grad_norm"] - w["grad_norm"]) <= gn_tol * w["grad_norm"], (r, g, w)
        for k, w in params.items():
            if k.endswith("Wqkv.bias"):  # q | k | v: drop k (zero exact gradient)
                got_k, w = np.delete(got["params"][k], np.s_[64:128]), np.delete(w, np.s_[64:128])
            else:
                got_k = got["params"][k]
            np.testing.assert_allclose(got_k, w, atol=param_tol, rtol=0, err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(got["params"][k], ranks[0][name]["params"][k])


def test_data_parallel_cli_matches_world_size_1(ranks, one_rank):
    _check(ranks, one_rank, "plain")
    assert not ranks[0]["plain"]["zero"] and ranks[0]["plain"]["comm_dtype"] == "None"


def test_data_parallel_cli_zero2_bf16_wire_matches_world_size_1(ranks, one_rank):
    _check(ranks, one_rank, "zero2_bf16")
    assert ranks[0]["zero2_bf16"]["zero"]
    assert ranks[0]["zero2_bf16"]["comm_dtype"] == "torch.bfloat16"


def test_data_parallel_cli_without_a_group_or_torchrun_raises(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        train.run(_argv(*DP))
