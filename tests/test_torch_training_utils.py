"""Port parity: training/metrics.py, training/diagnostics.py, TrainState and
utils/benchmark.py against the JAX modules on the CPU, on the same numpy
inputs.

Tolerances: metrics from logits within 1e-6 relative (fp32 log-softmax in
another order), counts and accuracies equal; the causality leak vector
within 1e-6 absolute (fp32, through B1's / B7's plain versions against
JAX's kernels in interpret mode); parameter counts equal. The benchmark
helpers return what JAX's do on a CPU: a positive mean and a standard
deviation for a timed call, 0.0 peak bytes (no allocator statistics), the
trace directory.
"""

import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.training import diagnostics as jdiag  # noqa: E402
from liteattention_tpu.training import metrics as jmetrics  # noqa: E402
from liteattention_tpu.utils import benchmark as jbench  # noqa: E402
from liteattention_torch.training import diagnostics, metrics  # noqa: E402
from liteattention_torch.training.trainer import TrainState  # noqa: E402
from liteattention_torch.utils import benchmark  # noqa: E402


def _batches(seed, n=3, v=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        logits = rng.normal(size=(2, 8, v)).astype(np.float32)
        target = rng.integers(0, v, size=(2, 8))
        target[0, 6 - i:] = -100  # ignore_index tails
        out.append((logits, target))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_perplexity_from_logits_matches_jax(seed):
    ours, ref = metrics.Perplexity(), jmetrics.Perplexity()
    for logits, target in _batches(seed):
        ours.update(logits=t(logits), target=t(target))
        ref.update(logits=jnp.asarray(logits), target=jnp.asarray(target))
    assert ours.count == ref.count
    assert ours.compute() == pytest.approx(ref.compute(), rel=1e-6)
    ours.reset()
    assert ours.count == 0 and math.isnan(ours.compute())
    with pytest.raises(ValueError):
        ours.update(logits=t(logits))


def test_perplexity_from_loss_weighted_by_tokens_matches_jax():
    ours, ref = metrics.Perplexity(), jmetrics.Perplexity()
    for loss, n in ((2.0, 4), (1.0, 12)):
        ours.update(loss=torch.tensor(loss), target=torch.zeros(1, n, dtype=torch.long))
        ref.update(loss=jnp.asarray(loss), target=jnp.zeros((1, n), jnp.int32))
    ours.update(loss=torch.tensor(0.5))  # no target: one token
    ref.update(loss=jnp.asarray(0.5))
    assert ours.compute() == pytest.approx(ref.compute(), rel=1e-7)
    assert ours.compute() == pytest.approx(math.exp((8 + 12 + 0.5) / 17))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_accuracy_and_token_accuracy_match_jax(soft):
    ours, ref = metrics.Accuracy(), jmetrics.Accuracy()
    for logits, target in _batches(2):
        if soft:  # Mixup-style targets: argmaxed first
            target = np.eye(11, dtype=np.float32)[np.clip(target, 0, None)]
        ours.update(t(logits), t(target))
        ref.update(jnp.asarray(logits), jnp.asarray(target))
        got = float(metrics.token_accuracy(t(logits), t(target)))
        assert got == pytest.approx(float(jmetrics.token_accuracy(jnp.asarray(logits),
                                                                  jnp.asarray(target))))
    assert (ours.hits, ours.total) == (ref.hits, ref.total)
    assert ours.compute() == ref.compute()
    ours.reset()
    assert math.isnan(ours.compute())


def test_num_tokens_survives_reset_as_jax():
    ours, ref = metrics.NumTokens(), jmetrics.NumTokens()
    for _, target in _batches(3):
        ours.update(t(target))
        ref.update(jnp.asarray(target))
        ours.reset()  # an epoch boundary: the count persists
        ref.reset()
    assert ours.compute() == ref.compute() == 48 - (2 + 3 + 4)
    again = metrics.NumTokens()
    again.load_state_dict(ours.state_dict())
    assert again.compute() == ours.compute()
    ours.hard_reset()
    assert ours.compute() == 0


def _mha_pair(causal):
    from liteattention_tpu.modules.mha import MHA as JMHA
    from liteattention_torch.models.convert import state_dict_from_flax
    from liteattention_torch.modules.mha import MHA

    jm = JMHA(embed_dim=16, num_heads=2, causal=causal, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 16)))
    pm = MHA(16, 2, causal=causal, dtype=torch.float32, device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return (lambda x: jm.apply(params, x)), pm


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_causality_leakage_matches_jax_on_attention(causal):
    jfn, pm = _mha_pair(causal)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 10, 16), jnp.float32))
    want = np.asarray(jdiag.causality_leakage(jfn, seq_len=10, input_dim=16))
    got = diagnostics.causality_leakage(pm, x=t(x))
    assert got.shape == (10,) and got[-1] == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-4)
    assert diagnostics.check_causal(pm, seq_len=10, input_dim=16) == causal
    if not causal:
        assert got[:-1].max() > 1e-4


def test_param_stats_match_jax_on_a_gpt():
    from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig
    from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT
    from liteattention_torch.models.gpt import GPTConfig, GPTLMHeadModel

    kw = dict(vocab_size=64, max_position_embeddings=32, dim=32, num_layers=2, num_heads=2,
              tie_embeddings=False)
    jparams = JGPT(JGPTConfig(**kw)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = GPTLMHeadModel(GPTConfig(**kw), device="cpu")
    ours = diagnostics.param_stats(model)
    assert ours == jdiag.param_stats(jparams)
    assert set(ours) >= {"model/params/transformer", "model/params/lm_head"}
    # A mask: the LM head frozen, given both ways (requires_grad, mapping).
    mask = {n: not n.startswith("lm_head") for n, _ in model.named_parameters()}
    jmask = jax.tree_util.tree_map_with_path(
        lambda path, _: "lm_head" not in str(path[1]), jparams)
    want = jdiag.param_stats(jparams, trainable_mask=jmask)
    assert diagnostics.param_stats(model, trainable_mask=mask) == want
    model.lm_head.requires_grad_(False)
    assert diagnostics.param_stats(model) == want
    named = dict(model.named_parameters())
    assert diagnostics.param_stats(named)["model/params_not_trainable"] == 0


def test_train_state_is_jax_s_dict():
    state = TrainState(params={"w": 1}, opt_state=(), step=3)
    assert state == {"params": {"w": 1}, "opt_state": (), "step": 3}
    assert type(state) is dict
    from liteattention_tpu.training.trainer import TrainState as JTrainState

    assert state == JTrainState(params={"w": 1}, opt_state=(), step=3)


def test_benchmark_helpers_on_the_cpu(tmp_path, capsys):
    x = torch.randn(64, 64)
    mean, std = benchmark.benchmark_forward(torch.matmul, x, x, repeats=3, warmup=1,
                                            desc="matmul")
    assert mean > 0 and std >= 0
    assert "matmul:" in capsys.readouterr().out
    jmean, jstd = jbench.benchmark_forward(jnp.matmul, jnp.ones((8, 8)), jnp.ones((8, 8)),
                                           repeats=3, warmup=1, verbose=False)
    assert jmean > 0 and jstd >= 0  # the same return form
    # The CPU keeps no allocator statistics: 0.0 here as in JAX.
    assert benchmark.benchmark_memory(torch.ones, 10) == 0.0
    assert jbench.benchmark_memory(lambda: jnp.ones(10)) == 0.0
    benchmark.hard_sync((x, {"y": [x]}))
    out = benchmark.profile_trace(torch.matmul, x, x, log_dir=str(tmp_path / "trace"))
    assert out == str(tmp_path / "trace")
    assert os.path.getsize(os.path.join(out, "trace.json")) > 0
