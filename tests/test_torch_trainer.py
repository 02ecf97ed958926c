"""Port parity: the Trainer (liteattention_torch.training) against the JAX
Trainer, and the data functions against the JAX data module.

4 updates of the tiny GPT-2-shaped model (dim 128, 2 layers, 2 heads, vocab
512) from the same JAX init and the same synthetic_lm_batches (2 x 64),
fp32, warmup 2 of 4 steps (the first update has lr 0), lr 3e-3, clipping
active. Tolerances: per-step loss within 1e-5 relative; final params within
2e-5 absolute of JAX. One slice is left out of that comparison: the key
part of each ``Wqkv`` bias, whose exact gradient is 0 (it shifts every
score of a query row by one constant, which softmax ignores). Its computed
gradient is rounding noise, and AdamW, which normalises each update, turns
that noise into steps of about lr with arbitrary sign in both frameworks.
Data functions: bit-equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.losses.cross_entropy import cross_entropy_loss as jce  # noqa: E402
from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.training import data as jdata  # noqa: E402
from liteattention_tpu.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from liteattention_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.training import data as pdata  # noqa: E402
from liteattention_torch.training.trainer import TrainConfig, Trainer, warmup_cosine_lr  # noqa: E402

STEPS, B, S = 4, 2, 64
TRAIN = dict(learning_rate=3e-3, warmup_steps=2, total_steps=STEPS, grad_clip=0.5)


def _loss(model, batch):
    return gpt_loss_fn(model, batch, batch)


@pytest.fixture(scope="module")
def jax_run():
    jcfg = dataclasses.replace(JGPTConfig.tiny(), dtype=jnp.float32)
    jmodel = JGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))

    def loss_fn(p, batch):
        return jce(jmodel.apply(p, batch)[:, :-1], batch[:, 1:])

    trainer = JTrainer(loss_fn, JTrainConfig(**TRAIN))
    state = trainer.init_state(params)
    recs = []
    state = trainer.fit(state, jdata.synthetic_lm_batches(512, B, S, seed=3), STEPS,
                        log_every=1, log_fn=recs.append)
    init = jax.tree_util.tree_map(np.asarray, params)
    final = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state["params"]))
    return init, recs, final


def _port(init, **kw):
    model = GPTLMHeadModel(dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32), device="cpu")
    model.load_state_dict(gpt_state_dict_from_jax(init))
    return model, Trainer(model, _loss, TrainConfig(**TRAIN, **kw), device="cpu")


def test_trainer_matches_jax(jax_run):
    init, jrecs, jfinal = jax_run
    model, trainer = _port(init)
    recs = []
    step = trainer.fit(pdata.synthetic_lm_batches(512, B, S, seed=3), STEPS,
                       log_every=1, tokens_per_batch=B * S, log_fn=recs.append)
    assert step == STEPS and [r["step"] for r in recs] == [1, 2, 3, 4]
    for r, j in zip(recs, jrecs):
        assert abs(r["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
        assert abs(r["grad_norm"] - j["grad_norm"]) <= 1e-4 * j["grad_norm"]
        assert r["tokens_per_s"] > 0 and "mfu" not in r
    assert jrecs[0]["grad_norm"] > TRAIN["grad_clip"]  # clipping was active
    d = model.cfg.dim
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), jfinal[name].numpy()
        if name.endswith("Wqkv.bias"):  # q | k | v: drop k (zero exact gradient)
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=name)
    first = gpt_state_dict_from_jax(init)
    # The first update has lr 0: weight decay and Adam both scaled by it.
    assert warmup_cosine_lr(trainer.cfg, 0) == 0.0
    assert warmup_cosine_lr(trainer.cfg, 2) == TRAIN["learning_rate"]
    assert not torch.equal(model.transformer.wte.weight.detach(), first["transformer.wte.weight"])


def test_checkpoint_resume(jax_run, tmp_path):
    init = jax_run[0]
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1, max_checkpoints=2,
              ema_decay=0.9, norm_monitor=True)
    model, trainer = _port(init, **kw)
    batches = pdata.synthetic_lm_batches(512, B, S, seed=4)
    recs = []
    trainer.fit(batches, 2, log_every=1, log_fn=recs.append)
    assert sorted(p.name for p in tmp_path.glob("step_*.pt")) == ["step_1.pt", "step_2.pt"]
    assert set(recs[0]["param_norms"]) == {"transformer"}
    # A fresh model and trainer resume from the newest checkpoint.
    model2, trainer2 = _port(init, **kw)
    with torch.no_grad():
        for p in model2.parameters():
            p.zero_()
    assert trainer2.restore_or_init() == 2
    for (n, a), (_, b) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(a, b), n
    # Both continue identically; only the newest two checkpoints stay.
    rest = list(batches.__next__() for _ in range(2))
    l1 = [trainer.train_step(t(x))["loss"].item() for x in rest]
    l2 = []
    for x in rest:
        l2.append(trainer2.train_step(t(x))["loss"].item())
        trainer2.maybe_checkpoint()
    assert l1 == l2
    assert sorted(p.name for p in tmp_path.glob("step_*.pt")) == ["step_3.pt", "step_4.pt"]
    for n in trainer.ema:
        assert torch.equal(trainer.ema[n], trainer2.ema[n]), n


def test_trainer_raises_on_mesh_options():
    model = GPTLMHeadModel(dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32), device="cpu")
    for kw in (dict(shard_opt_state=True), dict(shard_grads=True), dict(grad_comm_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            Trainer(model, _loss, TrainConfig(**kw), device="cpu")


def test_data_functions_bit_equal(tmp_path):
    for seed in (0, 7):
        j, p = jdata.synthetic_lm_batches(1000, 3, 17, seed), pdata.synthetic_lm_batches(1000, 3, 17, seed)
        for _ in range(3):
            np.testing.assert_array_equal(next(j), next(p))
    js, ps = jdata.FaultTolerantSampler(23, seed=5, shard=1, num_shards=2), pdata.FaultTolerantSampler(23, seed=5, shard=1, num_shards=2)
    jb, pb = js.batches(4), ps.batches(4)
    for _ in range(5):  # crosses an epoch boundary
        np.testing.assert_array_equal(next(jb), next(pb))
    assert js.state_dict() == ps.state_dict()
    resumed = pdata.FaultTolerantSampler(23, shard=1, num_shards=2)
    resumed.load_state_dict(ps.state_dict())
    np.testing.assert_array_equal(next(resumed.batches(4)), next(jb))
    tokens = np.random.RandomState(0).randint(0, 60000, size=1000).astype(np.uint16)
    path = tmp_path / "tokens.bin"
    tokens.tofile(path)
    mm = np.memmap(path, dtype=np.uint16, mode="r")
    assert len(pdata.LMDataset(mm, 33)) == len(jdata.LMDataset(mm, 33))
    np.testing.assert_array_equal(pdata.LMDataset(mm, 33)[4], jdata.LMDataset(mm, 33)[4])
    jm, pm = jdata.memmap_lm_batches(mm, 3, 33, seed=2), pdata.memmap_lm_batches(mm, 3, 33, seed=2)
    for _ in range(12):  # more than one epoch of the 30 sequences
        np.testing.assert_array_equal(next(jm), next(pm))


def test_cli_runs_on_cpu(tmp_path):
    from liteattention_torch import train
    from liteattention_torch.training.logging import read_jsonl

    metrics = tmp_path / "m.jsonl"
    argv = ["--device", "cpu", "--dim", "128", "--layers", "2", "--heads", "2",
            "--vocab", "512", "--seqlen", "64", "--batch-size", "2", "--steps", "3",
            "--log-every", "1", "--metrics-jsonl", str(metrics)]
    assert train.main(argv) == 0
    recs = read_jsonl(str(metrics))
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)
    # --model llama (rotary, RMSNorm, SwiGLU) runs since rotary is ported.
    llama = tmp_path / "llama.jsonl"
    assert train.main(["--model", "llama", "--device", "cpu", "--dim", "64", "--layers", "1",
                       "--heads", "2", "--vocab", "128", "--seqlen", "16", "--batch-size", "2",
                       "--steps", "2", "--log-every", "1", "--metrics-jsonl", str(llama)]) == 0
    assert all(np.isfinite(r["loss"]) for r in read_jsonl(str(llama)))
    with pytest.raises(NotImplementedError, match="config_tree"):
        train.main(["--config", "configs/config.yaml", "--device", "cpu"])


def test_cli_overfit_batch_loss_falls():
    from liteattention_torch import train

    recs = []
    argv = ["--device", "cpu", "--dim", "64", "--layers", "1", "--heads", "2",
            "--vocab", "128", "--seqlen", "32", "--batch-size", "2", "--steps", "6",
            "--lr", "1e-2", "--log-every", "1", "--overfit-batch"]
    trainer = train.run(argv, log_fn=recs.append)
    assert trainer.step == 6
    losses = [r["loss"] for r in recs]
    assert losses[0] == losses[1]  # the first update has lr 0
    assert losses[-1] < losses[0] - 0.5, losses
