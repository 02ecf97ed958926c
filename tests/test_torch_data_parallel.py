"""Port parity: the data-parallel ``Trainer`` (``mesh``, ``shard_opt_state``,
``shard_grads``, ``grad_comm_dtype``) on gloo ranks, against the JAX
package's mesh ``Trainer`` on the conftest's virtual CPU devices and
against the port's one-rank ``Trainer``.

JAX's setup (``tests/test_training.py``): a GPT of width 64, one layer,
two heads, vocab 128, fp32, from one JAX init; three steps of 4 x 32
``synthetic_lm_batches``; lr 1e-3, warmup 2 of 50 steps. The port runs
each option at dp 2 and 4 in one spawn of 4 ranks
(``tests/_torch_dist_train.py``; the 2-rank runs on ranks 0 and 1), and
ZeRO-2 with the bfloat16 wire at dp 2. JAX runs plain at dp 2 and 4, and
ZeRO-2 and the bfloat16 wire at dp 4 (its own tests' cases). Its other
options change where its state lives, not the arithmetic, so the port's
other float32 runs are held to JAX's plain run of their dp, and its
bfloat16 runs to JAX's at dp 4.

Tolerances. Against JAX, JAX's own: loss 2e-3 absolute, grad norm 2e-2
relative. Against the port's one-rank trainer (the mesh options change
nothing there): in float32, loss and grad norms 1e-5 relative, parameters
1e-5 absolute; with the bfloat16 wire (8-bit mantissas, a 2^-9 relative
rounding of each gradient) loss 1e-5 and grad norms 1e-3 relative, and
the parameters 3e-3, two learning rates a step (AdamW normalises each
update, so a gradient that is rounding noise may step either way). The
key part of each ``Wqkv`` bias is left out of the parameter comparisons:
its exact gradient is 0 (``tests/test_torch_trainer.py``).

The same GPT with 4 experts top-2 in its one block: JAX's data-parallel
step is one ``jit`` over the global batch, so its MoE layer routes the
whole batch as one device does; the port's ranks route as one device too
(``modules/moe.py:data_parallel_routing``). Held at a capacity factor that
drops no (token, slot) pair and at one that drops many (0.5), the port at
dp 2 and 4 against JAX's mesh ``Trainer`` at dp 2 (at JAX's bounds) and
against the port's one-rank ``Trainer`` (float32, as above).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from _torch_dist_train import run_ranks  # noqa: E402
from _torch_port import t  # noqa: E402
from liteattention_tpu.losses.cross_entropy import cross_entropy_loss as jce  # noqa: E402
from liteattention_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from liteattention_tpu.models.gpt import GPTLMHeadModel as JGPT  # noqa: E402
from liteattention_tpu.models.gpt import gpt_loss_fn as jgpt_loss_fn  # noqa: E402
from liteattention_tpu.training import data as jdata  # noqa: E402
from liteattention_tpu.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from liteattention_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from liteattention_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
    gpt_loss_fn,
    gpt_state_dict_from_jax,
)
from liteattention_torch.training.trainer import TrainConfig, Trainer  # noqa: E402

CFG = dict(vocab_size=128, max_position_embeddings=64, dim=64, num_layers=1, num_heads=2)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
B, S, STEPS = 4, 32, 3
WORLDS = (2, 4)
OPTIONS = {"plain": {}, "zero1": dict(shard_opt_state=True), "zero2": dict(shard_grads=True),
           "f32": dict(grad_comm_dtype="float32"), "bf16": dict(grad_comm_dtype="bfloat16")}
# (dp, option) of JAX's runs.
JAX_RUNS = [(4, "plain"), (4, "zero2"), (4, "bf16"), (2, "plain")]
# (option, dp) of the port's runs: every option at both, and ZeRO-2 with
# the bfloat16 wire at dp 2.
PORT_RUNS = [(o, n) for o in OPTIONS for n in WORLDS] + [("zero2_bf16", 2)]
LOSS_TOL, GN_TOL = 2e-3, 2e-2  # against JAX (its own bounds)
# The MoE GPT's capacity factors: 8.0 drops nothing, 0.5 drops about half.
MOE_FACTORS = {"no_drops": 8.0, "drops": 0.5}
MOE_RUNS = [(c, n) for c in MOE_FACTORS for n in WORLDS]


def _moe_cfg(case):
    return dict(CFG, moe_experts=4, moe_capacity_factor=MOE_FACTORS[case])


def _batches(n=STEPS, seed=0):
    it = jdata.synthetic_lm_batches(CFG["vocab_size"], B, S, seed=seed)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_init():
    model = JGPT(JGPTConfig(**CFG, dtype=jnp.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))
    return model, params


@pytest.fixture(scope="module")
def moe_jax(jax_init):
    """Per capacity case: the port's initial state dict (converted from one
    JAX init) and JAX's mesh Trainer's records at dp 2."""
    out = {}
    for case in MOE_FACTORS:
        model = JGPT(JGPTConfig(**_moe_cfg(case), dtype=jnp.float32))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32))
        params = {"params": variables["params"]}
        init = {k: v.numpy() for k, v in gpt_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items()}
        trainer = JTrainer(lambda p, batch, m=model: jgpt_loss_fn(m, p, batch, batch),
                           JTrainConfig(**TRAIN), mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)))
        recs = []
        trainer.fit(trainer.init_state(params), iter(_batches()), STEPS, log_every=1,
                    log_fn=recs.append)
        out[case] = init, recs
    return out


@pytest.fixture(scope="module")
def init(jax_init):
    return {k: v.numpy() for k, v in gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_init[1])).items()}


@pytest.fixture(scope="module")
def jax_runs(jax_init):
    model, params = jax_init

    def loss_fn(p, batch):
        return jce(model.apply(p, batch)[:, :-1], batch[:, 1:])

    out = {}
    for n, option in JAX_RUNS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
        trainer = JTrainer(loss_fn, JTrainConfig(**TRAIN, **OPTIONS[option]), mesh=mesh)
        recs = []
        trainer.fit(trainer.init_state(params), iter(_batches()), STEPS, log_every=1,
                    log_fn=recs.append)
        out[n, option] = recs
    return out


def _port_model(init):
    model = GPTLMHeadModel(GPTConfig(**CFG, dtype=torch.float32), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _loss(model, batch):
    return gpt_loss_fn(model, batch, batch)


@pytest.fixture(scope="module")
def one_rank(init):
    """The port's one-rank trainer on the same batches (norm monitor on)."""
    model = _port_model(init)
    trainer = Trainer(model, _loss, TrainConfig(**TRAIN, norm_monitor=True), device="cpu")
    recs = []
    trainer.fit(iter(_batches()), STEPS, log_every=1, log_fn=recs.append)
    return recs, {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("zero2_ckpt"))


@pytest.fixture(scope="module")
def ranks(init, ckpt_dir, moe_jax):
    base = dict(cfg=CFG, init=init, train=TRAIN, batches=_batches())
    cases = {n: [(f"{o}_{n}", dict(base, fn="trainer", options=kw)) for o, kw in OPTIONS.items()]
             for n in WORLDS}
    for case, n in MOE_RUNS:
        cases[n].append((f"moe_{case}_{n}", dict(base, fn="trainer", cfg=_moe_cfg(case),
                                                  init=moe_jax[case][0])))
    cases[2].append(("zero2_bf16_2", dict(base, fn="trainer",
                                          options=dict(shard_grads=True,
                                                       grad_comm_dtype="bfloat16"))))
    cases[2].append(("checkpoint", dict(base, fn="trainer_checkpoint", dir=ckpt_dir,
                                        options=dict(shard_grads=True),
                                        next=_batches(STEPS + 1)[-1])))
    return run_ranks(cases)


def _params_close(got, want, atol, d=CFG["dim"]):
    for name, w in want.items():
        g = got[name]
        if name.endswith("Wqkv.bias"):  # q | k | v: drop k (zero exact gradient)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def _shard_dim(shape, n):
    return next((i for i, s in enumerate(shape) if s % n == 0 and s >= n), None)


@pytest.mark.parametrize("option,n", PORT_RUNS)
def test_data_parallel_trainer_matches_jax_and_one_rank(ranks, jax_runs, one_rank, init, n,
                                                        option):
    res = [r[f"{option}_{n}"] for r in ranks[n]]
    kw = dict(shard_grads=True, grad_comm_dtype="bfloat16") if option == "zero2_bf16" \
        else OPTIONS[option]
    bf16 = kw.get("grad_comm_dtype") == "bfloat16"
    jrecs = jax_runs[4, "bf16"] if bf16 else jax_runs.get((n, option), jax_runs[n, "plain"])
    recs, final = one_rank
    for r in res[1:]:  # every rank computed the same update
        for k in final:
            np.testing.assert_array_equal(r["params"][k], res[0]["params"][k], err_msg=k)
        assert r["loss"] == res[0]["loss"] and r["grad_norm"] == res[0]["grad_norm"]
    got = res[0]
    for i, (j, o) in enumerate(zip(jrecs, recs)):
        assert abs(got["loss"][i] - j["loss"]) <= LOSS_TOL
        assert abs(got["grad_norm"][i] - j["grad_norm"]) <= GN_TOL * j["grad_norm"]
        assert abs(got["loss"][i] - o["loss"]) <= 1e-5 * o["loss"]
        gn_tol = 1e-3 if bf16 else 1e-5
        assert abs(got["grad_norm"][i] - o["grad_norm"]) <= gn_tol * o["grad_norm"]
        for mod, v in o["grad_norms"].items():
            assert abs(got["grad_norms"][i][mod] - v) <= gn_tol * v, mod
    _params_close(got["params"], final, 3e-3 if bf16 else 1e-5)
    # Each rank holds only its slice of each AdamW state tensor under ZeRO.
    zero = kw.get("shard_opt_state") or kw.get("shard_grads")
    for name, w in init.items():
        want = list(w.shape)
        d = _shard_dim(w.shape, n)
        if zero and d is not None:
            want[d] //= n
        for r in res:
            assert r["state_shapes"][name] == tuple(want), name
    assert any(_shard_dim(w.shape, n) is not None for w in init.values())


@pytest.mark.parametrize("case,n", MOE_RUNS)
def test_data_parallel_moe_routes_the_global_batch(ranks, moe_jax, case, n):
    init, jrecs = moe_jax[case]
    model = GPTLMHeadModel(GPTConfig(**_moe_cfg(case), dtype=torch.float32), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    trainer = Trainer(model, _loss, TrainConfig(**TRAIN), device="cpu")
    recs = []
    trainer.fit(iter(_batches()), STEPS, log_every=1, log_fn=recs.append)
    blk = model.transformer.blocks[0].mlp  # the one-rank run's last routing
    dropped = float(blk.dropped)
    assert (dropped > 0.1) == (case == "drops"), dropped
    res = [r[f"moe_{case}_{n}"] for r in ranks[n]]
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"] and r["grad_norm"] == res[0]["grad_norm"]
    got = res[0]
    for i, (j, o) in enumerate(zip(jrecs, recs)):
        assert abs(got["loss"][i] - j["loss"]) <= LOSS_TOL
        assert abs(got["grad_norm"][i] - j["grad_norm"]) <= GN_TOL * j["grad_norm"]
        assert abs(got["loss"][i] - o["loss"]) <= 1e-5 * o["loss"]
        assert abs(got["grad_norm"][i] - o["grad_norm"]) <= 1e-5 * o["grad_norm"]
    _params_close(got["params"], {k: v.detach().numpy() for k, v in model.state_dict().items()},
                  1e-5)


def test_zero2_checkpoint_is_the_one_rank_format(ranks, init, ckpt_dir):
    """Rank 0 wrote the whole state: a one-rank trainer resumes from it and
    takes the next step as the two ranks do; a fresh ZeRO-2 pair resumed it
    bit for bit."""
    res = [r["checkpoint"] for r in ranks[2]]
    model = _port_model(init)
    trainer = Trainer(model, _loss, TrainConfig(**TRAIN, checkpoint_dir=ckpt_dir), device="cpu")
    assert trainer.restore_or_init() == STEPS
    loss = float(trainer.train_step(t(_batches(STEPS + 1)[-1]))["loss"])
    for r in res:
        assert r["step"] == STEPS and r["same_state"]
        assert r["losses"][0] == r["losses"][1]
        assert abs(r["losses"][0] - loss) <= 1e-5 * loss
        _params_close(r["params"], {k: v.detach().numpy() for k, v in model.state_dict().items()},
                      1e-5)


def test_mesh_options_without_a_mesh_change_nothing(init, one_rank):
    """As in JAX, the ZeRO and wire options need a mesh; without one the
    trainer is the one-rank trainer, bit for bit."""
    recs, final = one_rank
    for kw in OPTIONS.values():
        model = _port_model(init)
        trainer = Trainer(model, _loss, TrainConfig(**TRAIN, norm_monitor=True, **kw),
                          device="cpu")
        got = []
        trainer.fit(iter(_batches()), STEPS, log_every=1, log_fn=got.append)
        assert [r["loss"] for r in got] == [r["loss"] for r in recs]
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), final[k], err_msg=k)


def test_dataclass_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]
