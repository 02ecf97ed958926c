"""Port parity: ``parallel/pipeline.py`` (``pipeline_apply``,
``pipeline_apply_local``) on gloo ranks, against the JAX package's
``pipeline_apply`` on the conftest's virtual CPU devices.

JAX's own cases (``tests/test_pipeline_parallel.py``): stages ``tanh(x @
w + b)``, n ranks and m microbatches (4, 4) and (4, 8), and at two ranks
(2, 2) and (2, 4); the output and, for the loss ``sum(y^2)``, the
gradients of the stacked ``w`` and ``b`` and of ``x`` against
``jax.grad``, and against the stages run one after another. The port's
ranks run in one spawn of 4 ranks (``tests/_torch_dist_train.py``), the
2-rank cases on ranks 0 and 1. Tolerance (fp32): 1e-5, JAX's own bound
against its sequential model.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from _torch_dist_train import run_ranks  # noqa: E402
from liteattention_tpu.parallel.pipeline import pipeline_apply as jpipeline  # noqa: E402

TOL = 1e-5
# (n ranks, m microbatches)
CASES = [(4, 4), (4, 8), (2, 2), (2, 4)]
DIM, BATCH = 8, 16


def _inputs(n, m):
    rng = np.random.RandomState(10 * n + m)
    return dict(w=(rng.randn(n, DIM, DIM) * 0.5).astype(np.float32),
                b=(rng.randn(n, DIM) * 0.1).astype(np.float32),
                x=rng.randn(BATCH, DIM).astype(np.float32), m=m)


def _stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _sequential(w, b, x):
    for i in range(w.shape[0]):
        x = np.tanh(x @ w[i] + b[i])
    return x


@pytest.fixture(scope="module")
def inputs():
    out = {4: {}, 2: {}}
    for n, m in CASES:
        out[n][f"pipeline_{n}_{m}"] = dict(_inputs(n, m), fn="pipeline")
        out[n][f"module_{n}_{m}"] = dict(_inputs(n, m), fn="pipeline_module")
    for n in out:
        out[n]["pipeline_raises"] = {}
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks({n: list(cases.items()) for n, cases in inputs.items()})


def _jax(p, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    args = tuple(jnp.asarray(p[k]) for k in ("w", "b", "x"))

    def loss(w, b, x):
        y = jpipeline(_stage, (w, b), x, mesh, "pp", num_microbatches=p["m"])
        return jnp.sum(y ** 2), y

    grads, y = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(y)] + [np.asarray(g) for g in grads]


def _torch_sequential(p):
    w, b, x = (torch.from_numpy(p[k]).requires_grad_() for k in ("w", "b", "x"))
    y = x
    for i in range(w.shape[0]):
        y = torch.tanh(y @ w[i] + b[i])
    (y ** 2).sum().backward()
    return [y.detach().numpy(), w.grad.numpy(), b.grad.numpy(), x.grad.numpy()]


@pytest.mark.parametrize("n,m", CASES)
def test_pipeline_matches_jax(ranks, inputs, n, m):
    p = inputs[n][f"pipeline_{n}_{m}"]
    want = _jax(p, n)
    seq = _torch_sequential(p)
    np.testing.assert_allclose(seq[0], _sequential(p["w"], p["b"], p["x"]), atol=TOL)
    for r, res in enumerate(ranks[n]):
        got = res[f"pipeline_{n}_{m}"]
        for g, j, s, name in zip(got, want, seq, ("y", "dw", "db", "dx")):
            np.testing.assert_allclose(g, j, atol=TOL, rtol=TOL, err_msg=f"rank {r} {name}")
            np.testing.assert_allclose(g, s, atol=TOL, rtol=TOL, err_msg=f"rank {r} {name}")
        np.testing.assert_array_equal(got[4], got[0])  # no_grad's schedule: the same y


@pytest.mark.parametrize("n,m", CASES)
def test_module_stage_gets_its_sequential_gradients(ranks, inputs, n, m):
    p = inputs[n][f"module_{n}_{m}"]
    y, dw, db, dx = _torch_sequential(p)
    for r, res in enumerate(ranks[n]):
        got = res[f"module_{n}_{m}"]
        np.testing.assert_allclose(got[0], y, atol=TOL, rtol=TOL, err_msg=f"rank {r} y")
        # x is read by stage 0: its gradient lands on rank 0.
        np.testing.assert_allclose(got[1], dx if r == 0 else 0 * dx, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[2], dw[r], atol=TOL, rtol=TOL, err_msg=f"rank {r} dw")
        np.testing.assert_allclose(got[3], db[r], atol=TOL, rtol=TOL, err_msg=f"rank {r} db")


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_raises_on_every_rank(ranks, n):
    for res in ranks[n]:
        stages, batch, shape = res["pipeline_raises"]
        assert f"has {n + 1} stages" in stages
        assert "batch 7 does not split into 2" in batch
        assert "keep their input's shape" in shape
