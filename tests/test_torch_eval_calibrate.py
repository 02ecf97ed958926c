"""Port parity of ``liteattention_torch.models.eval`` and
``liteattention_torch.models.calibrate`` against the JAX modules, and the
port's ``examples/torch_wan_e2e_speed.py`` run on the CPU.

The tiny Wan config in fp32 on both sides, the JAX params converted by
``wan_state_dict_from_jax``; latents 7 x 20 x 20 -> 700 tokens (6 fine
tiles, a ragged tail). The JAX functions call ``denoise`` as they are;
the tests hand them a jitted ``denoise`` so that the interpreted kernels
compile once. Tolerances: the metric functions within 1e-5 relative
(fp32); rel-L2, flicker and subject consistency of a sparse run within
1e-3 relative (the latents agree within 1e-4 rel-L2, tests/test_torch_wan.py)
and sparsities within 1e-6 (an fp32 mean); PSNR within 0.01 dB where the
runs differ (rel-L2 > 1e-4); the calibrators' probed thresholds within
1e-5 (fp32 linspace against Python floats), the same order and the same
choices. A full mask reads sparsity 0 in the port and -7.45e-9 in JAX,
and JAX's lite run at a full mask is 1.6e-7 from its dense one where the
port's is 0 (ROADMAP C); both are inside these tolerances except PSNR,
which is compared only where the runs differ.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import liteattention_tpu.models.calibrate as jcal  # noqa: E402
import liteattention_tpu.models.eval as jeval  # noqa: E402
import liteattention_torch.models.calibrate as pcal  # noqa: E402
import liteattention_torch.models.eval as peval  # noqa: E402
from _torch_port import load_example, t  # noqa: E402
from liteattention_tpu.models.pipeline import denoise as jdenoise  # noqa: E402
from liteattention_tpu.models.wan import (  # noqa: E402
    WanConfig as JWanConfig,
    WanModel as JWanModel,
)
from liteattention_torch.models import WanConfig, WanModel, wan_state_dict_from_jax  # noqa: E402

GRID = (7, 20, 20)
STEPS = 3


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JWanConfig.tiny(), dtype=jnp.float32)
    pcfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32)
    rng = np.random.RandomState(0)
    lat = rng.randn(1, *GRID, 16).astype(np.float32)
    text = rng.randn(1, 16, 64).astype(np.float32)
    null = rng.randn(1, 16, 64).astype(np.float32)
    jmodel = JWanModel(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(lat), jnp.full((1,), 999.0, jnp.float32),
        jnp.asarray(text),
    )
    pmodel = WanModel(pcfg, device="cpu")
    pmodel.load_state_dict(wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, pmodel, lat, text, null


@pytest.fixture
def jit_denoise(monkeypatch):
    monkeypatch.setattr(jeval, "denoise", jax.jit(
        jdenoise, static_argnums=(0,),
        static_argnames=("num_steps", "enable_skipping", "vote_stride")))


def _record(monkeypatch, module):
    """Log the thresholds of every evaluate_sparsity_quality call that
    ``module`` makes."""
    calls = []
    inner = module.evaluate_sparsity_quality

    def wrapper(*args, **kw):
        calls.append(np.asarray(kw["thresholds"], np.float32))
        return inner(*args, **kw)

    monkeypatch.setattr(module, "evaluate_sparsity_quality", wrapper)
    return calls


@pytest.mark.parametrize("name", ["latent_psnr", "relative_l2", "temporal_flicker_delta",
                                  "subject_consistency_delta"])
def test_metrics_match_jax(name):
    rng = np.random.RandomState(1)
    b = rng.randn(2, 5, 6, 7, 4).astype(np.float32)
    a = (b + 0.1 * rng.randn(*b.shape)).astype(np.float32)
    got = getattr(peval, name)(t(a), t(b))
    ref = getattr(jeval, name)(jnp.asarray(a), jnp.asarray(b))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    # bf16 inputs are measured in fp32.
    got16 = getattr(peval, name)(t(a).bfloat16(), t(b).bfloat16())
    ref16 = getattr(jeval, name)(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_allclose(got16.item(), float(ref16), rtol=1e-5)


def _check_result(got, ref):
    np.testing.assert_allclose(float(got["mean_sparsity"]), float(ref["mean_sparsity"]), atol=1e-6)
    np.testing.assert_allclose(float(got["final_sparsity"]), float(ref["final_sparsity"]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got["sparsity_per_step"]),
                               np.asarray(ref["sparsity_per_step"]), atol=1e-6)
    for key in ("relative_l2", "temporal_flicker", "subject_consistency_delta"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-3, atol=1e-6,
                                   err_msg=key)
    if float(ref["relative_l2"]) > 1e-4:
        np.testing.assert_allclose(float(got["psnr_db"]), float(ref["psnr_db"]), atol=1e-2)


@pytest.mark.parametrize("cfg_guidance", [False, True])
def test_evaluate_sparsity_quality_matches_jax(models, jit_denoise, cfg_guidance):
    jmodel, params, pmodel, lat, text, null = models
    thr = [0.5, 1.0, 1.5]
    kw = dict(num_steps=STEPS, vote_stride=2)
    jnull, pnull = (jnp.asarray(null), t(null)) if cfg_guidance else (None, None)
    ref = jeval.evaluate_sparsity_quality(jmodel, params, jnp.asarray(lat), jnp.asarray(text),
                                          jnull, thresholds=jnp.asarray(thr), **kw)
    got = peval.evaluate_sparsity_quality(pmodel, t(lat), t(text), pnull, thresholds=thr, **kw)
    assert set(got) == set(ref)
    assert float(got["mean_sparsity"]) > 0.0 and float(got["relative_l2"]) > 1e-4
    _check_result(got, ref)


def test_threshold_sweep_matches_jax(models, jit_denoise):
    jmodel, params, pmodel, lat, text, _ = models
    thrs = [-10.0, 0.25, 1.0, 2.0]
    ref = jeval.threshold_sweep(jmodel, params, jnp.asarray(lat), jnp.asarray(text),
                                thresholds_list=thrs, num_steps=STEPS)
    got = peval.threshold_sweep(pmodel, t(lat), t(text), thresholds_list=thrs, num_steps=STEPS)
    assert [r["threshold"] for r in got] == thrs
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert all(isinstance(g[k], float) for k in ("relative_l2", "mean_sparsity", "psnr_db"))
        _check_result(g, r)
    assert got[0]["mean_sparsity"] == 0.0 and got[-1]["mean_sparsity"] > 0.5


# (budget, bisection kwargs): a bisection that ends inside the range, the
# loosest threshold already within the budget, and a budget that even the
# tightest one misses (the warning).
CASES = [(5e-3, {}), (5e-2, {}), (1e-4, dict(lo=0.5))]


@pytest.mark.parametrize("budget,kw", CASES)
def test_calibrate_constant_threshold_matches_jax(models, jit_denoise, monkeypatch, budget, kw):
    jmodel, params, pmodel, lat, text, _ = models
    jcalls, pcalls = _record(monkeypatch, jcal), _record(monkeypatch, pcal)
    ref = jcal.calibrate_constant_threshold(jmodel, params, jnp.asarray(lat), jnp.asarray(text),
                                            target_rel_l2=budget, num_steps=STEPS, **kw)
    got = pcal.calibrate_constant_threshold(pmodel, t(lat), t(text), target_rel_l2=budget,
                                            num_steps=STEPS, **kw)
    assert len(pcalls) == len(jcalls)
    np.testing.assert_allclose(np.stack(pcalls), np.stack(jcalls), atol=1e-5)
    assert set(got) == set(ref)
    assert got["threshold"] == float(ref["threshold"])
    np.testing.assert_allclose(got["relative_l2"], float(ref["relative_l2"]), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(got["mean_sparsity"], float(ref["mean_sparsity"]), atol=1e-6)
    if budget == 5e-3:
        assert len(pcalls) == 7 and -12.0 < got["threshold"] < 2.0
    assert ("warning" in got) == (budget == 1e-4)


def test_calibrate_schedule_matches_jax(models, jit_denoise, monkeypatch):
    # The port differs from JAX only where the delta-0 schedule misses the
    # budget: JAX ships it, the port lowers the constant first (or warns;
    # test_calibrate_schedule_tightens_a_missing_schedule). Here it fits,
    # so the two must make the same calls and ship the same schedule.
    jmodel, params, pmodel, lat, text, _ = models
    jcalls, pcalls = _record(monkeypatch, jcal), _record(monkeypatch, pcal)
    kw = dict(num_steps=4, target_rel_l2=5e-3, iters=3, loosen_iters=2)
    jsched, ref = jcal.calibrate_schedule(jmodel, params, jnp.asarray(lat), jnp.asarray(text), **kw)
    psched, got = pcal.calibrate_schedule(pmodel, t(lat), t(text), **kw)
    assert len(pcalls) == len(jcalls) > 6
    np.testing.assert_allclose(np.stack(pcalls), np.stack(jcalls), atol=1e-5)
    assert psched.dtype == torch.float32 and psched.shape == (4,)
    np.testing.assert_allclose(psched.numpy(), np.asarray(jsched), atol=1e-5)
    assert set(got) == set(ref)
    assert got["threshold"] == float(ref["threshold"])
    assert got["loosen_delta"] == float(ref["loosen_delta"])
    for key in ("relative_l2", "temporal_flicker"):
        np.testing.assert_allclose(got[key], float(ref[key]), rtol=1e-3, atol=1e-6, err_msg=key)
    for key in ("mean_sparsity", "final_sparsity"):
        np.testing.assert_allclose(got[key], float(ref[key]), atol=1e-6, err_msg=key)
    # JAX's shipped schedule fits too: the case where the two cannot differ.
    assert got["relative_l2"] <= 5e-3 and float(ref["relative_l2"]) <= 5e-3


def test_calibrate_schedule_tightens_a_missing_schedule(models, monkeypatch):
    # A constant forced past the border (the loosest threshold, 2.0): the
    # delta-0 schedule built on it misses the budget, which JAX would ship.
    # The port lowers the constant in steps of 1 until the schedule fits,
    # and reports the shipped schedule's numbers; a schedule that still
    # misses after the tries carries a warning.
    _, _, pmodel, lat, text, _ = models
    forced = {"threshold": 2.0, "relative_l2": 0.0, "mean_sparsity": 0.0}
    monkeypatch.setattr(pcal, "calibrate_constant_threshold", lambda *a, **k: dict(forced))
    calls = _record(monkeypatch, pcal)
    budget = 1e-3
    kw = dict(num_steps=4, target_rel_l2=budget, loosen_iters=2)
    miss = peval.evaluate_sparsity_quality(pmodel, t(lat), t(text), num_steps=4,
                                           thresholds=[-2.0, 2.0, 2.0, 2.0])
    assert float(miss["relative_l2"]) > budget  # the forced constant's delta-0 schedule misses
    for tries in (4, 1):
        calls.clear()
        monkeypatch.setattr(pcal, "TIGHTEN_TRIES", tries)
        sched, got = pcal.calibrate_schedule(pmodel, t(lat), t(text), **kw)
        delta0 = [c for c in calls if c[-1] == c[1]]  # the delta-0 schedules tried, in order
        np.testing.assert_allclose(delta0[0], [-2.0, 2.0, 2.0, 2.0])
        assert 2 <= len(delta0) <= tries + 1
        assert got["threshold"] == 2.0 - (len(delta0) - 1)
        shipped = peval.evaluate_sparsity_quality(pmodel, t(lat), t(text), num_steps=4,
                                                  thresholds=sched.tolist())
        np.testing.assert_allclose(got["relative_l2"], float(shipped["relative_l2"]), rtol=1e-6)
        assert ("warning" in got) == (got["relative_l2"] > budget)
        if tries == 4:
            assert "warning" not in got and got["relative_l2"] <= budget


def test_wan_e2e_speed_main_on_cpu(tmp_path, monkeypatch):
    # The 14B geometry is the script's; on the CPU it runs at the tiny one.
    ex = load_example("torch_wan_e2e_speed")
    monkeypatch.setattr(ex, "WanConfig", WanConfig.tiny)
    out = tmp_path / "e2e.json"
    art = ex.main(["--device", "cpu", "--frames", "4", "--height", "16", "--width", "32",
                   "--steps", "2", "--vote-stride", "1", "--out", str(out)])
    assert out.exists() and art["tokens"] == 512
    assert [r["threshold"] for r in art["threshold_curve"]] == ex.THRESHOLDS
    band = [r["sparsity"] for r in art["banded_curve"]]
    assert len(band) == 5 and band[0] == 0.0 and band == sorted(band) and band[-1] > 0.5
    assert art["dense_ms_per_step"] > 0
    with pytest.raises(SystemExit):
        ex.main(["--device", "cpu", "--out", str(tmp_path / "E2E_ABLATION.json")])
