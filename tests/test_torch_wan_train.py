"""Port parity of the Wan training path: ``WanConfig.remat``, the fp32
master weights of a bf16-compute model (``model.float()``), the attention
probe ``WanConfig.attn_probe_rows``, and the training pieces of
``examples/torch_structured_calibration.py``, against the JAX model and
optax on the same numpy inputs, with the JAX params converted by
``wan_state_dict_from_jax``.

Tolerances: fp32 on both sides, losses within 1e-5 relative and each
gradient leaf within 1e-4 rel-L2 (summation order only). bf16 products
against JAX's bf16 model (the port's plain attention keeps P in fp32, JAX's
interpreted kernels round it to bf16): the loss within 1e-2 relative and
each gradient leaf within 5e-2 rel-L2, the bound of a bf16 gradient
against an fp32 one (JAX's own bf16 gradients sit up to 2.9e-2 from its
fp32 ones at this shape). Remat against no remat in the port: each leaf
scaled by its max within 2e-2, the bound of the JAX package's remat test
(tests/test_wan_model.py). Probe values: fp32, within 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from _torch_port import load_example, rel_l2, t  # noqa: E402
from liteattention_tpu.models.wan import (  # noqa: E402
    WanConfig as JWanConfig,
    WanModel as JWanModel,
)
from liteattention_torch.models import WanConfig, WanModel, wan_state_dict_from_jax  # noqa: E402
from liteattention_torch.modules.dense import Dense  # noqa: E402

GRID = (2, 16, 20)  # 160 tokens: one full 128-key tile and a ragged one
PROBE_GRID = (2, 32, 32)  # the JAX test's probe shape: 512 tokens, 4 tiles


def _inputs(grid, seed=0):
    rng = np.random.RandomState(seed)
    lat = rng.randn(1, *grid, 16).astype(np.float32)
    text = rng.randn(1, 16, 64).astype(np.float32)
    tt = np.full((1,), 500.0, np.float32)
    return lat, tt, text


def _pair(grid, fp32=True, **cfg_kw):
    """(JAX model, params, port model with the same weights, inputs). fp32:
    both sides fp32; else JAX's bf16 tiny config (fp32 params) against the
    port's bf16 config made fp32 by ``model.float()``."""
    jcfg = dataclasses.replace(JWanConfig.tiny(), **cfg_kw)
    pcfg = dataclasses.replace(WanConfig.tiny(), **cfg_kw)
    if fp32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        pcfg = dataclasses.replace(pcfg, dtype=torch.float32)
    lat, tt, text = _inputs(grid)
    jmodel = JWanModel(jcfg)
    params = jax.jit(JWanModel(dataclasses.replace(jcfg, remat=False, attn_probe_rows=0)).init)(
        jax.random.PRNGKey(2), jnp.asarray(lat), jnp.asarray(tt), jnp.asarray(text)
    )
    pmodel = WanModel(pcfg, device="cpu").float()  # fp32 first: the weights load exactly
    pmodel.load_state_dict(wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, pmodel, (lat, tt, text)


def _jax_loss_and_grads(jmodel, params, inputs):
    lat, tt, text = (jnp.asarray(x) for x in inputs)
    if jmodel.cfg.dtype == jnp.bfloat16:
        lat, text = lat.astype(jnp.bfloat16), text.astype(jnp.bfloat16)

    def loss(p):
        out, _ = jmodel.apply(p, lat, tt, text)
        return jnp.mean(out.astype(jnp.float32) ** 2)

    val, grads = jax.value_and_grad(loss)(params)
    return float(val), wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(pmodel, inputs):
    lat, tt, text = (t(x) for x in inputs)
    if pmodel.cfg.dtype == torch.bfloat16:
        lat, text = lat.bfloat16(), text.bfloat16()
    pmodel.zero_grad(set_to_none=True)
    out, _ = pmodel(lat, tt, text)
    loss = (out.float() ** 2).mean()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in pmodel.named_parameters()}


def _assert_scaled_close(got, ref, atol=2e-2):
    """Each leaf scaled by the reference's max, within ``atol`` (the JAX
    package's bf16 gradient bound)."""
    assert set(got) == set(ref)
    for name in ref:
        a, b = got[name].float().numpy(), np.asarray(ref[name], np.float32)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_value_and_grad_match_jax_fp32(remat):
    # The port's forward and backward (with and without remat) against JAX
    # value_and_grad with the same remat setting.
    jmodel, params, pmodel, inputs = _pair(GRID, remat=remat)
    jl, jg = _jax_loss_and_grads(jmodel, params, inputs)
    pl, pg = _port_loss_and_grads(pmodel, inputs)
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert set(pg) == set(jg)
    for name in jg:
        assert rel_l2(pg[name].numpy(), jg[name]) < 1e-4, name


def test_remat_matches_no_remat():
    # bf16 products from fp32 parameters: the recomputed forward gives the
    # gradients of the stored one (the JAX test's bound).
    _, _, pmodel, inputs = _pair(GRID, fp32=False)
    l0, g0 = _port_loss_and_grads(pmodel, inputs)
    pmodel.cfg = dataclasses.replace(pmodel.cfg, remat=True)
    l1, g1 = _port_loss_and_grads(pmodel, inputs)
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    _assert_scaled_close(g1, g0)


@pytest.mark.parametrize("remat", [False, True])
def test_fp32_master_weights_match_jax_bf16(remat):
    # JAX trains fp32 parameters at bf16 compute; model.float() is the
    # port's form of it: fp32 parameters and gradients, bf16 products.
    jmodel, params, pmodel, inputs = _pair(GRID, fp32=False, remat=remat)
    assert all(p.dtype == torch.float32 for p in pmodel.parameters())
    jl, jg = _jax_loss_and_grads(jmodel, params, inputs)
    pl, pg = _port_loss_and_grads(pmodel, inputs)
    assert abs(pl - jl) <= 1e-2 * abs(jl)
    assert all(g.dtype == torch.float32 for g in pg.values())
    assert set(pg) == set(jg)
    for name in jg:
        assert rel_l2(pg[name].numpy(), jg[name]) < 5e-2, name


def test_bf16_held_model_is_unchanged():
    # Held in bf16 (the inference form) the linears cast nothing: the
    # output equals, bit for bit, that of plain nn.Linear products.
    torch.manual_seed(0)
    model = WanModel(WanConfig.tiny(), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(3))
    dense = [m for m in model.modules() if isinstance(m, Dense)]
    assert dense and all(m.weight.dtype == torch.bfloat16 for m in dense)
    lat, tt, text = (t(x) for x in _inputs(GRID))
    with torch.no_grad():
        out, _ = model(lat.bfloat16(), tt, text.bfloat16())
        for m in dense:
            m.forward = lambda x, m=m: F.linear(x, m.weight, m.bias)
        ref, _ = model(lat.bfloat16(), tt, text.bfloat16())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


def _jax_probe(jmodel, params, inputs, rows):
    lat, tt, text = (jnp.asarray(x) for x in inputs)
    probe = JWanModel(dataclasses.replace(jmodel.cfg, attn_probe_rows=rows))

    def collect(tree, name):
        found = []
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == name:
                    found.extend(jax.tree_util.tree_leaves(v))
                else:
                    found.extend(collect(v, name))
        return found

    (out, _), inter = probe.apply(params, lat, tt, text, mutable=["intermediates"])
    inter = dict(inter["intermediates"])
    vals = {n: [float(x) for x in collect(inter, n)] for n in ("attn_entropy", "attn_tile_excess")}

    def ent_loss(p):
        _, i2 = probe.apply(p, lat, tt, text, mutable=["intermediates"])
        return jnp.sum(jnp.stack(collect(dict(i2["intermediates"]), "attn_entropy")))

    grads = jax.grad(ent_loss)(params)
    return np.asarray(out), vals, wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("remat", [False, True])
def test_attn_probe_matches_jax(remat):
    # 8 probed rows at the JAX test's shape (512 tokens, 4 key tiles):
    # per-layer entropy and tile excess as JAX sows them, the output
    # untouched by the probe, and the entropy's gradient.
    jmodel, params, pmodel, inputs = _pair(PROBE_GRID, remat=remat, attn_probe_rows=8)
    jout, jvals, jgrads = _jax_probe(jmodel, params, inputs, 8)
    lat, tt, text = (t(x) for x in inputs)
    out, _ = pmodel(lat, tt, text)
    inter = pmodel.intermediates
    assert set(inter) == set(jvals)
    for name, ref in jvals.items():
        assert len(ref) == len(inter[name]) == 2
        np.testing.assert_allclose([v.item() for v in inter[name]], ref, rtol=1e-5, err_msg=name)
    assert all(0.0 <= v.item() <= np.log(512) + 1e-3 for v in inter["attn_entropy"])
    assert all(v.item() > 0.0 for v in inter["attn_tile_excess"])
    assert rel_l2(out.detach().numpy(), jout) < 1e-4
    plain = WanModel(dataclasses.replace(pmodel.cfg, attn_probe_rows=0), device="cpu")
    plain.load_state_dict(pmodel.state_dict())
    with torch.no_grad():
        assert torch.equal(plain(lat, tt, text)[0], out.detach())
    pmodel.zero_grad(set_to_none=True)
    torch.stack(inter["attn_entropy"]).sum().backward()
    assert pmodel.blocks[0].self_attn.q.weight.grad.abs().sum() > 0
    # The model gathered the probes; a remat recompute leaves none behind.
    assert all("probe" not in vars(b.self_attn) for b in pmodel.blocks)
    for name, ref in jgrads.items():
        got, ref = pmodel.get_parameter(name).grad, ref.numpy()
        if not ref.any():
            assert got is None or not got.any(), name
            continue
        assert rel_l2(got.numpy(), ref) < 1e-4, name


def test_probe_off_with_skip_states():
    # JAX probes only dense self-attention: with skip states nothing is
    # gathered.
    from liteattention_torch.models import init_skip_states

    model = WanModel(dataclasses.replace(WanConfig.tiny(), dtype=torch.float32,
                                         attn_probe_rows=8), device="cpu")
    lat, tt, text = (t(x) for x in _inputs(PROBE_GRID))
    with torch.no_grad():
        model(lat, tt, text, init_skip_states(model.cfg, 1, PROBE_GRID, device="cpu"), -10.0)
    assert model.intermediates == {"attn_entropy": [], "attn_tile_excess": []}


def test_lr_schedule_matches_optax():
    # optax computes in fp32: within rtol 1e-5 and atol 1e-10 (3e-7 of the
    # peak, where the cosine nears 0).
    ex = load_example("torch_structured_calibration")
    steps = 3000
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 100, steps)
    for step in (0, 1, 50, 99, 100, 101, 1500, steps - 1, steps, steps + 10):
        np.testing.assert_allclose(ex.warmup_cosine_decay(step, 3e-4, 100, steps),
                                   float(ref(step)), rtol=1e-5, atol=1e-10, err_msg=str(step))
    # The optimizer takes step k's rate at its k-th update, from 0.
    model = torch.nn.Linear(2, 2)
    opt, sched = ex.adamw(model, steps)
    rates = []
    for _ in range(102):
        rates.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(rates, [float(ref(s)) for s in range(102)], rtol=1e-5, atol=1e-10)


def test_adamw_step_matches_optax():
    # One torch AdamW update against optax.adamw(weight_decay=0.01) on the
    # same parameters and gradients.
    ex = load_example("torch_structured_calibration")
    rng = np.random.RandomState(4)
    w, g = rng.randn(8, 4).astype(np.float32), rng.randn(8, 4).astype(np.float32)
    param = torch.nn.Parameter(t(w))
    opt = torch.optim.AdamW([param], lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    ref_opt = optax.adamw(1e-3, weight_decay=0.01)
    state = ref_opt.init(jnp.asarray(w))
    p = jnp.asarray(w)
    for _ in range(3):
        param.grad = t(g)
        opt.step()
        upd, state = ref_opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p), rtol=1e-5, atol=1e-7)
    assert ex.adamw(torch.nn.Linear(2, 2), 10)[0].defaults["weight_decay"] == 0.01


def test_flow_loss_regularisers():
    # The example's loss reads the probe: entropy above the target and the
    # tile excess add to the MSE term, and their gradient reaches q.
    ex = load_example("torch_structured_calibration")
    cfg = dataclasses.replace(WanConfig.tiny(), attn_probe_rows=8)
    model = WanModel(cfg, device="cpu").float()
    model.reset_parameters(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn(1, *PROBE_GRID, 16, generator=g).bfloat16()
    noise = torch.randn(x0.shape, generator=g)
    sig = torch.rand(1, 1, 1, 1, 1, generator=g)
    text = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    plain, main, ent = ex.flow_loss(model, x0, noise, sig, text)
    assert torch.equal(plain, main) and ent > 0
    loss, main2, _ = ex.flow_loss(model, x0, noise, sig, text, entropy_reg=0.5,
                                  entropy_target=0.0, tile_reg=0.25)
    inter = model.intermediates
    want = (main2 + 0.5 * torch.stack(inter["attn_entropy"]).mean()
            + 0.25 * torch.stack(inter["attn_tile_excess"]).mean())
    torch.testing.assert_close(loss, want)
    (loss - main2).backward()
    assert model.blocks[0].self_attn.q.weight.grad.abs().sum() > 0


def test_structured_calibration_main_on_cpu(tmp_path):
    ex = load_example("torch_structured_calibration")
    out = tmp_path / "cal.json"
    art = ex.main(["--device", "cpu", "--train-steps", "3", "--batch", "2", "--frames", "4",
                   "--size", "16", "--eval-steps", "2", "--entropy-reg", "0.05",
                   "--entropy-target", "4.5", "--tile-reg", "0.03", "--e2e",
                   "--out", str(out)])
    assert out.exists()
    assert art["workload"]["tokens"] == 256 and art["workload"]["train_steps"] == 3
    assert np.isfinite(art["workload"]["final_train_loss"])
    assert [r["threshold"] for r in art["curve"]] == ex.SWEEP_THRESHOLDS
    assert len(art["calibrated"]["schedule"]) == 2
    assert art["e2e"]["tokens"] == 256
    # The transfer check re-reads an artifact's schedule.
    art2 = ex.main(["--device", "cpu", "--train-steps", "1", "--batch", "1", "--frames", "2",
                    "--size", "16", "--eval-steps", "3", "--eval-schedule", str(out),
                    "--out", str(tmp_path / "cal2.json")])
    assert art2["transfer"]["source_tokens"] == 256
    with pytest.raises(SystemExit):
        ex.main(["--device", "cpu", "--out", str(tmp_path / "CALIBRATION_R5_4K.json")])
