"""Port parity: the Wan2.1 DiT slice (liteattention_torch.models) against
the JAX model, with the JAX params converted by wan_state_dict_from_jax.

Test width, f32: dim 128, 2 heads x 64, 2 layers, ffn 256, text 16 x 64,
BlockSizes(128, 128); latents 7 x 20 x 20 -> 700 tokens, 6 fine tiles
with a ragged tail. Tolerances: outputs within 1e-4 rel-L2 (f32, summation
order only); per-layer masks identical; the per-step sparsity (an f32
mean over layers) within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.models.pipeline import denoise as jdenoise  # noqa: E402
from liteattention_tpu.models.wan import (  # noqa: E402
    WanConfig as JWanConfig,
    WanModel as JWanModel,
    init_skip_states as jinit_states,
)
from liteattention_torch.models import (  # noqa: E402
    WanConfig,
    WanModel,
    denoise,
    init_skip_states,
    wan_state_dict_from_jax,
)

GRID = (7, 20, 20)
# Log2 thresholds that skip part of the tiles of this random-weight model
# (its attention is near-uniform, so the useful range is above 0).
THRESHOLDS = [0.5, 1.0, 1.5]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JWanConfig.tiny(), dtype=jnp.float32)
    pcfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32)
    rng = np.random.RandomState(0)
    lat = rng.randn(1, *GRID, 16).astype(np.float32)
    text = rng.randn(1, 16, 64).astype(np.float32)
    jmodel = JWanModel(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(lat),
        jnp.full((1,), 999.0, jnp.float32), jnp.asarray(text),
    )
    pmodel = WanModel(pcfg, device="cpu")
    pmodel.load_state_dict(
        wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    )  # strict: every key converted, none left over
    return jmodel, params, pmodel, lat, text


@pytest.mark.parametrize("threshold", [None, 1.0])
def test_wan_forward_matches_jax(models, threshold):
    jmodel, params, pmodel, lat, text = models
    tt = np.full((1,), 500.0, np.float32)
    jst = pst = None
    if threshold is not None:
        jst = jinit_states(jmodel.cfg, 1, GRID)
        pst = init_skip_states(pmodel.cfg, 1, GRID, device="cpu")
    jo, jns = jmodel.apply(
        params, jnp.asarray(lat), jnp.asarray(tt), jnp.asarray(text), jst,
        threshold if threshold is not None else -10.0,
    )
    with torch.no_grad():
        po, pns = pmodel(
            t(lat), t(tt), t(text), pst,
            threshold if threshold is not None else -10.0,
        )
    assert po.shape == lat.shape
    assert rel_l2(po.numpy(), jo) < 1e-4
    if threshold is not None:
        for i in range(2):
            np.testing.assert_array_equal(
                pns[i].do_mask.numpy(), np.asarray(jns[i].do_mask)
            )
        assert 0.0 < 1.0 - float(pns[0].do_mask.float().mean()) < 1.0


def test_denoise_matches_jax(models):
    jmodel, params, pmodel, lat, text = models
    null = np.zeros_like(text)
    kw = dict(num_steps=3, vote_stride=2)
    jx, jtel = jax.jit(
        lambda p, n, tx, u: jdenoise(
            jmodel, p, n, tx, u, thresholds=jnp.asarray(THRESHOLDS), **kw
        )
    )(params, jnp.asarray(lat), jnp.asarray(text), jnp.asarray(null))
    px, ptel = denoise(
        pmodel, t(lat), t(text), t(null), thresholds=THRESHOLDS, **kw
    )
    assert rel_l2(px.numpy(), jx) < 1e-4
    sp = ptel["sparsity_per_step"].numpy()
    np.testing.assert_allclose(
        sp, np.asarray(jtel["sparsity_per_step"]), atol=1e-6, rtol=0
    )
    assert sp[-1] > sp[0] > 0.0  # skipping, rising at the second vote
    for key in ("final_states", "final_states_uncond"):
        for i in range(2):
            np.testing.assert_array_equal(
                ptel[key][i].do_mask.numpy(), np.asarray(jtel[key][i].do_mask)
            )


def test_denoise_step_range_resumes(models):
    # Steps [0, 2) then [2, 3) from the carried states equal one 3-step
    # run: with vote_stride 2 both vote at steps 0 and 2.
    _, _, pmodel, lat, text = models
    null = np.zeros_like(text)
    kw = dict(num_steps=3, vote_stride=2, thresholds=THRESHOLDS)
    full, tel = denoise(pmodel, t(lat), t(text), t(null), **kw)
    x, t1 = denoise(pmodel, t(lat), t(text), t(null), step_range=(0, 2), **kw)
    x, t2 = denoise(
        pmodel, x, t(text), t(null), step_range=(2, 3),
        initial_states=t1["final_states"],
        initial_states_uncond=t1["final_states_uncond"], **kw,
    )
    assert torch.equal(x, full)
    for i in range(2):
        assert torch.equal(
            t2["final_states"][i].do_mask, tel["final_states"][i].do_mask
        )


def test_denoise_dense_equals_full_mask_lite(models):
    # At threshold -inf nothing is skipped: the lite path is the dense one.
    _, _, pmodel, lat, text = models
    kw = dict(num_steps=2, guidance_scale=5.0)
    dense, tel = denoise(pmodel, t(lat), t(text), t(text) * 0, enable_skipping=False, **kw)
    lite, tel2 = denoise(
        pmodel, t(lat), t(text), t(text) * 0, thresholds=[-np.inf] * 2, **kw
    )
    assert rel_l2(lite.numpy(), dense.numpy()) < 1e-6
    assert tel["final_states"] is None
    assert (tel2["sparsity_per_step"] == 0).all()


def test_unported_options_raise():
    # Every option is ported: remat and the probe
    # (tests/test_torch_wan_train.py), the I2V inputs
    # (tests/test_torch_wan_i2v.py) and sequence parallelism
    # (tests/test_torch_parallel.py), which needs the DeviceMesh whose dim
    # sp_axis names.
    for opt in (dict(remat=True), dict(attn_probe_rows=4)):
        WanModel(dataclasses.replace(WanConfig.tiny(), **opt), device="cpu")
    with pytest.raises(ValueError, match="needs the DeviceMesh"):
        WanModel(dataclasses.replace(WanConfig.tiny(), sp_axis="sp"), device="cpu")
