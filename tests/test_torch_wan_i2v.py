"""Port parity: the Wan image-to-video paths and the Wan2.2 two-expert
pipeline (liteattention_torch.models) against the JAX package, and the
Wan checkpoint remap (liteattention_torch.utils.pretrained).

Test width, f32: ``WanConfig.tiny()`` (dim 128, 2 heads x 64, 2 layers,
ffn 256, text 16 x 64, BlockSizes(128, 128)); latents 7 x 20 x 20 -> 700
tokens (6 fine tiles, a ragged tail) with 4 conditioning channels, so the
port's ``in_channels`` is 20; 5 CLIP-like image tokens of width 48 (not
the text width, so that a mixed-up width cannot pass). JAX params are
converted by ``wan_state_dict_from_jax``. Tolerances: outputs within
1e-4 rel-L2 (f32, summation order only), as for text-to-video
(tests/test_torch_wan.py); masks identical; sparsity within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.models.pipeline import (  # noqa: E402
    denoise as jdenoise,
    denoise_two_expert as jdenoise_two_expert,
)
from liteattention_tpu.models.wan import (  # noqa: E402
    WanConfig as JWanConfig,
    WanModel as JWanModel,
    init_skip_states as jinit_states,
)
from liteattention_tpu.utils.pretrained import (  # noqa: E402
    remap_state_dict_wan as jremap,
)
from liteattention_torch.models import (  # noqa: E402
    WanConfig,
    WanModel,
    denoise,
    denoise_two_expert,
    init_skip_states,
    wan_state_dict_from_jax,
)
from liteattention_torch.utils.pretrained import remap_state_dict_wan  # noqa: E402
from test_wan_remap import (  # noqa: E402
    _add_decoupled_i2v_keys,
    _synthetic_wan_state_dict,
)

GRID = (7, 20, 20)
COND, IMG_TOKENS, IMG_DIM = 4, 5, 48
THRESHOLDS = [0.5, 1.0, 1.5]  # log2 thresholds that skip part of the tiles
TT = np.full((1,), 500.0, np.float32)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(lat=f32(1, *GRID, 16), text=f32(1, 16, 64), null=f32(1, 16, 64),
                img=f32(1, IMG_TOKENS, IMG_DIM), cond=f32(1, *GRID, COND))


def _pair(decoupled, key=2, conditioned=True):
    """(JAX model, its params, the port model with them loaded)."""
    x = _inputs()
    jcfg = dataclasses.replace(JWanConfig.tiny(), dtype=jnp.float32, i2v_decoupled=decoupled)
    kw = dict(image_ctx=jnp.asarray(x["img"]), latent_cond=jnp.asarray(x["cond"])) \
        if conditioned else {}
    jmodel = JWanModel(jcfg)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(x["lat"]), jnp.asarray(TT), jnp.asarray(x["text"]), **kw
    ))(jax.random.PRNGKey(key))
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = dataclasses.replace(
        WanConfig.tiny(), dtype=torch.float32, i2v_decoupled=decoupled,
        in_channels=16 + (COND if conditioned else 0),
    )
    pmodel = WanModel(pcfg, device="cpu", image_dim=IMG_DIM if conditioned else None)
    pmodel.load_state_dict(wan_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel


@pytest.fixture(scope="module", params=[True, False], ids=["decoupled", "shared_ctx"])
def i2v(request):
    return request.param, *_pair(request.param)


@pytest.mark.parametrize("threshold", [None, 1.0], ids=["dense", "lite"])
def test_i2v_forward_matches_jax(i2v, threshold):
    decoupled, jmodel, params, pmodel = i2v
    x = _inputs()
    jst = pst = None
    if threshold is not None:
        jst = jinit_states(jmodel.cfg, 1, GRID)
        pst = init_skip_states(pmodel.cfg, 1, GRID, device="cpu")
    thr = threshold if threshold is not None else -10.0
    jo, jns = jmodel.apply(
        params, jnp.asarray(x["lat"]), jnp.asarray(TT), jnp.asarray(x["text"]), jst, thr,
        image_ctx=jnp.asarray(x["img"]), latent_cond=jnp.asarray(x["cond"]),
    )
    with torch.no_grad():
        po, pns = pmodel(t(x["lat"]), t(TT), t(x["text"]), pst, thr,
                         image_ctx=t(x["img"]), latent_cond=t(x["cond"]))
    assert po.shape == x["lat"].shape
    assert rel_l2(po.numpy(), jo) < 1e-4
    if threshold is not None:
        for i in range(2):
            np.testing.assert_array_equal(pns[i].do_mask.numpy(), np.asarray(jns[i].do_mask))
    # Both conditioning inputs reach the output.
    with torch.no_grad():
        no_img, _ = pmodel(t(x["lat"]), t(TT), t(x["text"]), image_ctx=t(x["img"]) * 0,
                           latent_cond=t(x["cond"]))
        no_cond, _ = pmodel(t(x["lat"]), t(TT), t(x["text"]), image_ctx=t(x["img"]),
                            latent_cond=t(x["cond"]) * 0)
    assert rel_l2(no_img.numpy(), po.numpy()) > 1e-4
    assert rel_l2(no_cond.numpy(), po.numpy()) > 1e-4


def test_i2v_denoise_matches_jax(i2v):
    decoupled, jmodel, params, pmodel = i2v
    x = _inputs()
    kw = dict(num_steps=3, vote_stride=2)
    jx, jtel = jax.jit(
        lambda p, n, tx, u, ic, lc: jdenoise(
            jmodel, p, n, tx, u, thresholds=jnp.asarray(THRESHOLDS),
            image_ctx=ic, latent_cond=lc, **kw,
        )
    )(params, *(jnp.asarray(x[k]) for k in ("lat", "text", "null", "img", "cond")))
    px, ptel = denoise(pmodel, *(t(x[k]) for k in ("lat", "text", "null")),
                       thresholds=THRESHOLDS, image_ctx=t(x["img"]),
                       latent_cond=t(x["cond"]), **kw)
    assert px.shape == x["lat"].shape
    assert rel_l2(px.numpy(), jx) < 1e-4
    sp = ptel["sparsity_per_step"].numpy()
    np.testing.assert_allclose(sp, np.asarray(jtel["sparsity_per_step"]), atol=1e-6, rtol=0)
    assert sp[-1] > 0.0
    for key in ("final_states", "final_states_uncond"):
        for i in range(2):
            np.testing.assert_array_equal(
                ptel[key][i].do_mask.numpy(), np.asarray(jtel[key][i].do_mask)
            )


@pytest.mark.parametrize("conditioned", [False, True], ids=["t2v", "i2v_shared_ctx"])
def test_denoise_two_expert_matches_jax(conditioned):
    jmodel, p_hi, m_hi = _pair(False, key=2, conditioned=conditioned)
    _, p_lo, m_lo = _pair(False, key=3, conditioned=conditioned)
    x = _inputs()
    thr = [1.0, 1.0, 1.5, 1.5]
    cond = ("img", "cond") if conditioned else ()
    jx, jtel = jax.jit(
        lambda a, b, n, tx, u, *c: jdenoise_two_expert(
            jmodel, a, b, n, tx, u, num_steps=4, boundary=0.875,
            guidance_scale_low=3.0, thresholds=jnp.asarray(thr),
            **dict(zip(("image_ctx", "latent_cond"), c)),
        )
    )(p_hi, p_lo, *(jnp.asarray(x[k]) for k in ("lat", "text", "null") + cond))
    px, ptel = denoise_two_expert(
        m_hi, m_lo, *(t(x[k]) for k in ("lat", "text", "null")), num_steps=4,
        boundary=0.875, guidance_scale_low=3.0, thresholds=thr,
        **{name: t(x[k]) for name, k in zip(("image_ctx", "latent_cond"), cond)},
    )
    assert set(ptel) == set(jtel)
    assert ptel["num_high_noise_steps"] == int(jtel["num_high_noise_steps"]) == 2
    assert rel_l2(px.numpy(), jx) < 1e-4
    sp = ptel["sparsity_per_step"].numpy()
    np.testing.assert_allclose(sp, np.asarray(jtel["sparsity_per_step"]), atol=1e-6, rtol=0)
    # The masks carry across the switch: sparsity never falls.
    assert sp[2] >= sp[1] > 0.0
    np.testing.assert_allclose(float(ptel["final_sparsity"]), float(jtel["final_sparsity"]),
                               atol=1e-6)
    for i in range(2):
        np.testing.assert_array_equal(
            ptel["final_states"][i].do_mask.numpy(), np.asarray(jtel["final_states"][i].do_mask)
        )


def _remap_cases(kind):
    cfg = JWanConfig.tiny()
    if kind == "t2v":
        return cfg, _synthetic_wan_state_dict(cfg)
    if kind == "i2v_img_proj":
        return cfg, _synthetic_wan_state_dict(cfg, i2v=True)
    cfg = dataclasses.replace(cfg, i2v_decoupled=True)
    sd = _synthetic_wan_state_dict(cfg, i2v=True)
    _add_decoupled_i2v_keys(sd, cfg, np.random.RandomState(11))
    return cfg, sd


@pytest.mark.parametrize("kind", ["t2v", "i2v_img_proj", "i2v_decoupled"])
def test_remap_state_dict_wan_matches_jax(kind):
    jcfg, sd = _remap_cases(kind)
    pcfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32,
                               i2v_decoupled=jcfg.i2v_decoupled)
    got = remap_state_dict_wan(sd, pcfg)
    want = wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jremap(sd, jcfg)))
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], val), key
    # Torch tensors in the checkpoint give the same result as arrays.
    again = remap_state_dict_wan({k: torch.from_numpy(v) for k, v in sd.items()}, pcfg)
    assert all(torch.equal(again[k], v) for k, v in got.items())
    # It loads strictly into the port's model and runs as the JAX model does.
    image_dim = 64 if kind != "t2v" else None
    pmodel = WanModel(pcfg, device="cpu", image_dim=image_dim)
    pmodel.load_state_dict(got)
    x = _inputs(seed=4)
    lat, text = x["lat"][:, :2, :8, :8], x["text"]
    kw = {} if image_dim is None else dict(image_ctx=np.ones((1, 4, image_dim), np.float32))
    jo, _ = JWanModel(dataclasses.replace(jcfg, dtype=jnp.float32)).apply(
        jremap(sd, jcfg), jnp.asarray(lat), jnp.asarray(TT), jnp.asarray(text),
        **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    with torch.no_grad():
        po, _ = pmodel(t(lat), t(TT), t(text), **{k: t(v) for k, v in kw.items()})
    assert rel_l2(po.numpy(), jo) < 1e-4


@pytest.mark.parametrize("ckpt_decoupled", [True, False])
def test_remap_mismatch_raises_in_both(ckpt_decoupled):
    jcfg, sd = _remap_cases("i2v_decoupled" if ckpt_decoupled else "t2v")
    wrong = not ckpt_decoupled
    with pytest.raises(ValueError):
        jremap(sd, dataclasses.replace(jcfg, i2v_decoupled=wrong))
    with pytest.raises(ValueError, match="mismatch"):
        remap_state_dict_wan(sd, dataclasses.replace(WanConfig.tiny(), i2v_decoupled=wrong))


def test_i2v_input_errors():
    cfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32)
    with pytest.raises(ValueError, match="image_dim"):
        WanModel(dataclasses.replace(cfg, i2v_decoupled=True), device="cpu")
    x = _inputs()
    dec = WanModel(dataclasses.replace(cfg, i2v_decoupled=True), device="cpu",
                   image_dim=IMG_DIM)
    with pytest.raises(ValueError, match="requires image_ctx"):
        dec(t(x["lat"]), t(TT), t(x["text"]))
    plain = WanModel(cfg, device="cpu")
    with pytest.raises(ValueError, match="in_channels"):
        plain(t(x["lat"]), t(TT), t(x["text"]), latent_cond=t(x["cond"]))
    with pytest.raises(ValueError, match="image_dim"):
        plain(t(x["lat"]), t(TT), t(x["text"]), image_ctx=t(x["img"]))
