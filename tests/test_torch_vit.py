"""Port parity: layers/patch_embed.py and models/vit.py against the JAX
modules, with JAX-initialised weights carried across by
``vit_state_dict_from_jax``, on the same numpy images (channels last).

Tolerances, fp32 on both sides: PatchEmbed within 1e-6 rel-L2 (one product
in another order); the ViT's logits within 1e-4 rel-L2 and every parameter's
gradient within 1e-3 rel-L2 of ``jax.grad`` (two layers of attention
through B1's / B7's plain versions against JAX's kernels in interpret mode);
the bf16 model within 2e-2 of the fp32 one (bf16 products).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.layers.patch_embed import PatchEmbed as JPatchEmbed  # noqa: E402
from liteattention_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from liteattention_tpu.models.vit import VisionTransformer as JViT  # noqa: E402
from liteattention_torch.layers import PatchEmbed  # noqa: E402
from liteattention_torch.models import ViTConfig, VisionTransformer, vit_state_dict_from_jax  # noqa: E402
from liteattention_torch.models.convert import state_dict_from_flax  # noqa: E402


@pytest.mark.parametrize("norm,flatten,patch", [(False, True, (4, 4)), (True, True, (4, 8)),
                                                (False, False, (8, 4))])
def test_patch_embed_matches_jax(norm, flatten, patch):
    x = np.random.RandomState(0).randn(2, 16, 32, 3).astype(np.float32)
    jm = JPatchEmbed(patch_size=patch, embed_dim=24, norm=norm, flatten=flatten,
                     dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if norm:  # non-trivial norm parameters
        params["params"]["norm"]["scale"] = np.linspace(0.5, 1.5, 24, dtype=np.float32)
        params["params"]["norm"]["bias"] = np.linspace(-0.2, 0.2, 24, dtype=np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    pm = PatchEmbed(patch, 24, in_chans=3, norm=norm, flatten=flatten, dtype=torch.float32,
                    device="cpu")
    pm.load_state_dict(state_dict_from_flax(params))
    got = pm(t(x))
    assert got.shape == want.shape
    assert rel_l2(got.detach().numpy(), want) < 1e-6


def test_patch_embed_raises_on_a_ragged_image():
    pm = PatchEmbed((8, 8), 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pm(torch.zeros(1, 12, 16, 3))


def _vit(seed=0, **kw):
    jcfg = dataclasses.replace(JViTConfig.tiny(), dtype=jnp.float32, **kw)
    pcfg = dataclasses.replace(ViTConfig.tiny(), dtype=torch.float32, **kw)
    images = np.random.RandomState(seed).randn(3, 32, 32, 3).astype(np.float32)
    jmodel = JViT(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed + 1), jnp.asarray(images)))
    pmodel = VisionTransformer(pcfg, device="cpu")
    pmodel.load_state_dict(vit_state_dict_from_jax(params))  # strict
    return jmodel, params, pmodel, images


@pytest.mark.parametrize("cls", [True, False], ids=["cls_token", "mean_pool"])
def test_vit_forward_and_grads_match_jax(cls):
    jmodel, params, pmodel, images = _vit(use_cls_token=cls)
    labels = np.array([1, 7, 3])

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(images))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(3), labels])

    jlogits = np.asarray(jmodel.apply(params, jnp.asarray(images)))
    jl, jgrads = jax.value_and_grad(jloss)(params)
    logits = pmodel(t(images))
    assert logits.shape == (3, 10) and logits.dtype == torch.float32
    assert rel_l2(logits.detach().numpy(), jlogits) < 1e-4
    loss = torch.nn.functional.cross_entropy(logits, torch.as_tensor(labels))
    assert abs(loss.item() - float(jl)) < 1e-5 * abs(float(jl)) + 1e-6
    loss.backward()
    jg = vit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in pmodel.named_parameters():
        assert rel_l2(p.grad.numpy(), jg[name].numpy()) < 1e-3, name


def test_vit_b16_config_and_bf16_forward():
    cfg = ViTConfig()
    assert (cfg.image_size, cfg.patch_size, cfg.dim, cfg.num_layers, cfg.num_heads,
            cfg.ffn_dim, cfg.num_classes) == ((224, 224), (16, 16), 768, 12, 12, 3072, 1000)
    assert cfg.num_tokens == 197 and cfg.dtype == torch.bfloat16
    jcfg = JViTConfig()
    assert all(getattr(cfg, f.name) == getattr(jcfg, f.name)
               for f in dataclasses.fields(jcfg) if f.name not in ("dtype", "block_sizes"))
    _, params, f32, images = _vit()
    bf16 = VisionTransformer(ViTConfig.tiny(), device="cpu")
    bf16.load_state_dict(vit_state_dict_from_jax(params))
    with torch.no_grad():
        assert rel_l2(bf16(t(images)).numpy(), f32(t(images)).numpy()) < 2e-2


def test_vit_reset_parameters_scales():
    model = VisionTransformer(ViTConfig.tiny(), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(model.pos_embed.std().item() - 0.02) < 0.005
    w = model.blocks[0].mlp.fc1.weight
    assert abs(w.std().item() - 1 / 8) < 0.02  # N(0, 1 / fan_in), fan_in 64
    assert (model.norm_scale == 1).all() and (model.head.bias == 0).all()
