"""Port parity: the BERT encoder (liteattention_torch.models.bert) against
the JAX package at BertConfig.tiny(), with the JAX parameters converted by
state_dict_from_flax, on right-padded batches (attention_mask -> B1's
per-batch kv_bound).

Tolerances: fp32 within 1e-4 rel-L2 (summation order only, as
tests/test_torch_gpt.py holds the GPT forward); bf16 within 2e-2 rel-L2
(the two frameworks round bf16 products and activations at other
places). Padding invariance, fp32: each sequence's valid rows in the
padded batch equal the sequence run alone within 1e-5 absolute. Training:
an MLM + NSP loss (defined here: JAX has no BERT loss) summed over
sequences, its fp32 gradient within 1e-4 rel-L2 of jax.grad for every
parameter, and the padded batch's gradient within 1e-5 rel-L2 of the sum
of its sequences' gradients run alone.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import rel_l2, t  # noqa: E402
from liteattention_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from liteattention_tpu.models.bert import BertForPreTraining as JBertForPreTraining  # noqa: E402
from liteattention_tpu.models.bert import BertModel as JBertModel  # noqa: E402
from liteattention_torch.models import BertConfig, BertForPreTraining, BertModel  # noqa: E402
from liteattention_torch.models.convert import state_dict_from_flax  # noqa: E402

LENGTHS = [100, 37, 1, 64]
S = 100
GRAD_TOL = 1e-4  # rel-L2 of each parameter's fp32 gradient against jax.grad
PAD_GRAD_TOL = 1e-5  # ... and of the padded batch's against the sequences alone


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (len(LENGTHS), S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    types = (rng.rand(len(LENGTHS), S) < 0.5).astype(np.int32)
    return ids, mask, types


def _pair(jcls, pcls, dtype):
    jcfg = dataclasses.replace(JBertConfig.tiny(), dtype=jnp.dtype(dtype))
    pcfg = dataclasses.replace(BertConfig.tiny(), dtype=getattr(torch, dtype))
    ids, mask, types = _batch()
    jmodel = jcls(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))
    pmodel = pcls(pcfg, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params))  # strict
    return jmodel, params, pmodel


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_bert_model_matches_jax(dtype, tol):
    jmodel, params, pmodel = _pair(JBertModel, BertModel, dtype)
    ids, mask, types = _batch()
    jh, jp = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
    with torch.no_grad():
        ph, pp = pmodel(t(ids).long(), t(mask), t(types).long())
    assert ph.dtype == getattr(torch, dtype) and ph.shape == (len(LENGTHS), S, 64)
    valid = mask.astype(bool)
    assert rel_l2(ph.float().numpy()[valid], np.asarray(jh, np.float32)[valid]) < tol
    assert rel_l2(pp.float().numpy(), np.asarray(jp, np.float32)) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_bert_for_pretraining_matches_jax(dtype, tol):
    jmodel, params, pmodel = _pair(JBertForPreTraining, BertForPreTraining, dtype)
    ids, mask, types = _batch()
    jm, jn = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
    with torch.no_grad():
        pm, pn = pmodel(t(ids).long(), t(mask), t(types).long())
    assert pm.dtype == torch.float32 and pm.shape == (len(LENGTHS), S, 256)
    valid = mask.astype(bool)
    assert rel_l2(pm.numpy()[valid], np.asarray(jm)[valid]) < tol
    assert rel_l2(pn.numpy(), np.asarray(jn)) < tol
    # No attention mask: every token valid, in both.
    jm, _ = jmodel.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        pm, _ = pmodel(t(ids).long())
    assert rel_l2(pm.numpy(), np.asarray(jm)) < tol


def test_padding_invariance():
    # Each sequence's valid rows in the right-padded batch equal the same
    # sequence run alone, unpadded.
    _, _, pmodel = _pair(JBertModel, BertModel, "float32")
    ids, mask, types = _batch(3)
    with torch.no_grad():
        batch, _ = pmodel(t(ids).long(), t(mask), t(types).long())
        for i, n in enumerate(LENGTHS):
            alone, _ = pmodel(t(ids[i : i + 1, :n]).long(), None, t(types[i : i + 1, :n]).long())
            np.testing.assert_allclose(batch[i, :n].numpy(), alone[0].numpy(), atol=1e-5, rtol=0)


def _mlm_nsp(seed=5):
    """MLM positions (15 % of the valid tokens, at least one a sequence),
    their labels and NSP labels, from a numpy seed."""
    rng = np.random.RandomState(seed)
    _, mask, _ = _batch()
    pos = (rng.rand(*mask.shape) < 0.15) & mask.astype(bool)
    pos[np.arange(len(LENGTHS)), 0] = True
    labels = rng.randint(0, 256, mask.shape).astype(np.int32)
    nsp = rng.randint(0, 2, len(LENGTHS)).astype(np.int32)
    return pos, labels, nsp


def _torch_loss(model, ids, mask, types, pos, labels, nsp):
    """MLM + NSP pretraining loss, summed over sequences (so that a batch's
    loss is the sum of its sequences')."""
    mlm, nsp_logits = model(ids, mask, types)
    ce = torch.nn.functional.cross_entropy(mlm.reshape(-1, mlm.shape[-1]), labels.reshape(-1),
                                           reduction="none").reshape(labels.shape)
    return (ce * pos).sum() + torch.nn.functional.cross_entropy(nsp_logits, nsp, reduction="sum")


def test_bert_backward_raises():
    # Once pinned the raise of a gradient through B1's bound channel; B7
    # now takes it, so BertForPreTraining's MLM + NSP gradient (fp32, the
    # Flax tree converted) is held against jax.grad of the same loss (each
    # parameter within GRAD_TOL rel-L2), and the padded batch's gradient
    # against the sum of its sequences' gradients run alone, unpadded
    # (each parameter within PAD_GRAD_TOL rel-L2).
    jmodel, params, pmodel = _pair(JBertForPreTraining, BertForPreTraining, "float32")
    ids, mask, types = _batch()
    pos, labels, nsp = _mlm_nsp()

    def jloss(p):
        m, n = jmodel.apply(p, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
        lm = jax.nn.log_softmax(m, axis=-1)
        ce = -jnp.take_along_axis(lm, jnp.asarray(labels)[..., None], axis=-1)[..., 0]
        ln = jax.nn.log_softmax(n, axis=-1)
        return (jnp.sum(jnp.where(jnp.asarray(pos), ce, 0.0))
                - jnp.sum(jnp.take_along_axis(ln, jnp.asarray(nsp)[:, None], axis=-1)))

    jl, jgrads = jax.value_and_grad(jloss)(params)
    jgrads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    tid, tmask, ttypes = t(ids).long(), t(mask), t(types).long()
    tpos, tlab, tnsp = t(pos).float(), t(labels).long(), t(nsp).long()
    loss = _torch_loss(pmodel, tid, tmask, ttypes, tpos, tlab, tnsp)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    batch_grads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    assert set(batch_grads) == set(jgrads)
    for n, g in batch_grads.items():
        assert rel_l2(g.numpy(), jgrads[n].numpy()) < GRAD_TOL, n
    # Padding invariance of the gradient.
    pmodel.zero_grad()
    for i, n in enumerate(LENGTHS):
        sl = (slice(i, i + 1), slice(0, n))
        _torch_loss(pmodel, tid[sl], None, ttypes[sl], tpos[sl], tlab[sl], tnsp[i : i + 1]).backward()
    for n, p in pmodel.named_parameters():
        assert rel_l2(p.grad.numpy(), batch_grads[n].numpy()) < PAD_GRAD_TOL, n


def _flax_from_state_dict(tree, sd, prefix=""):
    """The Flax param tree shaped like ``tree`` with the values of the
    port's ``state_dict`` ``sd`` (state_dict_from_flax's mapping, inverted)."""
    out = {}
    for name, val in tree.items():
        stack, _, idx = name.partition("_")
        tname = f"{stack}s.{idx}" if stack in ("block", "layer") and idx.isdigit() else name
        if isinstance(val, dict):
            out[name] = _flax_from_state_dict(val, sd, f"{prefix}{tname}.")
        elif name == "kernel":
            out[name] = jnp.asarray(sd[prefix + "weight"].numpy().T)
        elif name in ("scale", "embedding"):
            out[name] = jnp.asarray(sd[prefix + "weight"].numpy())
        else:
            out[name] = jnp.asarray(sd[prefix + name].numpy())
    return out


def adamw_loss_curves(cfg_kw, lr=1e-4, steps=5, b=4, s=32, min_len=8):
    """The port's and JAX's BertForPreTraining (fp32) from the same weights
    (the port's ``reset_parameters`` at seed 3, converted to the Flax tree)
    trained ``steps`` AdamW steps (betas (0.9, 0.999), eps 1e-8, weight
    decay 0.01: torch's defaults and optax.adamw's) at ``lr`` on one fixed
    right-padded batch (numpy seed 4: lengths in [min_len, s], 15 % MLM
    with [MASK] 103, NSP labels) under chip_smoke.py's pretraining loss
    (MLM cross-entropy over the masked positions' count plus NSP's mean):
    the two loss curves."""
    import optax

    pcfg = BertConfig(dtype=torch.float32, **cfg_kw)
    jcfg = JBertConfig(dtype=jnp.float32, **cfg_kw)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, pcfg.vocab_size, (b, s))
    lens = rng.randint(min_len, s + 1, b)
    col = np.arange(s)[None]
    mask = (col < lens[:, None]).astype(np.int32)
    types = ((col >= (lens // 2)[:, None]) & mask.astype(bool)).astype(np.int32)
    pos = (rng.rand(b, s) < 0.15) & mask.astype(bool)
    pos[:, 0] = True
    inp, nsp, n_mlm = np.where(pos, 103, ids), rng.randint(0, 2, b), int(pos.sum())
    pmodel = BertForPreTraining(pcfg, device="cpu")
    with torch.no_grad():
        pmodel.reset_parameters(torch.Generator().manual_seed(3))
    jmodel = JBertForPreTraining(jcfg)
    tmpl = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(inp), jnp.asarray(mask),
                                jnp.asarray(types))
    sd = {n: x.detach() for n, x in pmodel.state_dict().items()}
    params = {"params": _flax_from_state_dict(tmpl["params"], sd)}

    def jloss(p):
        m, n = jmodel.apply(p, jnp.asarray(inp), jnp.asarray(mask), jnp.asarray(types))
        ce = -jnp.take_along_axis(jax.nn.log_softmax(m, -1), jnp.asarray(ids)[..., None], -1)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(n, -1), jnp.asarray(nsp)[:, None], -1)
        return jnp.sum(jnp.where(jnp.asarray(pos), ce[..., 0], 0.0)) / n_mlm + jnp.mean(nll)

    opt = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    state, step, jcurve = opt.init(params), jax.jit(jax.value_and_grad(jloss)), []
    for _ in range(steps):
        loss, grads = step(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        jcurve.append(float(loss))
    popt = torch.optim.AdamW(pmodel.parameters(), lr=lr, weight_decay=0.01)
    tinp, tmask, ttypes, tpos = t(inp).long(), t(mask), t(types).long(), t(pos)
    tlab, tnsp, pcurve = t(ids).long(), t(nsp).long(), []
    for _ in range(steps):
        popt.zero_grad()
        m, n = pmodel(tinp, tmask, ttypes)
        sel = tpos.nonzero(as_tuple=True)
        loss = (torch.nn.functional.cross_entropy(m[sel], tlab[sel], reduction="sum") / n_mlm
                + torch.nn.functional.cross_entropy(n, tnsp))
        loss.backward()
        popt.step()
        pcurve.append(loss.item())
    return pcurve, jcurve


def test_adamw_loss_curve_matches_jax():
    # ROADMAP C4: BERT-large's pretraining loss rose after its first AdamW
    # step at lr 1e-4 on the card. At BERT-large's width with 2 and 4 layers
    # on the CPU (this file's __main__) the port's and JAX's curves agree to
    # ~1e-6 relative and both rise after the first step: the recipe, not the
    # port. Here at BertConfig.tiny(), each step's loss within 1e-5 relative.
    tiny = {f: getattr(BertConfig.tiny(), f) for f in (
        "vocab_size", "dim", "num_layers", "num_heads", "ffn_dim", "max_position_embeddings")}
    pcurve, jcurve = adamw_loss_curves(tiny)
    for p_, j_ in zip(pcurve, jcurve):
        assert abs(p_ - j_) <= 1e-5 * abs(j_), (pcurve, jcurve)


if __name__ == "__main__":
    # The ROADMAP C4 comparison at BERT-large's width, depth cut to argv[1]
    # layers (default 2), 8 sequences of up to 128 tokens, lr 1e-4:
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bert.py 2
    import sys

    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    curves = adamw_loss_curves(dict(dim=1024, num_layers=layers, num_heads=16, ffn_dim=4096),
                               b=8, s=128, min_len=16)
    print("port", [round(x, 4) for x in curves[0]])
    print("jax ", [round(x, 4) for x in curves[1]])
    print("max relative difference", max(abs(a - b) / abs(b) for a, b in zip(*curves)))
