"""Port parity: the BERT encoder (liteattention_torch.models.bert) against
the JAX package at BertConfig.tiny(), with the JAX parameters converted by
state_dict_from_flax, on right-padded batches (attention_mask -> B1's
per-batch kv_bound).

Tolerances: fp32 within 1e-4 rel-L2 (summation order only, as
tests/test_torch_gpt.py holds the GPT forward); bf16 within 2e-2 rel-L2
(the two frameworks round bf16 products and activations at other
places). Padding invariance, fp32: each sequence's valid rows in the
padded batch equal the sequence run alone within 1e-5 absolute.
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


def test_bert_backward_raises():
    # B1's bound channel has no backward yet (ROADMAP A11).
    pmodel = BertForPreTraining(dataclasses.replace(BertConfig.tiny(), dtype=torch.float32),
                                device="cpu")
    ids, mask, _ = _batch()
    with pytest.raises(NotImplementedError, match="A11"):
        pmodel(t(ids).long(), t(mask))[0].sum().backward()
