"""Port parity: union-compacted K/V (kernel B6's plain version on CPU), the
packer's compact positions (B2's ``kv_map`` channel), the gather forward
loading from the compacted buffer, and the engine paths that use them
(``LiteAttention(kv_compact=True)``, ``SeqParallelLiteAttention``,
``denoise(kv_compact=True)``), against the JAX package in interpret mode.

Tolerances: maps, compacted buffers, schedules and masks exact; out and
lse in f32 within 2e-5 for single calls, 1e-4 over engine trajectories
and 1e-4 rel-L2 for denoised latents (summation order only); compaction
itself changes nothing in the port, so compacted and uncompacted runs are
held to ``torch.equal``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import coherent_qkv, rel_l2, t  # noqa: E402
from liteattention_tpu.lite_attention import LiteAttention as JLite  # noqa: E402
from liteattention_tpu.lite_attention import (  # noqa: E402
    SeqParallelLiteAttention as JSeqParallel,
)
from liteattention_tpu.models.pipeline import denoise as jdenoise  # noqa: E402
from liteattention_tpu.models.wan import WanConfig as JWanConfig  # noqa: E402
from liteattention_tpu.models.wan import WanModel as JWanModel  # noqa: E402
from liteattention_tpu.ops.kv_compact import compact_kv as jcompact_kv  # noqa: E402
from liteattention_tpu.ops.kv_compact import kv_union_map as jkv_union_map  # noqa: E402
from liteattention_tpu.ops.lite_flash_fwd import (  # noqa: E402
    lite_flash_attention as jlite,
    pack_kv,
)
from liteattention_tpu.ops.mask import SkipMaskState as JState  # noqa: E402
from liteattention_tpu.ops.schedule_pack import pack_schedule as jpack  # noqa: E402
from liteattention_tpu.ops.schedule_pack import unpack_schedule  # noqa: E402
from liteattention_tpu.ops.tile_sizes import BlockSizes as JBS  # noqa: E402
from liteattention_torch import LiteAttention, SeqParallelLiteAttention  # noqa: E402
from liteattention_torch.models import WanConfig, WanModel, denoise  # noqa: E402
from liteattention_torch.models import wan_state_dict_from_jax  # noqa: E402
from liteattention_torch.ops.combine import combine_attention  # noqa: E402
from liteattention_torch.ops.flash_fwd import flash_attention  # noqa: E402
from liteattention_torch.ops.kv_compact import compact_kv, kv_union_map  # noqa: E402
from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention  # noqa: E402
from liteattention_torch.ops.mask import SkipMaskState  # noqa: E402
from liteattention_torch.ops.schedule_pack import pack_schedule  # noqa: E402
from liteattention_torch.ops.tile_sizes import BlockSizes  # noqa: E402


def _mask(seed, b, h, qt, kt, density):
    rng = np.random.RandomState(seed)
    m = rng.rand(b, h, qt, kt) < density
    m[0, 0, 1] = False  # a row with nothing live
    return m


@pytest.mark.parametrize("b,h,hk,qt,kt,density", [
    (2, 4, 2, 6, 9, 0.3),  # GQA: one union per kv-head
    (1, 2, 2, 5, 7, 0.1),  # scattered, many dead tiles
    (1, 3, 3, 4, 4, 1.0),  # fully live: the identity map
])
def test_union_map_and_positions_match_jax(b, h, hk, qt, kt, density):
    m = _mask(b * 10 + kt, b, h, qt, kt, density)
    got = kv_union_map(t(m), hk=hk)
    want = jkv_union_map(jnp.asarray(m), hk=hk)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The packer's compact positions: JAX writes them in place of fidx.
    kv_map = got[0]
    fidx, count, cidx = pack_schedule(t(m), kv_map)
    pf, pc = pack_schedule(t(m))
    assert torch.equal(fidx, pf) and torch.equal(count, pc)
    packed = jpack(jnp.asarray(m), qsubs=1, gsize=1, seqlen_k=kt * 128,
                   kv_map=jnp.asarray(kv_map.numpy()))
    jc, jcount, _ = unpack_schedule(packed, kt, packed.shape[3] // 3)
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))


def test_compact_kv_matches_jax():
    rng = np.random.RandomState(1)
    b, h, hk, kt, d = 2, 4, 2, 6, 128
    m = _mask(1, b, h, 3, kt, 0.4)
    k = rng.randn(b, hk, kt * 128, d).astype(np.float32)
    v = rng.randn(b, hk, kt * 128, d).astype(np.float32)
    _, inv, _ = kv_union_map(t(m), hk=hk)
    kc, vc = compact_kv(t(k), t(v), inv)
    want = np.asarray(jcompact_kv(pack_kv(jnp.asarray(k), jnp.asarray(v)),
                                  jnp.asarray(inv.numpy())))
    np.testing.assert_array_equal(kc.numpy(), want[..., :d])
    np.testing.assert_array_equal(vc.numpy(), want[..., d:])
    with pytest.raises(ValueError):
        compact_kv(t(k)[:, :, :700], t(v)[:, :, :700], inv)  # S % 128 != 0


@pytest.mark.parametrize("hk,density", [(4, 0.35), (2, 0.35), (2, 0.08)])
def test_gather_from_compacted_kv_matches_jax(hk, density):
    h, s = 4, 1024
    q, k, v = coherent_qkv(np.random.RandomState(hk), 1, h, s, s, 64, hk=hk)
    m = _mask(2, 1, h, 8, 8, density)
    m[0, 1, :, 0] = True  # a row whose live set starts at tile 0
    thr = -2.0
    kv_map, inv, _ = kv_union_map(t(m), hk=hk)
    fidx, count, cidx = pack_schedule(t(m), kv_map)
    kc, vc = compact_kv(t(k), t(v), inv)
    got = lite_flash_attention(t(q), kc, vc, fidx, count, thr, t(m), cidx=cidx)
    plain = lite_flash_attention(t(q), t(k), t(v), fidx, count, thr, t(m))
    for a, b_ in zip(got, plain):  # compaction moves addresses only
        assert torch.equal(a, b_)
    # JAX: the wire schedule in compact positions, kv_map in the decode.
    jmap = jnp.asarray(kv_map.numpy())
    packed = jpack(jnp.asarray(m), qsubs=1, gsize=1, seqlen_k=s, kv_map=jmap)
    jf, jc, jq = unpack_schedule(packed, 8, packed.shape[3] // 3)
    kvp = jcompact_kv(pack_kv(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(inv.numpy()))
    jo, jl, jv = jlite(
        jnp.asarray(q), None, None, jf, jc, jnp.float32(thr), kv_bits=jq,
        block_sizes=JBS(128, 128), fine_schedule=True, packed_schedule=packed,
        packed_kv=kvp, seqlen_k=s, kv_map=jmap,
    )
    po, pl, pv = got
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    jl = np.asarray(jl)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl.numpy()), fin)
    np.testing.assert_allclose(pl.numpy()[fin], jl[fin], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(pv.numpy()[m], np.asarray(jv)[m])


def _qkv_steps(steps, s=1024, h=2, d=64, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randn(1, s, 1, d)
    out = []
    for _ in range(steps):
        base = base + 0.05 * rng.randn(1, s, 1, d)
        q = base + 0.3 * rng.randn(1, s, h, d)
        k = base + 0.3 * rng.randn(1, s, h, d)
        out.append((q.astype(np.float32), k.astype(np.float32),
                    rng.randn(1, s, h, d).astype(np.float32)))
    return out


def test_lite_attention_kv_compact_gate_engages():
    # Pre-skipping the back half of the keys leaves a union density of
    # 0.5 < 0.75: both packages compact, and the results do not change.
    traj = _qkv_steps(3)
    skip = [1023, 512]
    jattn = JLite(threshold=-3.0, kv_compact=True, block_sizes=JBS(128, 256))
    pattn = LiteAttention(threshold=-3.0, kv_compact=True, block_sizes=BlockSizes(128, 256))
    pflat = LiteAttention(threshold=-3.0, kv_compact=False, block_sizes=BlockSizes(128, 256))
    for q, k, v in traj:
        jo = jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), must_skip_list=skip)
        po = pattn(t(q), t(k), t(v), must_skip_list=skip)
        assert jattn._kv_maps is not None  # JAX's gate engaged
        assert len(pattn._compact(pattn.state.do_mask, 2, 1024)) == 4  # and the port's
        assert torch.equal(po, pflat(t(q), t(k), t(v), must_skip_list=skip))
        assert torch.equal(pattn.state.do_mask, pflat.state.do_mask)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(pattn.state.do_mask.numpy(),
                                      np.asarray(jattn.state.do_mask))
    assert 0.5 < pattn.get_skip_percentage() < 1.0
    # A full union (density 1) keeps the plain schedule.
    dense = LiteAttention(threshold=-3.0, block_sizes=BlockSizes(128, 256))
    dense(*(t(x) for x in traj[0]))
    assert len(dense._compact(dense.state.do_mask, 2, 1024)) == 2


def test_seq_parallel_matches_jax_and_merges():
    # Two KV splits, each with its own skip state; at thr -inf the merged
    # splits equal one dense call.
    (q, k, v), = _qkv_steps(1, s=768, seed=5)
    halves = [slice(0, 384), slice(384, 768)]
    for thr in (-3.0, float("-inf")):
        jsp = JSeqParallel(2, threshold=thr, block_sizes=JBS(128, 128))
        psp = SeqParallelLiteAttention(2, threshold=thr, block_sizes=BlockSizes(128, 128))
        outs, lses = [], []
        for i, sl in enumerate(halves):
            for _ in range(2):  # the second call uses the evolved mask
                jo, jl = jsp(jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
                             i, return_softmax_lse=True)
                po, pl = psp(t(q), t(k[:, sl]), t(v[:, sl]), i, return_softmax_lse=True)
                np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4, rtol=0)
                np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
                np.testing.assert_array_equal(
                    psp.lite_attention[i].state.do_mask.numpy(),
                    np.asarray(jsp.lite_attention[i].state.do_mask))
            outs.append(po.transpose(1, 2))
            lses.append(pl)
        if thr == float("-inf"):
            merged, _ = combine_attention(torch.stack(outs), torch.stack(lses))
            ref = flash_attention(t(q).transpose(1, 2), t(k).transpose(1, 2),
                                  t(v).transpose(1, 2))
            torch.testing.assert_close(merged, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        psp(t(q), t(k), t(v), 2)


GRID = (4, 16, 32)  # 4 x 8 x 16 = 512 tokens: the compaction gate holds


def test_denoise_kv_compact_matches_jax():
    jcfg = dataclasses.replace(JWanConfig.tiny(), dtype=jnp.float32)
    pcfg = dataclasses.replace(WanConfig.tiny(), dtype=torch.float32)
    rng = np.random.RandomState(0)
    lat = rng.randn(1, *GRID, 16).astype(np.float32)
    text = rng.randn(1, 16, 64).astype(np.float32)
    null = np.zeros_like(text)
    jmodel = JWanModel(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(lat), jnp.full((1,), 999.0, jnp.float32),
        jnp.asarray(text),
    )
    pmodel = WanModel(pcfg, device="cpu")
    pmodel.load_state_dict(wan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    # Initial masks with a sparse union: each head sees half the k-tiles.
    m = np.zeros((1, pcfg.num_heads, 4, 4), bool)
    m[:, 0, :, :2] = True
    m[:, 1, :, 1:3] = True
    thresholds = [0.5, 1.0, 1.5]
    kw = dict(num_steps=3, vote_stride=2, kv_compact=True)
    jst = {i: JState(jnp.asarray(m), jnp.zeros((), jnp.int32)) for i in range(2)}
    jx, jtel = jax.jit(
        lambda p, n, tx, u: jdenoise(jmodel, p, n, tx, u, thresholds=jnp.asarray(thresholds),
                                     initial_states=jst, initial_states_uncond=jst, **kw)
    )(params, jnp.asarray(lat), jnp.asarray(text), jnp.asarray(null))
    pst = {i: SkipMaskState(t(m), 0) for i in range(2)}
    px, ptel = denoise(pmodel, t(lat), t(text), t(null), thresholds=thresholds,
                       initial_states=dict(pst), initial_states_uncond=dict(pst), **kw)
    flat, ftel = denoise(pmodel, t(lat), t(text), t(null), thresholds=thresholds,
                         initial_states=dict(pst), initial_states_uncond=dict(pst),
                         **{**kw, "kv_compact": False})
    assert torch.equal(px, flat)
    assert rel_l2(px.numpy(), jx) < 1e-4
    for key in ("final_states", "final_states_uncond"):
        for i in range(2):
            np.testing.assert_array_equal(ptel[key][i].do_mask.numpy(),
                                          np.asarray(jtel[key][i].do_mask))
            assert torch.equal(ptel[key][i].do_mask, ftel[key][i].do_mask)
