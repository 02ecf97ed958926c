"""Port parity: skip-mask state ops (liteattention_torch.ops.mask) against
liteattention_tpu.ops.mask. Bool and int results must be exactly equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.ops import mask as jmask  # noqa: E402
from liteattention_torch.ops import mask as tmask  # noqa: E402


@pytest.mark.parametrize(
    "ranges",
    [None, [(0, 300)], [(130, 900), (1000, 1100)], [(0, 2000)]],
)
def test_init_mask(ranges):
    j = jmask.init_mask(2, 3, 700, 1100, 128, 128, must_skip_ranges=ranges)
    p = tmask.init_mask(2, 3, 700, 1100, 128, 128, must_skip_ranges=ranges, device="cpu")
    np.testing.assert_array_equal(p.do_mask.numpy(), np.asarray(j.do_mask))
    assert p.step == int(j.step) == 0


def test_must_do_mask():
    ranges = [(5, 6), (300, 513), (1000, 1100)]
    j = jmask.must_do_mask(ranges, 1100, 128)
    p = tmask.must_do_mask(ranges, 1100, 128, device="cpu")
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("with_must_do", [False, True])
def test_update_mask(with_must_do):
    rng = np.random.RandomState(0)
    do = rng.rand(2, 3, 5, 9) < 0.7
    do[..., 0] = True
    votes = (rng.rand(2, 3, 5, 9) < 0.6).astype(np.int32)
    votes[0, 0, 0] = 1  # every tile votes skip: the first-live anchor holds
    votes[1, 2, 3] = 1
    must = (rng.rand(9) < 0.3) if with_must_do else None
    js = jmask.update_mask(
        jmask.SkipMaskState(jnp.asarray(do), jnp.int32(4)),
        jnp.asarray(votes), None if must is None else jnp.asarray(must),
    )
    ps = tmask.update_mask(
        tmask.SkipMaskState(t(do), 4), t(votes),
        None if must is None else t(must),
    )
    np.testing.assert_array_equal(ps.do_mask.numpy(), np.asarray(js.do_mask))
    assert ps.step == int(js.step) == 5
    assert ps.do_mask.any(-1).all()


def _masks():
    rng = np.random.RandomState(1)
    rand = rng.rand(2, 3, 7, 11) < 0.4
    band = np.zeros((1, 2, 6, 9), bool)
    for r in range(6):
        band[:, :, r, r : r + 3] = True
    dead = rng.rand(1, 2, 4, 40) < 0.5
    dead[0, 1, 2] = False  # a row with no live tile
    dead[0, 0, :] = False
    return [rand, band, dead]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("qsubs", [1, 2])
def test_compact_mask_gather(case, qsubs):
    m = _masks()[case]
    jf, jc, jq = jmask.compact_mask_gather(jnp.asarray(m), qsubs)
    pf, pc, pq = tmask.compact_mask_gather(t(m), qsubs)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert pf.dtype == pc.dtype == pq.dtype == torch.int32


def test_compact_mask_and_sparsity():
    m = _masks()[0]
    jk, jc = jmask.compact_mask(jnp.asarray(m))
    pk, pc = tmask.compact_mask(t(m))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    # f32 mean of the same bools: same value.
    assert float(tmask.sparsity(t(m))) == float(jmask.sparsity(jnp.asarray(m)))


def test_range_list_round_trip():
    m = _masks()[0]
    rl = tmask.mask_to_range_list(m)
    np.testing.assert_array_equal(rl, jmask.mask_to_range_list(m))
    np.testing.assert_array_equal(tmask.range_list_to_mask(rl, m.shape[-1]), m)
