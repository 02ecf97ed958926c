"""Port parity: the small functions of the flash-attention API,
``flash_attn_combine`` and ``get_scheduler_metadata``, against the JAX
package's.

Tolerances: the combined output and lse in fp32 within 1e-6 (an exp and a
weighted sum over a few splits); the schedules exactly equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_port import t  # noqa: E402
from liteattention_tpu.flash_attn_interface import (  # noqa: E402
    flash_attn_combine as jcombine,
    get_scheduler_metadata as jsched,
)
from liteattention_torch.flash_attn_interface import (  # noqa: E402
    flash_attn_combine,
    get_scheduler_metadata,
)


@pytest.mark.parametrize("n", [1, 3])
def test_flash_attn_combine_matches_jax(n):
    b, s, h, d = 2, 5, 3, 16
    rng = np.random.RandomState(n)
    out_p = rng.randn(n, b, s, h, d).astype(np.float32)
    lse_p = (rng.randn(n, b, h, s) * 3).astype(np.float32)
    lse_p[:, 1, 2, 4] = -np.inf  # a row empty in every split: out 0, lse -inf
    lse_p[0, 0, 0, 0] = -np.inf  # a row empty in one split
    jo, jl = jcombine(jnp.asarray(out_p), jnp.asarray(lse_p), return_lse=True)
    po, pl = flash_attn_combine(t(out_p), t(lse_p), return_lse=True)
    assert po.shape == (b, s, h, d) and pl.shape == (b, h, s)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    assert (po[1, 4, 2] == 0).all() and torch.isneginf(pl[1, 2, 4])
    assert torch.equal(flash_attn_combine(t(out_p), t(lse_p)), po)


def test_get_scheduler_metadata_matches_jax():
    rng = np.random.RandomState(5)
    mask = rng.rand(2, 3, 4, 9) < 0.4
    mask[0, 0, 0] = False  # an all-skipped row: count 1, as JAX
    jidx, jcount = jsched(jnp.asarray(mask))
    pidx, pcount = get_scheduler_metadata(t(mask))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pcount.numpy(), np.asarray(jcount))
