"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a GPU. On a machine with the card (and
no JAX) run them with ``python -m pytest tests/test_torch_cuda.py
--noconftest -q``.

Tolerances (bf16 inputs; the plain versions compute in fp32 on the same
bf16 values): out within 2e-2 absolute (bf16 output rounding plus P
rounded to bf16 before PV), and causal out within 2e-2 of max(1, |plain|)
(causal rows with few keys reach |v|); lse within 1e-3 (fp32 with
approximate exp2); packed schedules exactly equal; votes equal except
where a tile's fp32 margin ``|headroom - thr|`` is below 1e-3 (summation
order can flip those). Backward (B7): each of dq, dk, dv within rel-L2
1e-2 over the tensor and 2e-2 over every (b, h, 128-row block), so that
one wrong tile cannot hide (bf16 outputs, P and dS rounded to bf16 before
their products; dK/dV sum the GQA group in fp32 first).
"""

import pytest
import torch

from liteattention_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
)
from liteattention_torch.ops.flash_fwd import flash_attention, flash_attention_plain
from liteattention_torch.ops.lite_flash_fwd import (
    lite_flash_attention,
    lite_flash_attention_plain,
    vote_headroom,
)
from liteattention_torch.ops.schedule_pack import pack_schedule, pack_schedule_plain
from liteattention_torch.ops.tile_sizes import BlockSizes

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rel_l2(got, ref, rows=128):
    """rel-L2 over the whole [B, H, S, D] tensor and the worst over
    (b, h, ``rows``-row block); a block whose reference is 0 must be 0."""
    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % rows)
    g = torch.nn.functional.pad(got.double(), pad).reshape(b, h, -1, rows * d)
    r = torch.nn.functional.pad(ref.double(), pad).reshape(b, h, -1, rows * d)
    num, den = (g - r).norm(dim=-1), r.norm(dim=-1)
    blk = torch.where(den > 0, num / den.clamp_min(1e-300), num * float("inf"))
    tensor = (num.square().sum() / den.square().sum()).sqrt().item()
    return tensor, blk.nan_to_num(0.0).max().item()


def _check_grad(got, ref):
    tensor, block = _rel_l2(got, ref)
    assert tensor < 1e-2 and block < 2e-2, (tensor, block)


def _qkv(dev, b, h, hk, sq, sk, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    return mk(b, h, sq, d), mk(b, hk, sk, d), mk(b, hk, sk, d)


# (b, h, hk, sq, sk, d): ragged, GQA, sq > sk (causal rows with no key),
# sq < sk, D 64 and 128.
SHAPES = [
    (1, 4, 2, 300, 555, 64),
    (2, 2, 2, 256, 130, 128),
    (1, 3, 3, 1000, 77, 128),
    (1, 8, 2, 1000, 640, 128),
    (2, 4, 4, 200, 200, 64),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", SHAPES)
def test_flash_fwd_kernel(dev, b, h, hk, sq, sk, d, causal):
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ro, rl = flash_attention_plain(q, k, v, causal=causal)
    diff = (out.float() - ro.float()).abs()
    if causal:
        diff = diff / ro.float().abs().clamp_min(1.0)
    assert diff.max().item() < 2e-2
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse))
    if causal and sq > sk:
        assert not fin.all()  # rows with no valid key: lse -inf, out 0
        assert out[~fin].abs().max().item() == 0.0
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", SHAPES)
def test_flash_bwd_kernels(dev, b, h, hk, sq, sk, d, causal):
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d, seed=1)
    do = _qkv(dev, b, h, hk, sq, sk, d, seed=2)[0]
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    out = out.to(torch.bfloat16)
    delta = (out.float() * do.float()).sum(-1)
    n0 = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, d**-0.5, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, d**-0.5, causal)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    rq = flash_bwd_dq_plain(q, k, v, do, lse, delta, d**-0.5, causal)
    rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, d**-0.5, causal)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _check_grad(got, ref)
    # Bit-stable: no atomics, the same launch gives the same bits.
    assert torch.equal(dk, flash_bwd_dkv(q, k, v, do, lse, delta, d**-0.5, causal)[0])


def test_flash_autograd_kernels(dev):
    q, k, v = (x.requires_grad_() for x in _qkv(dev, 2, 4, 2, 300, 300, 64, seed=3))
    out = flash_attention(q, k, v, causal=True)
    n0 = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    out.float().square().sum().backward()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    o, lse = flash_attention_plain(qd, kd, vd, causal=True)
    ref = flash_attention_bwd(qd, kd, vd, o.bfloat16(), lse, 2 * out.detach(), 64**-0.5, True)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert torch.isfinite(got).all()
        _check_grad(got, r)


@pytest.mark.parametrize("kt", [1, 37, 256, 300])
def test_schedule_pack_kernel(dev, kt):
    g = torch.Generator(device=dev).manual_seed(kt)
    m = torch.rand(2, 3, 9, kt, generator=g, device=dev) < 0.4
    m[0, 1, 2] = False  # a row with no live tile
    m[1, 0, :, : kt // 2] = True  # a band
    fidx, count = pack_schedule(m)
    torch.cuda.synchronize()
    rf, rc = pack_schedule_plain(m)
    assert torch.equal(fidx, rf) and torch.equal(count, rc)


@pytest.mark.parametrize("gsize", [1, 2])
@pytest.mark.parametrize("d", [64, 128])
def test_lite_fwd_kernel(dev, gsize, d):
    q, k, v = _qkv(dev, 1, 4, 2, 700, 900, d, seed=gsize)
    g = torch.Generator(device=dev).manual_seed(d)
    m = torch.rand(1, 4, 6, 8, generator=g, device=dev) < 0.6
    m[..., 0] = True
    m[0, 3, 2] = False  # dead row: out 0, lse -inf
    fidx, count = pack_schedule(m)
    bs = BlockSizes(128, 128 * gsize)
    head = vote_headroom(q, k, fidx, count, gsize=gsize)
    valid = torch.arange(8, device=dev) < count[..., None]
    thr = head[valid & (head > -1e30)].median().item()  # ~half skip
    ro, rl, rv = lite_flash_attention_plain(q, k, v, fidx, count, thr, m, gsize=gsize)
    for emit in (True, False):
        out, lse, votes = lite_flash_attention(
            q, k, v, fidx, count, thr, m, block_sizes=bs, emit_votes=emit
        )
        torch.cuda.synchronize()
        assert (out.float() - ro.float()).abs().max().item() < 2e-2
        fin = torch.isfinite(rl)
        assert torch.equal(fin, torch.isfinite(lse))
        assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
        if not emit:
            assert votes is None
            continue
        margin = torch.full_like(head, float("inf"))
        margin = torch.where(valid, (head - thr).abs(), margin)
        fine_margin = torch.full(m.shape, float("inf"), device=dev)
        fine_margin.scatter_reduce_(-1, fidx.long(), margin, reduce="amin")
        bad = (votes != rv) & (fine_margin >= 1e-3)
        assert not bad.any(), int(bad.sum())
        assert 0 < rv[m].float().mean().item() < 1


def test_entry_points_default_to_the_card(dev):
    from liteattention_torch.models import GPTConfig, GPTLMHeadModel, WanConfig, WanModel
    from liteattention_torch.ops.mask import init_mask
    from liteattention_torch.training import TrainConfig, Trainer

    gpt = GPTLMHeadModel(GPTConfig.tiny())
    assert all(p.device == dev for p in gpt.parameters())
    assert all(p.device == dev for p in WanModel(WanConfig.tiny()).parameters())
    assert init_mask(1, 2, 256, 256, 128, 128).do_mask.device == dev
    assert Trainer(gpt, lambda m, x: m(x).sum(), TrainConfig()).device == dev
