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
order can flip those; the coarse modes B4 are checked where the plain
vote is the same at thr -/+ 1e-3). B5 (heads folded per CTA) and B3
loading union-compacted K/V equal B3 bit for bit; B6 and B2's compact
positions equal their plain versions exactly. Backward (B7, one pass):
each of dq, dk, dv within rel-L2 1e-2 over the tensor and 2e-2 over every
(b, h, 128-row block) of B7a's / B7b's plain versions, so that one wrong
tile cannot hide (bf16 outputs, P and dS rounded to bf16 before their
products; dK/dV sum the GQA group in fp32 first). dK and dV are
bit-stable (the group sum stays in one CTA); dQ is summed across CTAs by
atomics in no fixed order, so a second run is held by the same rel-L2.
The dense forward B1 has no atomics: two launches give the same bits.
"""

import pytest
import torch

from liteattention_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
)
from liteattention_torch.ops.flash_fwd import (
    flash_attention,
    flash_attention_masked,
    flash_attention_plain,
)
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
# sq < sk, D 64 and 128 (FWD_SHAPES and BWD_SHAPES add 80 and 96).
SHAPES = [
    (1, 4, 2, 300, 555, 64),
    (2, 2, 2, 256, 130, 128),
    (1, 3, 3, 1000, 77, 128),
    (1, 8, 2, 1000, 640, 128),
    (2, 4, 4, 200, 200, 64),
]


# B1's edges besides: Sq <= 64 (one of the CTA's two warpgroups has rows),
# Sq 1 and 4 against Sk 1059 (the serving verify step), Sk 1, 64, 128 and
# 129 (the 128-key TMA box's edges), Sq > Sk at GQA group 4 and D 128
# (causal rows with no key), GQA group 8 at D 64.
FWD_SHAPES = SHAPES + [
    (2, 4, 2, 50, 300, 128),
    (1, 2, 1, 64, 64, 64),
    (1, 32, 8, 1, 1059, 128),
    (1, 32, 8, 4, 1059, 128),
    (1, 4, 4, 200, 1, 64),
    (1, 4, 2, 300, 64, 128),
    (1, 4, 2, 300, 128, 128),
    (1, 4, 2, 300, 129, 64),
    (1, 8, 2, 700, 300, 128),
    (2, 16, 2, 500, 700, 64),
    (1, 8, 8, 1024, 1500, 128),
    (2, 4, 4, 777, 1500, 64),
    # Head dims 80 (BTLM) and 96 (GPT-NeoX-20B): two atoms a tile, the
    # second partly filled; ragged, GQA, Sq > Sk, Sq 1.
    (1, 4, 2, 300, 555, 80),
    (1, 8, 2, 700, 300, 80),
    (1, 32, 32, 1, 1059, 80),
    (2, 4, 4, 200, 200, 96),
    (2, 2, 2, 256, 130, 96),
    # Head dim 256 (GPT-J): 64-key tiles in two stages; ragged, GQA, Sq >
    # Sk, Sq 1, and Sk 1, 64 and 65 (the 64-key TMA box's edges).
    (1, 4, 2, 300, 555, 256),
    (1, 8, 2, 700, 300, 256),
    (1, 16, 16, 1, 1059, 256),
    (2, 2, 2, 256, 130, 256),
    (1, 4, 4, 200, 1, 256),
    (1, 2, 1, 64, 64, 256),
    (1, 4, 2, 300, 65, 256),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", FWD_SHAPES)
def test_flash_fwd_kernel(dev, b, h, hk, sq, sk, d, causal):
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    # The forward has no atomics: a second launch gives the same bits.
    out2, lse2 = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
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


# B1's per-batch channels: (b, h, hk, sq, sk, d), kv_bound, kv_low, causal,
# bound_causal, ALiBi slopes ("h": [H], "bh": [B, H]), scale ("d": 1/d).
# Bounds inside and on tile edges, low inside a tile, rows that see no key
# (bound 0, bound <= low, bound_causal with bound < Sq), MHA's cached
# steps (Sq 1, 4 and a prefill over a longer cache, bound_causal + ALiBi).
CHANNEL_CASES = [
    ((4, 4, 2, 300, 555, 64), [555, 300, 129, 1], None, False, False, None, None),
    ((3, 4, 2, 200, 700, 128), [700, 260, 128], [0, 100, 129], False, True, None, None),
    ((2, 8, 2, 130, 1000, 128), [1000, 500], None, True, True, None, None),
    ((2, 4, 4, 300, 555, 64), [555, 200], [64, 0], True, False, None, None),
    ((4, 2, 2, 150, 260, 64), [0, 100, 90, 260], [0, 100, 120, 0], False, True, None, None),
    ((2, 4, 2, 300, 300, 64), None, None, True, False, "h", None),
    ((2, 4, 4, 300, 140, 128), None, None, False, False, "bh", "d"),
    ((2, 6, 2, 257, 700, 64), None, None, False, False, "h", "d"),
    ((2, 8, 2, 1, 1059, 128), [1059, 500], None, False, True, "h", None),
    ((2, 8, 2, 4, 1059, 128), [1059, 700], None, False, True, "bh", None),
    ((2, 10, 2, 256, 1024, 64), [256, 700], None, False, True, "h", None),
    # Head dim 80 (BTLM: ALiBi at scale 1/d, its cached steps).
    ((3, 4, 2, 200, 700, 80), [700, 260, 128], [0, 100, 129], False, True, None, None),
    ((2, 4, 2, 300, 300, 80), None, None, True, False, "h", "d"),
    ((2, 8, 2, 1, 1059, 80), [1059, 500], None, False, True, "h", "d"),
    ((2, 8, 8, 130, 1000, 80), [1000, 600], None, False, True, "bh", "d"),
    # Head dim 256 (GPT-J): the key range alone (MHA's prefill into the
    # cache, its multi-token steps, a left-padded append, rows with no key).
    ((2, 4, 4, 300, 1000, 256), [300, 1000], None, False, True, None, None),
    ((2, 8, 8, 4, 1059, 256), [1059, 700], None, False, True, None, None),
    ((3, 4, 2, 200, 700, 256), [700, 260, 64], [0, 100, 65], True, True, None, None),
]


@pytest.mark.parametrize("shape,bound,low,causal,bound_causal,alibi,scale", CHANNEL_CASES)
def test_flash_fwd_kernel_channels(dev, shape, bound, low, causal, bound_causal, alibi, scale):
    from liteattention_torch.modules.mha import alibi_slopes

    b, h, hk, sq, sk, d = shape
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d, seed=sq + sk)
    kw = dict(causal=causal, bound_causal=bound_causal, scale=1.0 / d if scale == "d" else None)
    if bound is not None:
        kw["kv_bound"] = torch.tensor(bound, dtype=torch.int32, device=dev)
    if low is not None:
        kw["kv_low"] = torch.tensor(low, dtype=torch.int32, device=dev)
    if alibi is not None:
        slopes = alibi_slopes(h).to(dev)
        kw["alibi_slopes"] = slopes if alibi == "h" else slopes * torch.linspace(
            1.0, 2.0, b, device=dev)[:, None]
    counter = "alibi_launches" if alibi else "bound_launches"
    n0 = getattr(flash_attention, counter)
    out, lse = flash_attention_masked(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_attention, counter) == n0 + 1
    out2, lse2 = flash_attention_masked(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    plain = {n: x for n, x in kw.items() if n != "alibi_slopes"}
    ro, rl = flash_attention_plain(q, k, v, alibi_slopes=kw.get("alibi_slopes"), **plain)
    diff = (out.float() - ro.float()).abs() / ro.float().abs().clamp_min(1.0)
    assert diff.max().item() < 2e-2
    assert _rel_l2(out, ro)[1] < 2e-2
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse))
    if not fin.all():
        assert out[~fin].abs().max().item() == 0.0
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_kernel_full_bound_is_bit_identical(dev, causal):
    # A bound of Sk (with bound_causal under causal: the same diagonal) is
    # the kernel without channels, bit for bit.
    q, k, v = _qkv(dev, 2, 8, 2, 300, 555, 128, seed=3)
    full = torch.full((2,), 555, dtype=torch.int32, device=dev)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got, glse = flash_attention_masked(q, k, v, kv_bound=full, kv_low=full * 0, causal=causal,
                                       bound_causal=causal, return_lse=True)
    assert torch.equal(out, got) and torch.equal(lse, glse)


def test_flash_fwd_kernel_alibi_cache_capacity(dev):
    # ALiBi over a 2048-key cache with bound_causal and over a cache of the
    # bound's length: the kernel drops the per-row constant slope * (Sk -
    # bound) from the scores, so out is the same bits and lse moves by it.
    from liteattention_torch.modules.mha import alibi_slopes

    q, k, v = _qkv(dev, 2, 40, 40, 4, 2048, 128, seed=7)
    slopes = alibi_slopes(40).to(dev)
    bound = torch.tensor([1100, 1900], dtype=torch.int32, device=dev)
    kw = dict(bound_causal=True, alibi_slopes=slopes, return_lse=True)
    big_o, big_l = flash_attention_masked(q, k, v, kv_bound=bound, **kw)
    for i, n in enumerate(bound.tolist()):
        o, lse = flash_attention_masked(q[i : i + 1], k[i : i + 1, :, :n].contiguous(),
                                        v[i : i + 1, :, :n].contiguous(), kv_bound=bound[i : i + 1],
                                        **kw)
        assert torch.equal(big_o[i : i + 1], o)
        assert (big_l[i : i + 1] + slopes[None, :, None] * (2048 - n) - lse).abs().max() < 1e-3


def test_flash_fwd_kernel_channels_backward_raises(dev):
    # Once pinned the raise of a gradient through B1's channels; the
    # gradient now runs B7's RANGE instantiation, held against B7a's / B7b's
    # plain versions on the forward's out and lse.
    q, k, v = (x.requires_grad_() for x in _qkv(dev, 1, 2, 2, 128, 128, 64))
    bound = torch.tensor([100], device=dev)
    out, lse = flash_attention_masked(q, k, v, kv_bound=bound, return_lse=True)
    n0 = flash_bwd.bound_launches
    out.float().sum().backward()
    assert flash_bwd.bound_launches == n0 + 1
    qd, kd, vd, od = (x.detach() for x in (q, k, v, out))
    do = torch.ones_like(od)
    delta = (od.float() * do.float()).sum(-1)
    args = (qd, kd, vd, do, lse, delta, 64**-0.5, False)
    refs = (flash_bwd_dq_plain(*args, kv_bound=bound), *flash_bwd_dkv_plain(*args, kv_bound=bound))
    for got, ref in zip((q.grad, k.grad, v.grad), refs):
        _check_grad(got, ref)
    assert k.grad[:, :, 100:].abs().max().item() == 0.0


# B7 with B1's channels: (b, h, hk, sq, sk, d), kv_bound, kv_low, causal,
# bound_causal, ALiBi ("h": [H], "bh": [B, H], None). Bounds inside a tile
# and on its edge, a k-tile wholly past the bound and one wholly below
# kv_low (no walk: zero dK/dV), rows that see no key, bound_causal over a
# cache with and without causal, ALiBi with GQA groups of 2, 4 and 5.
BWD_CHANNEL_CASES = [
    ((3, 4, 2, 200, 300, 64), [300, 131, 7], None, False, False, None),
    ((2, 8, 2, 130, 1059, 128), [1059, 500], None, False, True, None),
    ((3, 4, 2, 140, 500, 64), [500, 300, 270], [5, 128, 140], False, True, None),
    ((2, 2, 1, 100, 300, 128), [350, 160], None, True, True, None),
    ((4, 2, 2, 150, 260, 64), [0, 100, 90, 100], [0, 100, 120, 0], False, True, None),
    ((2, 4, 2, 130, 300, 64), None, None, False, False, "h"),
    ((2, 4, 1, 300, 140, 128), None, None, True, False, "bh"),
    ((2, 10, 2, 256, 1024, 64), [256, 700], None, False, True, "h"),
    ((2, 8, 2, 4, 1059, 128), [1059, 700], [0, 3], False, True, "bh"),
    ((2, 6, 3, 257, 700, 64), [600, 257], [0, 200], False, False, "h"),
    # Head dim 80 (BTLM): bound + low + bound_causal, causal ALiBi, a
    # cached step with ALiBi.
    ((3, 4, 2, 140, 500, 80), [500, 300, 270], [5, 128, 140], False, True, None),
    ((2, 4, 1, 300, 300, 80), None, None, True, False, "bh"),
    ((2, 8, 2, 4, 1059, 80), [1059, 700], [0, 3], False, True, "bh"),
]


def _bwd_channels(dev, b, h, bound, low, bound_causal, alibi):
    from liteattention_torch.modules.mha import alibi_slopes

    kw = dict(bound_causal=bound_causal)
    if bound is not None:
        kw["kv_bound"] = torch.tensor(bound, dtype=torch.int32, device=dev)
    if low is not None:
        kw["kv_low"] = torch.tensor(low, dtype=torch.int32, device=dev)
    if alibi is not None:
        slopes = alibi_slopes(h).to(dev)
        kw["alibi_slopes"] = slopes if alibi == "h" else slopes * torch.linspace(
            1.0, 2.0, b, device=dev)[:, None]
    return kw


@pytest.mark.parametrize("shape,bound,low,causal,bound_causal,alibi", BWD_CHANNEL_CASES)
def test_flash_bwd_kernel_channels(dev, shape, bound, low, causal, bound_causal, alibi):
    b, h, hk, sq, sk, d = shape
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d, seed=sq + sk)
    do = _qkv(dev, b, h, hk, sq, sk, d, seed=sq)[0]
    kw = _bwd_channels(dev, b, h, bound, low, bound_causal, alibi)
    out, lse = flash_attention_plain(q, k, v, causal=causal, **kw)
    out = out.to(torch.bfloat16)
    counter = "alibi_launches" if alibi else "bound_launches"
    n0 = getattr(flash_bwd, counter)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, d**-0.5, causal, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_bwd, counter) == n0 + 1
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta, d**-0.5, causal)
    rq = flash_bwd_dq_plain(*args, **kw)
    rk, rv = flash_bwd_dkv_plain(*args, **kw)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _check_grad(got, ref)
    col = torch.arange(sk, device=dev)[None]
    hidden = torch.zeros(b, sk, dtype=torch.bool, device=dev)
    if bound is not None:
        hidden |= col >= kw["kv_bound"][:, None]
    if low is not None:
        hidden |= col < kw["kv_low"][:, None]
    if hidden.any():
        for g in (dk, dv):
            assert g.transpose(1, 2)[hidden].abs().max().item() == 0.0
    empty = ~torch.isfinite(lse)
    if empty.any():
        assert dq[empty].abs().max().item() == 0.0
    dq2, dk2, dv2 = flash_attention_bwd(q, k, v, out, lse, do, d**-0.5, causal, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _check_grad(dq2, rq)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_kernel_full_bound_matches(dev, causal):
    # A bound of Sk and a low of 0 (bound_causal under causal: the same
    # diagonal) is the channel-free backward: dK and dV bit for bit, dQ
    # (atomics) by rel-L2.
    q, k, v = _qkv(dev, 2, 8, 2, 300, 555, 128, seed=3)
    do = _qkv(dev, 2, 8, 2, 300, 555, 128, seed=4)[0]
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    full = torch.full((2,), 555, dtype=torch.int32, device=dev)
    ref = flash_attention_bwd(q, k, v, out, lse, do, 128**-0.5, causal)
    got = flash_attention_bwd(q, k, v, out, lse, do, 128**-0.5, causal, kv_bound=full,
                              kv_low=full * 0, bound_causal=causal)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    _check_grad(got[0], ref[0])


def test_flash_bwd_kernel_alibi_cache_capacity(dev):
    # ALiBi with bound_causal over a 2048-key cache and over a cache of the
    # bound's length, through autograd: the valid keys' gradients agree
    # (lse comes back from B1 less slope * (Sk - bound) and B7 adds it back,
    # so the last bits may move), the keys past the bound get 0.
    from liteattention_torch.modules.mha import alibi_slopes

    slopes = alibi_slopes(40).to(dev)
    bound = torch.tensor([1100, 1900], dtype=torch.int32, device=dev)
    q, k, v = _qkv(dev, 2, 40, 40, 64, 2048, 128, seed=7)
    do = _qkv(dev, 2, 40, 40, 64, 2048, 128, seed=8)[0]
    kw = dict(bound_causal=True, alibi_slopes=slopes)

    def grads(qx, kx, vx, dox, bnd):
        qx, kx, vx = (x.detach().clone().requires_grad_() for x in (qx, kx, vx))
        flash_attention_masked(qx, kx, vx, kv_bound=bnd, **kw).backward(dox)
        return qx.grad, kx.grad, vx.grad

    big = grads(q, k, v, do, bound)
    for i, n in enumerate(bound.tolist()):
        sl = slice(i, i + 1)
        small = grads(q[sl], k[sl, :, :n], v[sl, :, :n], do[sl], bound[sl])
        _check_grad(big[0][sl], small[0])
        for g_big, g_small in zip(big[1:], small[1:]):
            _check_grad(g_big[sl, :, :n], g_small)
            assert g_big[sl, :, n:].abs().max().item() == 0.0


# The backward also at GQA group 4, D 128, Sq > Sk (causal rows with no
# key), and at grids smaller than one wave (2 CTAs; 1 CTA with group 2).
BWD_SHAPES = SHAPES + [
    (1, 8, 2, 700, 300, 128),
    (1, 1, 1, 256, 256, 64),
    (1, 2, 1, 100, 128, 128),
    # Head dims 80 and 96 (dQ's second warpgroup over atom 1's padding).
    (1, 4, 2, 300, 555, 80),
    (1, 2, 1, 100, 128, 80),
    (2, 4, 4, 200, 200, 96),
    (1, 8, 2, 700, 300, 96),
    # Head dim 256 (GPT-J): 64-key CTAs, dK / dV / dQ split by columns over
    # the warpgroups, dQ added by float4 atomics; ragged (Sk 65: a 1-key
    # tile), GQA, Sq > Sk.
    (1, 4, 2, 300, 555, 256),
    (1, 2, 1, 100, 128, 256),
    (2, 4, 4, 200, 200, 256),
    (1, 8, 2, 700, 300, 256),
    (1, 2, 2, 130, 65, 256),
]


# Head dims B1 and B7 are not built at, and B1's channels at 96: both
# wrappers raise before a launch, naming the ROADMAP item.
@pytest.mark.parametrize("d,channels", [(32, False), (72, False), (112, True), (160, False),
                                        (96, True)])
def test_flash_kernels_raise_at_head_dims_not_built(dev, d, channels):
    q, k, v = _qkv(dev, 1, 2, 2, 64, 64, d)
    kw = dict(kv_bound=torch.tensor([40], dtype=torch.int32, device=dev)) if channels else {}
    n0 = (flash_attention.launches, flash_attention.bound_launches, flash_bwd.launches,
          flash_bwd.bound_launches)
    with pytest.raises(ValueError, match="ROADMAP B-iii"):
        flash_attention_masked(q, k, v, **kw)
    lse = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError, match="ROADMAP B-iii"):
        flash_attention_bwd(q, k, v, q, lse, q, d**-0.5, False, **kw)
    assert (flash_attention.launches, flash_attention.bound_launches, flash_bwd.launches,
            flash_bwd.bound_launches) == n0


def test_head_dim_256_channels_raise(dev):
    # At head dim 256 B1 takes its key range (above) but not ALiBi or
    # segments, B7 no channel, the lite walks nothing, and the decode kernel
    # is not built at 80 or 96: each raises before a launch, naming its
    # ROADMAP item.
    from liteattention_torch.modules.mha import alibi_slopes
    from liteattention_torch.ops.flash_fwd import flash_attention_decode

    q, k, v = _qkv(dev, 1, 2, 2, 128, 128, 256)
    ids = torch.zeros(1, 128, dtype=torch.int32, device=dev)
    bound = torch.tensor([100], dtype=torch.int32, device=dev)
    lse = torch.zeros(1, 2, 128, device=dev)
    n0 = (flash_attention.alibi_launches, flash_attention.segment_launches, flash_bwd.launches,
          flash_bwd.bound_launches, lite_flash_attention.launches)
    with pytest.raises(ValueError, match="head dim 256.*ROADMAP B-iii 4"):
        flash_attention_masked(q, k, v, alibi_slopes=alibi_slopes(2).to(dev))
    with pytest.raises(ValueError, match="head dim 256.*ROADMAP B-iii 4"):
        flash_attention_masked(q, k, v, q_segments=ids, kv_segments=ids)
    with pytest.raises(ValueError, match="head dim 256.*ROADMAP B-iii 4"):
        flash_attention_bwd(q, k, v, q, lse, q, 256**-0.5, False, kv_bound=bound)
    mask = torch.ones(1, 2, 1, 1, dtype=torch.bool, device=dev)
    fidx = torch.zeros(1, 2, 1, 1, dtype=torch.int32, device=dev)
    count = torch.ones(1, 2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim 256.*ROADMAP B-iii 4"):
        lite_flash_attention(q, k, v, fidx, count, 0.0, mask)
    assert (flash_attention.alibi_launches, flash_attention.segment_launches,
            flash_bwd.launches, flash_bwd.bound_launches, lite_flash_attention.launches) == n0
    for d in (80, 96):
        cache = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match=f"head dim {d} not built.*ROADMAP B-iii 2"):
            flash_attention_decode(torch.zeros(1, 2, 1, d, dtype=torch.bfloat16, device=dev),
                                   cache, cache)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", BWD_SHAPES)
def test_flash_bwd_kernels(dev, b, h, hk, sq, sk, d, causal):
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d, seed=1)
    do = _qkv(dev, b, h, hk, sq, sk, d, seed=2)[0]
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    out = out.to(torch.bfloat16)
    n0 = flash_bwd.launches
    dq, dk, dv = flash_bwd(q, k, v, out, lse, do, d**-0.5, causal)
    torch.cuda.synchronize()
    assert flash_bwd.launches == n0 + 1
    delta = (out.float() * do.float()).sum(-1)
    rq = flash_bwd_dq_plain(q, k, v, do, lse, delta, d**-0.5, causal)
    rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, d**-0.5, causal)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _check_grad(got, ref)
    # dK, dV: the group sum stays in one CTA, so the same launch gives the
    # same bits. dQ: CTAs add into it by atomics in no fixed order, so a
    # second run may differ in its last bits and is held by rel-L2 again.
    dq2, dk2, dv2 = flash_bwd(q, k, v, out, lse, do, d**-0.5, causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _check_grad(dq2, rq)


def test_flash_autograd_kernels(dev):
    q, k, v = (x.requires_grad_() for x in _qkv(dev, 2, 4, 2, 300, 300, 64, seed=3))
    out = flash_attention(q, k, v, causal=True)
    n0 = flash_bwd.launches
    out.float().square().sum().backward()
    assert flash_bwd.launches == n0 + 1
    qd, kd, vd = (x.detach() for x in (q, k, v))
    o, lse = flash_attention_plain(qd, kd, vd, causal=True)
    ref = flash_attention_bwd(qd, kd, vd, o.bfloat16(), lse, 2 * out.detach(), 64**-0.5, True)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert torch.isfinite(got).all()
        _check_grad(got, r)


def _doc_ids(dev, lengths, q_dead=(), k_dead=()):
    """Packed-document ids [1, sum(lengths)]: document i's tokens carry i;
    q positions in q_dead carry -1, key positions in k_dead -2."""
    ids = torch.repeat_interleave(torch.arange(len(lengths), device=dev),
                                  torch.tensor(lengths, device=dev)).to(torch.int32)
    q, k = ids.clone(), ids.clone()
    q[list(q_dead)] = -1
    k[list(k_dead)] = -2
    return q[None], k[None]


# The segment channel (batch 1): (h, hk, d, causal, ids). "docs": packed
# documents (boundaries inside and on tiles, one of 1 token, one longer
# than a tile) with dead rows and keys; "unsorted": ids in no order (the
# walk takes every tile); "cross": Sq != Sk, non-causal, ids of other
# lengths; "empty": a q-tile whose rows all carry an id no key has.
SEG_CASES = [
    (4, 2, 64, False, "docs"), (4, 2, 64, True, "docs"), (8, 2, 128, True, "docs"),
    (4, 4, 80, True, "docs"), (4, 1, 128, False, "unsorted"), (2, 2, 80, True, "unsorted"),
    (4, 2, 64, False, "cross"), (2, 2, 128, False, "empty"),
]


def _seg_inputs(dev, h, hk, d, kind):
    g = torch.Generator(device=dev).manual_seed(h * d)
    if kind in ("docs", "unsorted"):
        lengths = [300, 128, 1, 77, 256, 40, 350]
        q_seg, k_seg = _doc_ids(dev, lengths, q_dead=range(20, 40), k_dead=range(500, 530))
        if kind == "unsorted":
            perm = torch.randperm(q_seg.shape[1], generator=g, device=dev)
            q_seg, k_seg = q_seg[:, perm], k_seg[:, perm]
        sq = sk = q_seg.shape[1]
    elif kind == "cross":
        q_seg, _ = _doc_ids(dev, [100, 250, 60])
        k_seg, _ = _doc_ids(dev, [400, 30, 129])
        sq, sk = q_seg.shape[1], k_seg.shape[1]
    else:
        q_seg, k_seg = _doc_ids(dev, [200, 300])
        q_seg[:, :128] = 7
        sq = sk = 500
    q, k, v = _qkv(dev, 1, h, hk, sq, sk, d, seed=sq + d)
    return q, k, v, dict(q_segments=q_seg, kv_segments=k_seg)


@pytest.mark.parametrize("h,hk,d,causal,kind", SEG_CASES)
def test_flash_fwd_kernel_segments(dev, h, hk, d, causal, kind):
    q, k, v, seg = _seg_inputs(dev, h, hk, d, kind)
    n0 = flash_attention.segment_launches
    out, lse = flash_attention_masked(q, k, v, causal=causal, return_lse=True, **seg)
    torch.cuda.synchronize()
    assert flash_attention.segment_launches == n0 + 1
    out2, lse2 = flash_attention_masked(q, k, v, causal=causal, return_lse=True, **seg)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ro, rl = flash_attention_plain(q, k, v, causal=causal, **seg)
    diff = (out.float() - ro.float()).abs() / ro.float().abs().clamp_min(1.0)
    assert diff.max().item() < 2e-2
    assert _rel_l2(out, ro)[1] < 2e-2
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
    if kind in ("docs", "empty"):
        assert not fin.all() and out[~fin].abs().max().item() == 0.0


@pytest.mark.parametrize("h,hk,d,causal,kind", SEG_CASES)
def test_flash_bwd_kernel_segments(dev, h, hk, d, causal, kind):
    q, k, v, seg = _seg_inputs(dev, h, hk, d, kind)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(5),
                     device=dev).to(torch.bfloat16)
    out, lse = flash_attention_plain(q, k, v, causal=causal, **seg)
    out = out.to(torch.bfloat16)
    n0 = flash_bwd.segment_launches
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, d**-0.5, causal, **seg)
    torch.cuda.synchronize()
    assert flash_bwd.segment_launches == n0 + 1
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta, d**-0.5, causal)
    rq = flash_bwd_dq_plain(*args, **seg)
    rk, rv = flash_bwd_dkv_plain(*args, **seg)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _check_grad(got, ref)
    # Keys whose id no row carries and rows with no key: exactly 0.
    unseen = ~torch.isin(seg["kv_segments"][0], seg["q_segments"][0])
    if unseen.any():
        assert dk[0][:, unseen].abs().max().item() == 0.0
        assert dv[0][:, unseen].abs().max().item() == 0.0
    empty = ~torch.isfinite(lse)
    if empty.any():
        assert dq[empty].abs().max().item() == 0.0
    dq2, dk2, dv2 = flash_attention_bwd(q, k, v, out, lse, do, d**-0.5, causal, **seg)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _check_grad(dq2, rq)


def test_varlen_kernels_match_documents_alone(dev):
    # flash_attn_varlen_func over packed causal documents (GQA) against
    # each document alone through causal B1 / B7, forward and gradient; the
    # packed forms give the same bits; unpad / pad round-trip on the card.
    from liteattention_torch import (
        flash_attn_varlen_func,
        flash_attn_varlen_kvpacked_func,
        flash_attn_varlen_qkvpacked_func,
    )
    from liteattention_torch.utils.padding import pad_input, unpad_input

    lengths = [300, 1, 128, 500, 77]
    cu = torch.tensor([0, *torch.tensor(lengths).cumsum(0).tolist()], dtype=torch.int32,
                      device=dev)
    total, h, hk, d = sum(lengths), 8, 2, 128
    q, k, v = (x[0].transpose(0, 1).contiguous().requires_grad_()
               for x in _qkv(dev, 1, h, hk, total, total, d, seed=11))
    do = torch.randn(total, h, d, device=dev).to(torch.bfloat16)
    n0 = (flash_attention.segment_launches, flash_bwd.segment_launches)
    out = flash_attn_varlen_func(q, k, v, cu, cu, causal=True)
    out.backward(do)
    assert (flash_attention.segment_launches, flash_bwd.segment_launches) == (n0[0] + 1,
                                                                              n0[1] + 1)
    refs, grads = [], []
    for a, n in zip(cu[:-1].tolist(), lengths):
        qa, ka, va = (x.detach()[a : a + n].transpose(0, 1)[None].contiguous().requires_grad_()
                      for x in (q, k, v))
        o = flash_attention(qa, ka, va, causal=True)
        o.backward(do[a : a + n].transpose(0, 1)[None])
        refs.append(o.detach()[0].transpose(0, 1))
        grads.append([x.grad[0].transpose(0, 1) for x in (qa, ka, va)])
    ref = torch.cat(refs)
    assert (out.detach().float() - ref.float()).norm() / ref.float().norm() < 1e-2
    for i, got in enumerate((q.grad, k.grad, v.grad)):
        want = torch.cat([g[i] for g in grads])
        assert (got.float() - want.float()).norm() / want.float().norm() < 1e-2
    with torch.no_grad():
        qkv = torch.stack([q, k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)], 1)
        a = flash_attn_varlen_qkvpacked_func(qkv, cu, causal=True)
        b = flash_attn_varlen_func(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu, cu, causal=True)
        assert torch.equal(a, b)
        kv = torch.stack([k, v], 1)
        assert torch.equal(flash_attn_varlen_kvpacked_func(q, kv, cu, cu, causal=True),
                           out.detach())
    mask = (torch.arange(512, device=dev)[None] < torch.tensor([512, 100, 3], device=dev)[:, None])
    x = torch.randn(3, 512, 4, 64, device=dev)
    packed, idx, cu2, tot = unpad_input(x, mask.int())
    assert int(tot) == 615
    assert torch.equal(pad_input(packed, idx, 3, 512), x * mask[..., None, None])


def test_segments_raise_at_head_dim_96(dev):
    q, k, v = _qkv(dev, 1, 2, 2, 64, 64, 96)
    ids = torch.zeros(1, 64, device=dev)
    seg = dict(q_segments=ids, kv_segments=ids)
    with pytest.raises(ValueError, match="ROADMAP B-iii 4"):
        flash_attention_masked(q, k, v, **seg)
    with pytest.raises(ValueError, match="ROADMAP B-iii 4"):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 64, device=dev), q, 96**-0.5, False,
                            **seg)


# B2's Kt: 1, odd, 15/16 around a 16-byte load, the denoise-compaction
# path's 195, the Wan slice's 256, 300, and 1024 (two warp-wide passes).
PACK_KT = [1, 15, 16, 37, 195, 256, 300, 1024]


def _pack_mask(dev, kt, b=2, h=3, qt=9, seed=0):
    """Random rows at ~40 % live, a row with no live tile, an all-live row
    and a band; 2 x 3 x 9 = 54 rows, not a multiple of a CTA's 8 rows."""
    g = torch.Generator(device=dev).manual_seed(kt + seed)
    m = torch.rand(b, h, qt, kt, generator=g, device=dev) < 0.4
    m[0, 1, 2] = False
    m[0, h - 1, 3] = True
    m[1, 0, :, : kt // 2] = True
    return m


@pytest.mark.parametrize("kt", PACK_KT)
def test_schedule_pack_kernel(dev, kt):
    m = _pack_mask(dev, kt)
    fidx, count = pack_schedule(m)
    torch.cuda.synchronize()
    rf, rc = pack_schedule_plain(m)
    assert torch.equal(fidx, rf) and torch.equal(count, rc)
    # A mask view that starts 1 byte into its storage: no row is aligned.
    store = torch.zeros(m.numel() + 1, dtype=torch.bool, device=dev)
    store[1:] = m.reshape(-1)
    view = store[1:].view(m.shape)
    fidx, count = pack_schedule(view)
    assert torch.equal(fidx, rf) and torch.equal(count, rc)


@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("kt", PACK_KT)
def test_schedule_pack_kv_map_kernel(dev, kt, group):
    from liteattention_torch.ops.kv_compact import kv_union_map

    m = _pack_mask(dev, kt, h=2 * group, seed=group)
    kv_map, _, _ = kv_union_map(m, hk=2)
    got = pack_schedule(m, kv_map)
    torch.cuda.synchronize()
    for a, want in zip(got, pack_schedule_plain(m, kv_map)):
        assert torch.equal(a, want)


def test_schedule_pack_kernel_wan_shape(dev):
    # The Wan slice's [1, 40, 256, 256]: 10 240 rows, more than the card
    # holds resident at 8 rows a CTA; every row of head 7 dead.
    g = torch.Generator(device=dev).manual_seed(3)
    m = torch.rand(1, 40, 256, 256, generator=g, device=dev) < 0.5
    m[0, 7] = False
    fidx, count = pack_schedule(m)
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


def _stable_votes(plain, thr):
    """Tiles whose plain vote is the same at thr -/+ 1e-3: outside the
    margin where fp32 summation order can flip a vote."""
    return plain(thr - 1e-3)[2] == plain(thr + 1e-3)[2]


# (bq, bk, super-tile, D, Sk): coarse votes AND-ed over 2 CTAs (bq 256),
# coarse steps of 2 fine tiles (bk 256), super-tile bitmaps; Sq 700 / Sk 900
# leave ragged tails and a coarse tile hanging past the keys; D 64; Sk 1024,
# a multiple of 128 but not of bk 384, a coarse tile hanging past whole
# fine tiles.
@pytest.mark.parametrize("bq,bk,fine,d,sk", [
    (256, 256, False, 128, 900), (128, 256, False, 128, 900), (256, 128, False, 128, 900),
    (256, 256, True, 128, 900), (128, 384, True, 128, 900),
    (256, 256, False, 64, 900), (256, 256, True, 64, 900),
    (256, 384, False, 128, 1024), (128, 384, True, 64, 1024),
])
def test_lite_coarse_kernel(dev, bq, bk, fine, d, sk):
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention_coarse_plain
    from liteattention_torch.ops.mask import compact_mask, compact_mask_fine

    q, k, v = _qkv(dev, 1, 4, 2, 700, sk, d, seed=bq + bk)
    g = torch.Generator(device=dev).manual_seed(bk)
    qs, ks = bq // 128, bk // 128
    if fine:
        m = torch.rand(1, 4, 6, 8, generator=g, device=dev) < 0.45
        m[0, 1, 2] = False  # a fine row with nothing live
        idx, count, bits = compact_mask_fine(m, qs, ks)
    else:
        m = torch.rand(1, 4, -(-700 // bq), -(-sk // bk), generator=g, device=dev) < 0.6
        m[0, 1, 1] = False  # a coarse row with nothing live: tile 0 computed
        (idx, count), bits = compact_mask(m), None

    def plain(thr):
        return lite_flash_attention_coarse_plain(q, k, v, idx, count, thr, bits, qsub=qs, ksub=ks)

    for thr in (-1.0, float("inf")):
        n0 = lite_flash_attention.coarse_launches
        out, lse, votes = lite_flash_attention(
            q, k, v, idx, count, thr, kv_bits=bits, block_sizes=BlockSizes(bq, bk),
            fine_schedule=False,
        )
        torch.cuda.synchronize()
        assert lite_flash_attention.coarse_launches == n0 + 1
        ro, rl, rv = plain(thr)
        assert (out.float() - ro.float()).abs().max().item() < 2e-2
        fin = torch.isfinite(rl)
        assert torch.equal(fin, torch.isfinite(lse)) and fin.all() != fine
        assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
        stable = _stable_votes(plain, thr) if thr < float("inf") else torch.ones_like(rv, dtype=bool)
        bad = (votes != rv) & stable
        assert not bad.any(), int(bad.sum())
        if thr < float("inf"):
            assert 0 < rv.float().mean().item() < 1


def test_lite_fold_kernel(dev):
    # B5: fold_h heads per CTA, bit-identical to B3, with GQA and a dead row.
    q, k, v = _qkv(dev, 1, 8, 2, 700, 900, 128, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    m = torch.rand(1, 8, 6, 8, generator=g, device=dev) < 0.5
    m[..., 0] = True
    m[0, 3, 2] = False
    fidx, count = pack_schedule(m)
    for emit in (True, False):
        base = lite_flash_attention(q, k, v, fidx, count, -1.0, m, emit_votes=emit)
        for fold in (2, 8):
            n0 = lite_flash_attention.hfold_launches
            got = lite_flash_attention(q, k, v, fidx, count, -1.0, m, emit_votes=emit, fold_h=fold)
            torch.cuda.synchronize()
            assert lite_flash_attention.hfold_launches == n0 + 1
            for a, b in zip(got, base):
                assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError):
        lite_flash_attention(q, k, v, fidx, count, -1.0, m, fold_h=3)


def test_kv_compact_kernels(dev):
    # B6 exactly equal to its plain version; B2's kv_map channel exact; B3
    # loading from the compacted buffer bit-identical to B3 on K/V.
    from liteattention_torch.ops.kv_compact import compact_kv, compact_kv_plain, kv_union_map

    q, k, v = _qkv(dev, 2, 6, 3, 700, 1024, 128, seed=6)
    g = torch.Generator(device=dev).manual_seed(6)
    m = torch.rand(2, 6, 6, 8, generator=g, device=dev) < 0.3
    m[..., :, 4:] = False  # the back half dead: a sparse union
    m[0, 2, 1] = False  # a row with nothing live
    kv_map, inv, _ = kv_union_map(m, hk=3)
    n0 = compact_kv.launches
    kc, vc = compact_kv(k, v, inv)
    torch.cuda.synchronize()
    assert compact_kv.launches == n0 + 1
    rk, rv = compact_kv_plain(k, v, inv)
    assert torch.equal(kc, rk) and torch.equal(vc, rv)
    fidx, count, cidx = pack_schedule(m, kv_map)
    for got, want in zip((fidx, count, cidx), pack_schedule_plain(m, kv_map)):
        assert torch.equal(got, want)
    for emit in (True, False):
        base = lite_flash_attention(q, k, v, fidx, count, -1.0, m, emit_votes=emit)
        for fold in (None, 2):  # B3 and B5 on the compacted buffer
            got = lite_flash_attention(q, kc, vc, fidx, count, -1.0, m, emit_votes=emit,
                                       cidx=cidx, fold_h=fold)
            for a, b in zip(got, base):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("form", ["identity", "reversed", "random"])
def test_kv_compact_kernel_forms(dev, d, form):
    # B6 bit-equal to its plain version in one launch: B 2, Hk 3, 139 tiles
    # a head (each CTA's copies wrap its ring, and 2 x 3 x 139 x 2 copies are
    # no multiple of the ring's stages), D 256 in two parts a tile.
    from liteattention_torch.ops.kv_compact import compact_kv, compact_kv_plain

    b, hk, kt = 2, 3, 139
    g = torch.Generator(device=dev).manual_seed(d)
    k, v = (torch.randn(b, hk, kt * 128, d, generator=g, device=dev).bfloat16() for _ in range(2))
    if form == "identity":
        inv = torch.arange(kt, device=dev).expand(b, hk, kt)
    elif form == "reversed":
        inv = torch.arange(kt - 1, -1, -1, device=dev).expand(b, hk, kt)
    else:
        inv = torch.stack([torch.randperm(kt, generator=g, device=dev) for _ in range(b * hk)])
    inv = inv.reshape(b, hk, kt).int().contiguous()
    n0 = compact_kv.launches
    kc, vc = compact_kv(k, v, inv)
    torch.cuda.synchronize()
    assert compact_kv.launches == n0 + 1
    rk, rv = compact_kv_plain(k, v, inv)
    assert torch.equal(kc, rk) and torch.equal(vc, rv)


def test_blocksparse_without_kernel_raises(dev):
    # The block-sparse cases that have no kernel raise on the card rather
    # than run the plain exact path; the kernel route matches that path.
    from liteattention_torch.flash_blocksparse import (
        FlashBlocksparseAttention,
        _blockmask_elementwise,
        _exact_attention,
        flash_blocksparse_attn_func,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    s, h = 512, 2
    qkv = torch.randn(2 * s, 3, h, 64, generator=g, device=dev).bfloat16()
    cu = torch.tensor([0, s, 2 * s])
    layout = torch.rand(s // 128, s // 256, generator=g, device=dev) < 0.6
    layout = layout.cpu().repeat_interleave(8, 0).numpy()  # uniform per 8 rows
    layout[:, 0] = True
    out = flash_blocksparse_attn_func(qkv, cu, layout, max_s=s)
    q, k, v = qkv.reshape(2, s, 3, h, 64).unbind(2)
    ref = _exact_attention(q, k, v, _blockmask_elementwise(layout, s, s, dev), None, False)
    assert (out.float() - ref.reshape(out.shape).float()).abs().max().item() < 2e-2
    ragged = torch.tensor([0, s, 2 * s - 100])
    uneven = layout.copy()
    uneven[3, 1] = not uneven[3, 1]
    for kw in (dict(cu_seqlens=ragged, blockmask=layout), dict(blockmask=uneven),
               dict(causal=True), dict(dropout_p=0.1, generator=torch.Generator(device=dev)),
               dict(return_attn_probs=True), dict(trainable=True)):
        args = {"cu_seqlens": cu, "blockmask": layout, **kw}
        with pytest.raises(NotImplementedError):
            flash_blocksparse_attn_func(qkv[: int(args["cu_seqlens"][-1])], max_s=s, **args)
    mod = FlashBlocksparseAttention(layout, attention_dropout=0.1, max_seq_length=s)
    x = qkv.reshape(2, s, 3, h, 64)
    with pytest.raises(NotImplementedError):
        mod(x, key_padding_mask=torch.ones(2, s, dtype=torch.bool, device=dev))
    with pytest.raises(NotImplementedError):
        mod(x, training=True, generator=torch.Generator(device=dev))


def _check_decode(out, lse, ro, rl):
    """Decode kernel against its plain version: out within 2e-2 absolute
    and 1e-2 rel-L2 (bf16 output, P rounded to bf16 before PV), lse within
    1e-3, rows with no valid key out 0 / lse -inf in both."""
    assert out.dtype == ro.dtype and out.shape == ro.shape and lse.shape == rl.shape
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (out.float() - ro.float()).abs().max().item() < 2e-2
    assert _rel_l2(out.float(), ro.float())[0] < 1e-2
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
    if not fin.all():
        assert out[~fin].abs().max().item() == 0.0


# (b, h, hk, sq, s_max, d, int8, layout, causal, softcap, splits)
DECODE_CASES = [
    (8, 32, 8, 1, 4096, 128, False, "bshd", False, 0.0, 0),  # the serving shape
    (8, 32, 8, 1, 4096, 128, True, "bshd", False, 0.0, 0),
    (2, 8, 8, 1, 1000, 64, False, "bhsd", False, 0.0, 0),  # MHA, D 64, head-major
    (3, 16, 2, 1, 777, 128, False, "bhsd", False, 30.0, 5),  # group 8, softcap
    (2, 8, 2, 4, 600, 128, False, "bshd", True, 0.0, 3),  # causal sq 4
    (2, 4, 1, 16, 300, 64, True, "bhsd", True, 0.0, 0),  # 64 rows, 4 row tiles
    # Head dim 256 (GPT-J: 16 heads, no GQA): 64-key tiles, the merge in two
    # rounds (bf16) or four (int8).
    (8, 16, 16, 1, 2048, 256, False, "bshd", False, 0.0, 0),
    (8, 16, 16, 1, 2048, 256, True, "bshd", False, 0.0, 0),
    (3, 16, 2, 1, 777, 256, True, "bhsd", False, 30.0, 5),
    (2, 8, 2, 4, 600, 256, False, "bshd", True, 0.0, 3),
    (2, 4, 1, 16, 300, 256, True, "bhsd", True, 0.0, 0),
]


@pytest.mark.parametrize("b,h,hk,sq,s_max,d,int8,layout,causal,softcap,splits", DECODE_CASES)
def test_flash_decode_kernel(dev, b, h, hk, sq, s_max, d, int8, layout, causal, softcap, splits):
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
    )
    from liteattention_torch.ops.kv_quant import quantize_kv_cache

    g = torch.Generator(device=dev).manual_seed(b * s_max + d)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).bfloat16()
    kc = torch.randn(b, s_max, hk, d, generator=g, device=dev).bfloat16()
    vc = torch.randn(b, s_max, hk, d, generator=g, device=dev).bfloat16()
    bound = torch.randint(sq, s_max + 1, (b,), generator=g, device=dev).int()
    bound[0] = s_max
    low = torch.randint(0, 50, (b,), generator=g, device=dev).int()
    low[-1] = bound[-1]  # a batch row with no valid key
    kw = dict(kv_bound=bound, kv_low=low, softcap=softcap, causal=causal)
    if int8:
        cache = quantize_kv_cache(kc, vc)
        kc, vc = cache.k, cache.v
        kw.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if layout == "bhsd":  # a head-major cache passed as a strided view
        kc, vc = kc.transpose(1, 2).contiguous().transpose(1, 2), vc.transpose(1, 2).contiguous().transpose(1, 2)
    n0 = flash_attention_decode.launches
    out, lse = flash_attention_decode(q, kc, vc, num_splits=splits, **kw)
    torch.cuda.synchronize()
    assert flash_attention_decode.launches == n0 + 1
    ro, rl = flash_attention_decode_plain(q, kc, vc, **kw)
    assert not torch.isfinite(rl[-1]).any()
    _check_decode(out, lse, ro, rl)
    # Any number of splits gives the same result.
    for n in (1, 2, 7):
        o2, l2 = flash_attention_decode(q, kc, vc, num_splits=n, **kw)
        _check_decode(o2, l2, ro, rl)


@pytest.mark.parametrize("folded,int8,page_size,sq,d,group", [
    (True, False, 256, 1, 128, 4),
    (True, True, 256, 1, 128, 4),
    (True, False, 16, 4, 128, 4),  # causal appends, pages smaller than a tile
    (False, False, 64, 1, 64, 1),
    (False, False, 16, 3, 128, 8),
    (True, False, 64, 1, 256, 1),  # head dim 256: pages of one 64-key tile
    (True, True, 64, 1, 256, 2),
    (True, False, 16, 4, 256, 4),
    (False, False, 128, 1, 256, 1),
])
def test_paged_decode_kernel(dev, folded, int8, page_size, sq, d, group):
    from liteattention_torch.ops.kv_quant import quantize_kv_pages
    from liteattention_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_folded,
        paged_attention_folded_plain,
        paged_attention_plain,
    )

    b, hk, pages_per_seq = 4, 2, 8
    n_pages = b * pages_per_seq + 3
    g = torch.Generator(device=dev).manual_seed(page_size + sq)
    q = torch.randn(b, sq, hk * group, d, generator=g, device=dev).bfloat16()
    shape = (n_pages, page_size, hk, d) if folded else (hk, n_pages, page_size, d)
    kp = torch.randn(*shape, generator=g, device=dev).bfloat16()
    vp = torch.randn(*shape, generator=g, device=dev).bfloat16()
    table = torch.randperm(n_pages, generator=g, device=dev)[: b * pages_per_seq]
    table = table.reshape(b, pages_per_seq).int()
    lengths = torch.randint(sq, pages_per_seq * page_size + 1, (b,), generator=g, device=dev)
    lengths = lengths.int()
    lengths[0] = pages_per_seq * page_size
    kw = dict(return_lse=True, causal=True)
    if folded:
        fn, plain = paged_attention_folded, paged_attention_folded_plain
        if int8:
            pool = quantize_kv_pages(kp, vp)
            kp, vp = pool.k, pool.v
            kw.update(k_scale=pool.k_scale, v_scale=pool.v_scale)
    else:
        fn, plain = paged_attention, paged_attention_plain
    n0 = fn.launches
    out, lse = fn(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    ro, rl = plain(q, kp, vp, lengths, table, **kw)
    assert out.shape == (b, sq, hk * group, d) and lse.shape == (b, hk * group, sq)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out.float() - ro.float()).abs().max().item() < 2e-2
    assert (lse - rl).abs().max().item() < 1e-3


# (int8, causal, grid): ragged lengths with an empty row, a row shorter than
# one key tile and a full one; the grid at one CTA per SM (0) or
# forced to 3 CTAs per unit, so units are split and merged in the kernel.
@pytest.mark.parametrize("int8,causal,splits", [
    (False, False, 0), (True, False, 0), (False, True, 3), (True, True, 3),
])
def test_flash_decode_ragged_one_launch(dev, int8, causal, splits):
    from liteattention_torch.ops.flash_fwd import (
        flash_attention_decode,
        flash_attention_decode_plain,
    )
    from liteattention_torch.ops.kv_quant import quantize_kv_cache

    b, h, hk, sq, s_max, d = 6, 16, 4, 2 if causal else 1, 2048, 128
    g = torch.Generator(device=dev).manual_seed(11 + int8)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).bfloat16()
    kc = torch.randn(b, s_max, hk, d, generator=g, device=dev).bfloat16()
    vc = torch.randn(b, s_max, hk, d, generator=g, device=dev).bfloat16()
    # Rows past a request's bound hold NaN: they must never reach the output.
    bound = torch.tensor([s_max, 0, 37, 1500, 64, 700], dtype=torch.int32, device=dev)
    for i, n in enumerate(bound.tolist()):
        kc[i, n:] = float("nan")
        vc[i, n:] = float("nan")
    kw = dict(kv_bound=bound, causal=causal)
    if int8:
        cache = quantize_kv_cache(kc.nan_to_num(0.0), vc.nan_to_num(0.0))
        kc, vc = cache.k, cache.v
        kw.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    n0 = flash_attention_decode.launches
    out, lse = flash_attention_decode(q, kc, vc, num_splits=splits, **kw)
    again = flash_attention_decode(q, kc, vc, num_splits=splits, **kw)
    torch.cuda.synchronize()
    assert flash_attention_decode.launches == n0 + 2  # one launch a call, the merge inside
    # The tickets were put back: a second call gives the same bits.
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ro, rl = flash_attention_decode_plain(q, kc.nan_to_num(0.0) if not int8 else kc,
                                          vc.nan_to_num(0.0) if not int8 else vc, **kw)
    assert torch.isfinite(out).all()
    assert not torch.isfinite(rl[1]).any() and out[1].abs().max().item() == 0.0
    _check_decode(out, lse, ro, rl)


def test_decode_tile_keys_match_the_kernel(dev):
    # The plain version splits by tile_keys; the launches size their checks
    # by the tile the library reports (0 where the kernel is not built).
    from liteattention_torch.ops.flash_decode import HEAD_DIMS, kernel_tile_keys, tile_keys

    assert [kernel_tile_keys(d) for d in HEAD_DIMS] == [tile_keys(d) for d in HEAD_DIMS]
    assert kernel_tile_keys(80) == kernel_tile_keys(96) == 0


def test_paged_decode_small_pages_and_raises(dev):
    # Pages of 8 keys: one TMA box per page, 8 (bf16) or 16 (int8) a tile;
    # a page of 12 keys cannot be cut into 8-row boxes and raises.
    from liteattention_torch.ops.kv_quant import quantize_kv_pages
    from liteattention_torch.ops.paged_attention import (
        paged_attention_folded,
        paged_attention_folded_plain,
    )

    b, hk, group, d, pps = 3, 2, 4, 128, 40
    g = torch.Generator(device=dev).manual_seed(12)
    for page_size, int8 in ((8, False), (8, True), (24, False)):
        n_pages = b * pps + 5
        q = torch.randn(b, 1, hk * group, d, generator=g, device=dev).bfloat16()
        kp = torch.randn(n_pages, page_size, hk, d, generator=g, device=dev).bfloat16()
        vp = torch.randn(n_pages, page_size, hk, d, generator=g, device=dev).bfloat16()
        table = torch.randperm(n_pages, generator=g, device=dev)[: b * pps].reshape(b, pps).int()
        lengths = torch.tensor([pps * page_size, 5, 0], dtype=torch.int32, device=dev)
        kw = dict(return_lse=True)
        if int8:
            pool = quantize_kv_pages(kp, vp)
            kp, vp = pool.k, pool.v
            kw.update(k_scale=pool.k_scale, v_scale=pool.v_scale)
        out, lse = paged_attention_folded(q, kp, vp, lengths, table, **kw)
        ro, rl = paged_attention_folded_plain(q, kp, vp, lengths, table, **kw)
        torch.cuda.synchronize()
        assert (out.float() - ro.float()).abs().max().item() < 2e-2
        fin = torch.isfinite(rl)
        assert torch.equal(fin, torch.isfinite(lse)) and not fin[2].any()
        assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
    kp = torch.randn(b * pps, 12, hk, d, device=dev).bfloat16()
    table = torch.arange(b * pps, device=dev).reshape(b, pps).int()
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_folded(q, kp, kp, lengths, table)


@pytest.mark.parametrize("gsize", [1, 2])
def test_lite_fwd_kernel_dead_row_and_compacted(dev, gsize):
    # B3 on B1's mainloop: a row with no live tile (out 0, lse -inf), vote
    # steps of gsize entries, loads from the union-compacted K/V at cidx
    # (bit for bit as from K/V), and B5 at fold 2 and 4 equal to B3.
    from liteattention_torch.ops.kv_compact import compact_kv, kv_union_map

    q, k, v = _qkv(dev, 1, 8, 2, 640, 1024, 128, seed=20 + gsize)
    g = torch.Generator(device=dev).manual_seed(21)
    m = torch.rand(1, 8, 5, 8, generator=g, device=dev) < 0.5
    m[..., :, 6:] = False  # a sparse union, so the compacted buffer is shorter
    m[..., 0] = True
    m[0, 3, 2] = False  # dead row
    fidx, count = pack_schedule(m)
    bs = BlockSizes(128, 128 * gsize)
    head = vote_headroom(q, k, fidx, count, gsize=gsize)
    valid = torch.arange(8, device=dev) < count[..., None]
    thr = head[valid & (head > -1e30)].median().item()
    ro, rl, rv = lite_flash_attention_plain(q, k, v, fidx, count, thr, m, gsize=gsize)
    out, lse, votes = lite_flash_attention(q, k, v, fidx, count, thr, m, block_sizes=bs)
    torch.cuda.synchronize()
    assert (out.float() - ro.float()).abs().max().item() < 2e-2
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse)) and not fin[0, 3, 256:384].any()
    assert out[0, 3, 256:384].abs().max().item() == 0.0
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
    margin = torch.where(valid, (head - thr).abs(), torch.full_like(head, float("inf")))
    fine_margin = torch.full(m.shape, float("inf"), device=dev)
    fine_margin.scatter_reduce_(-1, fidx.long(), margin, reduce="amin")
    assert not ((votes != rv) & (fine_margin >= 1e-3)).any()
    kv_map, inv, _ = kv_union_map(m, hk=2)
    kc, vc = compact_kv(k, v, inv)
    fidx_c, count_c, cidx = pack_schedule(m, kv_map)
    base = (out, lse, votes)
    for fold in (None, 2, 4):
        got = lite_flash_attention(q, kc, vc, fidx_c, count_c, thr, m, block_sizes=bs,
                                   cidx=cidx, fold_h=fold)
        assert all(torch.equal(a, b) for a, b in zip(got, base))
        got = lite_flash_attention(q, k, v, fidx, count, thr, m, block_sizes=bs, fold_h=fold)
        assert all(torch.equal(a, b) for a, b in zip(got, base))


def test_entry_points_default_to_the_card(dev):
    from liteattention_torch.layers.rotary import rotary_freqs
    from liteattention_torch.models import GPTConfig, GPTLMHeadModel, WanConfig, WanModel
    from liteattention_torch.modules import MHA, Block, Dense, GatedMlp, Mlp
    from liteattention_torch.ops.mask import init_mask
    from liteattention_torch.training import TrainConfig, Trainer

    gpt = GPTLMHeadModel(GPTConfig.tiny())
    assert all(p.device == dev for p in gpt.parameters())
    assert all(p.device == dev for p in WanModel(WanConfig.tiny()).parameters())
    for module in (MHA(64, 2), Block(64), Mlp(64, 128), GatedMlp(64, 128), Dense(64, 32)):
        assert all(p.device == dev for p in module.parameters())
    assert all(x.device == dev for x in rotary_freqs(16, 32))
    assert init_mask(1, 2, 256, 256, 128, 128).do_mask.device == dev
    assert Trainer(gpt, lambda m, x: m(x).sum(), TrainConfig()).device == dev


# (form, sq, hq, pages per request, page size): the DeepSeek decode shape in
# every cache form, the causal 2-token verify; the requests' keys split over
# the SMs, their pieces merged inside the launch. Then pages of 96 keys (64
# does not divide them: boxes of 32 rows), of 24 (boxes of 8) and of 20
# (under 8 rows a box: row by row), and a contiguous cache of 3 x 64 keys,
# each with a request shorter than one 64-key tile.
MLA_DECODE_CASES = [
    ("contiguous", 1, 128, 24, 64), ("paged", 1, 128, 24, 64), ("permuted", 1, 128, 24, 64),
    ("wide", 1, 128, 24, 64), ("contiguous", 2, 32, 24, 64), ("paged", 1, 128, 12, 64),
    ("permuted", 2, 16, 12, 64),
    ("permuted", 1, 128, 16, 96), ("permuted", 2, 32, 40, 24), ("paged", 1, 64, 30, 20),
    ("contiguous", 1, 128, 3, 64), ("paged", 3, 32, 12, 64),
]


@pytest.mark.parametrize("form,sq,hq,pps,ps", MLA_DECODE_CASES)
def test_mla_decode_kernel(dev, form, sq, hq, pps, ps):
    """B10 against its plain version: out within 2e-2 absolute and 1e-2
    rel-L2, lse within 1e-3; a request of length 0 gives out 0 and lse
    -inf; a 640-lane cache reads only its first 576 channels; one launch,
    and torch.profiler sees one B10 kernel and no merge kernel."""
    from liteattention_torch.ops.mla import mla_decode, mla_decode_plain

    b, d, dv = 5, 576, 512
    g = torch.Generator(device=dev).manual_seed(sq * hq + pps)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).bfloat16()
    lanes = 640 if form == "wide" else d
    n_pages = b * pps + 2
    pool = torch.randn(n_pages, ps, lanes, generator=g, device=dev).bfloat16()
    lens = torch.randint(1, pps * ps + 1, (b,), generator=g, device=dev).int()
    lens[0], lens[1] = pps * ps, 0
    if ps != 64 or pps < 6:
        lens[2] = 37  # under one tile
    table = None
    if form in ("paged", "permuted"):
        perm = torch.randperm(n_pages, generator=g, device=dev) if form == "permuted" \
            else torch.arange(n_pages, device=dev)
        table = perm[: b * pps].reshape(b, pps).int()
        cache = pool
    else:
        cache = pool[: b * pps].reshape(b, pps * ps, lanes)
    n0 = mla_decode.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out, lse = mla_decode(q, cache, lens, dv, page_table=table, return_lse=True)
        torch.cuda.synchronize()
    assert mla_decode.launches == n0 + 1
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(n for k, n in kernels.items() if "mla_decode_kernel" in k) == 1, kernels
    assert not any("merge" in k for k in kernels), kernels
    ro, rl = mla_decode_plain(q, cache, lens, dv, page_table=table, return_lse=True)
    assert out.shape == (b, sq, hq, dv) and lse.shape == (b, hq, sq)
    _check_decode(out.transpose(1, 2), lse, ro.transpose(1, 2), rl)
    assert (out[1] == 0).all() and torch.isneginf(lse[1]).all()
    if form == "wide":
        tight = mla_decode(q, cache[..., :d].contiguous(), lens, dv, return_lse=True)
        assert torch.equal(tight[0], out) and torch.equal(tight[1], lse)


def test_mla_decode_kernel_many_short_requests(dev):
    """B10 over 300 requests of 0-200 keys (a CTA's scan covers two
    requests a thread, a chunk many whole requests): against its plain
    version, twice with equal results (the tickets are back at 0)."""
    from liteattention_torch.ops.mla import mla_decode, mla_decode_plain

    b, hq, d, dv = 300, 16, 576, 512
    g = torch.Generator(device=dev).manual_seed(300)
    q = torch.randn(b, 1, hq, d, generator=g, device=dev).bfloat16()
    cache = torch.randn(b, 200, d, generator=g, device=dev).bfloat16()
    lens = torch.randint(0, 201, (b,), generator=g, device=dev).int()
    lens[:3] = torch.tensor([0, 200, 1])
    out, lse = mla_decode(q, cache, lens, dv, return_lse=True)
    again = mla_decode(q, cache, lens, dv, return_lse=True)
    torch.cuda.synchronize()
    ro, rl = mla_decode_plain(q, cache, lens, dv, return_lse=True)
    _check_decode(out.transpose(1, 2), lse, ro.transpose(1, 2), rl)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("ps", [0, 64, 96, 20])
def test_mla_decode_kernel_ignores_the_cache_past_the_lengths(dev, ps):
    """Rows of the cache past a request's length hold NaN (contiguous, ps
    0, or pages of 64, 96 and 20 keys, unused table entries out of range):
    out and lse equal B10 over the same cache with those rows set to 0."""
    from liteattention_torch.ops.mla import mla_decode

    b, hq, d, dv, s = 4, 32, 576, 512, 480
    g = torch.Generator(device=dev).manual_seed(ps + 7)
    q = torch.randn(b, 1, hq, d, generator=g, device=dev).bfloat16()
    lens = torch.tensor([480, 33, 0, 301], device=dev, dtype=torch.int32)
    clean = torch.randn(b, s, d, generator=g, device=dev).bfloat16()
    clean[torch.arange(s, device=dev)[None] >= lens[:, None].long()] = 0
    dirty = clean.clone()
    dirty[torch.arange(s, device=dev)[None] >= lens[:, None].long()] = float("nan")
    table = None
    if ps:
        pps = -(-s // ps)
        pad = pps * ps - s
        perm = torch.randperm(b * pps, generator=g, device=dev)
        table = perm.reshape(b, pps).int()

        def pool(c):
            c = torch.nn.functional.pad(c, (0, 0, 0, pad), value=float("nan"))
            out = torch.empty(b * pps, ps, d, device=dev, dtype=c.dtype)
            out[perm] = c.reshape(b * pps, ps, d)
            return out

        clean, dirty = pool(clean), pool(dirty)
        clean = torch.nan_to_num(clean, nan=0.0)
        for i, n in enumerate(lens.tolist()):  # unused entries point nowhere
            table[i, -(-n // ps):] = 1 << 20
    want = mla_decode(q, clean, lens, dv, page_table=table, return_lse=True)
    got = mla_decode(q, dirty, lens, dv, page_table=table, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mla_decode_kernel_raises_on_what_it_does_not_take(dev):
    from liteattention_torch.ops.mla import mla_decode

    q = torch.zeros(2, 1, 16, 256, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(2, 128, 256, device=dev, dtype=torch.bfloat16)
    lens = torch.full((2,), 128, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="D 576 / Dv 512"):
        mla_decode(q, kv, lens, 128)
    with pytest.raises(TypeError, match="bf16"):
        mla_decode(q.float(), kv.float(), lens, 128)


# (b, h, hk, sq, sk, d, dv, qv): DeepSeek's prefill shape with GQA, the
# absorbed widths, the qv term; ragged tiles and Sq > Sk. Then one KV head
# under 16 and 128 q heads at the V-512 shapes; Sq > Sk (causal rows with no
# key); Sq 1, 63 and 65 (a partial 64-row block of the split-O kernel, and
# of B1's 128-row tile); Sk under one tile (64 keys at V 512, 128 at (192,
# 128)); long walks through the rings (K and V refilled many times).
MLA_FWD_CASES = [
    (2, 4, 2, 300, 555, 192, 128, False),
    (1, 2, 2, 1000, 640, 192, 128, False),
    (1, 3, 3, 200, 333, 576, 512, False),
    (2, 2, 1, 130, 97, 64, 512, True),
    (1, 16, 1, 200, 333, 576, 512, False),
    (1, 128, 1, 70, 150, 576, 512, False),
    (1, 16, 1, 130, 200, 64, 512, True),
    (1, 128, 1, 65, 129, 64, 512, True),
    (1, 4, 2, 300, 100, 576, 512, False),
    (2, 2, 1, 200, 70, 64, 512, True),
    (1, 4, 1, 1, 300, 576, 512, False),
    (1, 4, 1, 63, 63, 64, 512, True),
    (1, 4, 4, 65, 129, 576, 512, False),
    (1, 8, 1, 1, 1059, 192, 128, False),
    (1, 4, 2, 65, 300, 192, 128, False),
    (1, 4, 1, 100, 40, 576, 512, False),
    (1, 4, 2, 70, 1, 64, 512, True),
    (1, 4, 2, 100, 50, 192, 128, False),
    (1, 2, 1, 1000, 1500, 576, 512, False),
    (1, 2, 1, 900, 1200, 64, 512, True),
    (1, 2, 2, 1500, 1700, 192, 128, False),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hk,sq,sk,d,dv,use_qv", MLA_FWD_CASES)
def test_flash_fwd_mla_kernel(dev, b, h, hk, sq, sk, d, dv, use_qv, causal):
    """B1's MLA kernels against the plain version, with B1's own
    tolerances (out 2e-2, over max(1, |plain|) when causal; lse 1e-3);
    neither has atomics, so a second launch gives the same bits."""
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(d + dv + sq)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()  # noqa: E731
    q, k, v = mk(b, h, sq, d), mk(b, hk, sk, d), mk(b, hk, sk, dv)
    qv = mk(b, h, sq, dv) if use_qv else None
    counter = "mla_v512_launches" if dv == 512 else "mla_launches"
    n0 = getattr(flash_attention, counter)
    out, lse = flash_attention(q, k, v, causal=causal, qv=qv, return_lse=True)
    torch.cuda.synchronize()
    assert getattr(flash_attention, counter) == n0 + 1
    out2, lse2 = flash_attention(q, k, v, causal=causal, qv=qv, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ro, rl = flash_attention_plain(q, k, v, 1.0 / d**0.5, causal, qv=qv)
    assert out.shape == (b, h, sq, dv)
    diff = (out.float() - ro.float()).abs()
    if causal:
        diff = diff / ro.float().abs().clamp_min(1.0)
    assert diff.max().item() < 2e-2
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse))
    if causal and sq > sk:
        assert out[~fin].abs().max().item() == 0.0
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3


def test_flash_fwd_mla_kernel_raises_on_other_shapes(dev):
    q = torch.zeros(1, 2, 64, 128, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 64, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A11"):
        flash_attention(q, q, v)


def test_wan_training_step_on_card(dev):
    # fp32 master weights, bf16 products on the card: remat launches B1 a
    # second time a block and gives the gradients of the stored forward
    # (each leaf scaled by its max within 2e-2, the JAX remat test's
    # bound); both within rel-L2 5e-2 of the same step through the plain
    # versions in fp32 on the CPU; the probe refuses TF32 products.
    import dataclasses

    from liteattention_torch.models import WanConfig, WanModel

    cfg = dataclasses.replace(WanConfig.tiny(), attn_probe_rows=8)
    cpu = WanModel(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(1, 2, 16, 20, 16, generator=g)
    text = torch.randn(1, 16, 64, generator=g)
    tt = torch.full((1,), 500.0)
    (cpu(lat, tt, text)[0] ** 2).mean().backward()
    ref = {n: p.grad for n, p in cpu.named_parameters()}
    grads = {}
    for remat in (False, True):
        model = WanModel(dataclasses.replace(cfg, remat=remat), device=dev).float()
        model.load_state_dict(cpu.state_dict())
        n0, b0 = flash_attention.launches, flash_bwd.launches
        out, _ = model(lat.to(dev).bfloat16(), tt.to(dev), text.to(dev).bfloat16())
        (out.float() ** 2).mean().backward()
        torch.cuda.synchronize()
        assert flash_attention.launches - n0 == (4 if remat else 2) * cfg.num_layers
        assert flash_bwd.launches - b0 == 2 * cfg.num_layers
        assert len(model.intermediates["attn_entropy"]) == cfg.num_layers
        grads[remat] = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        for n, r in ref.items():
            assert _rel_l2(grads[remat][n].reshape(1, 1, 1, -1), r.reshape(1, 1, 1, -1))[0] < 5e-2, n
    for n, a in grads[True].items():
        b = grads[False][n]
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-6)).item() < 2e-2, n
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            model(lat.to(dev).bfloat16(), tt.to(dev), text.to(dev).bfloat16())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# Attention dropout (B1's and B7's DROPOUT instantiations, head dims 64 and
# 128, with and without the key range). (b, h, hk, sq, sk, d), causal,
# kv_bound, kv_low, bound_causal, p.
DROPOUT_CASES = [
    ((2, 4, 2, 300, 555, 64), False, None, None, False, 0.1),
    ((2, 4, 4, 257, 257, 64), True, None, None, False, 0.5),
    ((1, 8, 2, 1000, 640, 128), True, None, None, False, 0.1),
    ((2, 4, 1, 200, 200, 128), False, None, None, False, 0.9),
    ((3, 4, 2, 140, 500, 64), False, [500, 300, 270], [5, 128, 140], True, 0.25),
    ((2, 8, 2, 4, 1059, 128), False, [1059, 700], [0, 3], True, 0.1),
]


@pytest.mark.parametrize("shape,causal,bound,low,bound_causal,p", DROPOUT_CASES)
def test_flash_dropout_kernels(dev, shape, causal, bound, low, bound_causal, p):
    b, h, hk, sq, sk, d = shape
    q, k, v = _qkv(dev, b, h, hk, sq, sk, d, seed=sq + 3 * sk)
    do = _qkv(dev, b, h, hk, sq, sk, d, seed=sq + 1)[0]
    kw = _bwd_channels(dev, b, h, bound, low, bound_causal, None)
    seed = torch.tensor([-98765], dtype=torch.int32, device=dev)
    kw.update(dropout_p=p, dropout_seed=seed)
    n_fwd, n_bwd = flash_attention.dropout_launches, flash_bwd.dropout_launches
    out, lse = flash_attention_masked(q, k, v, causal=causal, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.dropout_launches == n_fwd + 1
    ro, rl = flash_attention_plain(q, k, v, causal=causal, **kw)
    assert (out.float() - ro.float()).abs().max().item() < 2e-2 * max(1.0, 1.0 / (1.0 - p))
    fin = torch.isfinite(rl)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (lse[fin] - rl[fin]).abs().max().item() < 1e-3
    # lse is dropout-free: B1 without dropout gives the same values.
    kw0 = {n: x for n, x in kw.items() if not n.startswith("dropout")}
    _, lse0 = flash_attention_masked(q, k, v, causal=causal, return_lse=True, **kw0)
    assert torch.equal(lse, lse0)
    # Two launches give the same bits.
    assert torch.equal(out, flash_attention_masked(q, k, v, causal=causal, **kw))
    out = out.to(torch.bfloat16)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, d**-0.5, causal, **kw)
    torch.cuda.synchronize()
    assert flash_bwd.dropout_launches == n_bwd + 1
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta, d**-0.5, causal)
    rq = flash_bwd_dq_plain(*args, **kw)
    rk, rv = flash_bwd_dkv_plain(*args, **kw)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _check_grad(got, ref)
    dq2, dk2, dv2 = flash_attention_bwd(q, k, v, out, lse, do, d**-0.5, causal, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _check_grad(dq2, rq)


@pytest.mark.parametrize("d,c0,p", [(64, 0, 0.1), (64, 960, 0.5), (128, 128, 0.1),
                                    (128, 960, 0.5)])
def test_flash_dropout_reads_back_the_keep_mask(dev, d, c0, p):
    # q = k = 0: P is uniform over the 64 visible keys [c0, c0 + 64); V
    # one-hot over them, so out[i, j] = keep[i, c0 + j] / (1 - p) / 64.
    from liteattention_torch.ops.flash_fwd import dropout_keep_mask

    b, h, sq, sk = 2, 3, 1100, 1024
    q = torch.zeros(b, h, sq, d, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(b, h, sk, d, dtype=torch.bfloat16, device=dev)
    v = torch.zeros_like(k)
    v[:, :, c0 : c0 + 64, :64] = torch.eye(64, dtype=torch.bfloat16, device=dev)
    seed = 13579
    out = flash_attention_masked(
        q, k, v, kv_low=torch.full((b,), c0, dtype=torch.int32, device=dev),
        kv_bound=torch.full((b,), c0 + 64, dtype=torch.int32, device=dev),
        dropout_p=p, dropout_seed=seed)
    for bi in range(b):
        for hi in range(h):
            keep = dropout_keep_mask(seed, bi * h + hi, 0, c0, (sq, 64), p, device=dev)
            want = keep.float() * (1.0 / (1.0 - p)) / 64  # the kernel's fp32 1 / (1 - p)
            assert torch.equal(out[bi, hi, :, :64].float(), want.bfloat16().float())


def test_flash_dropout_raises_where_not_built(dev):
    q, k, v = _qkv(dev, 1, 4, 2, 64, 64, 80)
    with pytest.raises(NotImplementedError, match="head dim 80.*B-iii 4"):
        flash_attention(q, k, v, dropout_p=0.1)
    q, k, v = _qkv(dev, 1, 4, 2, 64, 64, 64)
    with pytest.raises(NotImplementedError, match="alibi_slopes with dropout.*B-i 5"):
        flash_attention_masked(q, k, v, alibi_slopes=torch.ones(4, device=dev), dropout_p=0.1)
    seg = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="segments.*B-i 5"):
        flash_attention_masked(q[:1], k[:1], v[:1], q_segments=seg, kv_segments=seg,
                               dropout_p=0.1)
