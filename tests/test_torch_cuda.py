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
"""

import pytest
import torch

from liteattention_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_bwd,
    flash_bwd_dkv_plain,
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


# The backward also at GQA group 4, D 128, Sq > Sk (causal rows with no
# key), and at grids smaller than one wave (2 CTAs; 1 CTA with group 2).
BWD_SHAPES = SHAPES + [
    (1, 8, 2, 700, 300, 128),
    (1, 1, 1, 256, 256, 64),
    (1, 2, 1, 100, 128, 128),
]


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


def _stable_votes(plain, thr):
    """Tiles whose plain vote is the same at thr -/+ 1e-3: outside the
    margin where fp32 summation order can flip a vote."""
    return plain(thr - 1e-3)[2] == plain(thr + 1e-3)[2]


# (bq, bk, super-tile): coarse votes AND-ed over 2 CTAs (bq 256), coarse
# steps of 2 fine tiles (bk 256), super-tile bitmaps; Sq 700 / Sk 900
# leave ragged tails and a coarse tile hanging past the keys.
@pytest.mark.parametrize("bq,bk,fine", [
    (256, 256, False), (128, 256, False), (256, 128, False), (256, 256, True), (128, 384, True),
])
def test_lite_coarse_kernel(dev, bq, bk, fine):
    from liteattention_torch.ops.lite_flash_fwd import lite_flash_attention_coarse_plain
    from liteattention_torch.ops.mask import compact_mask, compact_mask_fine

    q, k, v = _qkv(dev, 1, 4, 2, 700, 900, 128, seed=bq + bk)
    g = torch.Generator(device=dev).manual_seed(bk)
    qs, ks = bq // 128, bk // 128
    if fine:
        m = torch.rand(1, 4, 6, 8, generator=g, device=dev) < 0.45
        m[0, 1, 2] = False  # a fine row with nothing live
        idx, count, bits = compact_mask_fine(m, qs, ks)
    else:
        m = torch.rand(1, 4, -(-700 // bq), -(-900 // bk), generator=g, device=dev) < 0.6
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


# (form, sq, hq, pages per request): the DeepSeek decode shape in every cache
# form, the causal 2-token verify. 24 pages of 64 (1536 keys) take the split
# path and its merge (3 splits at 5 requests), 12 pages (768 keys) one split.
MLA_DECODE_CASES = [
    ("contiguous", 1, 128, 24), ("paged", 1, 128, 24), ("permuted", 1, 128, 24),
    ("wide", 1, 128, 24), ("contiguous", 2, 32, 24), ("paged", 1, 128, 12),
    ("permuted", 2, 16, 12),
]


@pytest.mark.parametrize("form,sq,hq,pps", MLA_DECODE_CASES)
def test_mla_decode_kernel(dev, form, sq, hq, pps):
    """B10 against its plain version: out within 2e-2 absolute and 1e-2
    rel-L2, lse within 1e-3; a request of length 0 gives out 0 and lse
    -inf; a 640-lane cache reads only its first 576 channels."""
    from liteattention_torch.ops.mla import mla_decode, mla_decode_plain

    b, d, dv, ps = 5, 576, 512, 64
    g = torch.Generator(device=dev).manual_seed(sq * hq + pps)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).bfloat16()
    lanes = 640 if form == "wide" else d
    n_pages = b * pps + 2
    pool = torch.randn(n_pages, ps, lanes, generator=g, device=dev).bfloat16()
    lens = torch.randint(1, pps * ps + 1, (b,), generator=g, device=dev).int()
    lens[0], lens[1] = pps * ps, 0
    table = None
    if form in ("paged", "permuted"):
        perm = torch.randperm(n_pages, generator=g, device=dev) if form == "permuted" \
            else torch.arange(n_pages, device=dev)
        table = perm[: b * pps].reshape(b, pps).int()
        cache = pool
    else:
        cache = pool[: b * pps].reshape(b, pps * ps, lanes)
    n0, m0 = mla_decode.launches, mla_decode.merge_launches
    out, lse = mla_decode(q, cache, lens, dv, page_table=table, return_lse=True)
    torch.cuda.synchronize()
    assert mla_decode.launches == n0 + 1
    assert mla_decode.merge_launches == m0 + int(pps * ps >= 1024)
    ro, rl = mla_decode_plain(q, cache, lens, dv, page_table=table, return_lse=True)
    assert out.shape == (b, sq, hq, dv) and lse.shape == (b, hq, sq)
    _check_decode(out.transpose(1, 2), lse, ro.transpose(1, 2), rl)
    assert (out[1] == 0).all() and torch.isneginf(lse[1]).all()
    if form == "wide":
        tight = mla_decode(q, cache[..., :d].contiguous(), lens, dv, return_lse=True)
        assert torch.equal(tight[0], out) and torch.equal(tight[1], lse)


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
# absorbed widths, the qv term; ragged tiles and Sq > Sk.
MLA_FWD_CASES = [
    (2, 4, 2, 300, 555, 192, 128, False),
    (1, 2, 2, 1000, 640, 192, 128, False),
    (1, 3, 3, 200, 333, 576, 512, False),
    (2, 2, 1, 130, 97, 64, 512, True),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hk,sq,sk,d,dv,use_qv", MLA_FWD_CASES)
def test_flash_fwd_mla_kernel(dev, b, h, hk, sq, sk, d, dv, use_qv, causal):
    """B1's MLA instantiation against the plain version, with B1's own
    tolerances (out 2e-2, over max(1, |plain|) when causal; lse 1e-3)."""
    from liteattention_torch.ops.flash_fwd import flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(d + dv + sq)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()  # noqa: E731
    q, k, v = mk(b, h, sq, d), mk(b, hk, sk, d), mk(b, hk, sk, dv)
    qv = mk(b, h, sq, dv) if use_qv else None
    n0 = flash_attention.mla_launches
    out, lse = flash_attention(q, k, v, causal=causal, qv=qv, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.mla_launches == n0 + 1
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
