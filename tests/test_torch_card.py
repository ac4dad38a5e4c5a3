"""Tests of the port that need an NVIDIA card; they skip elsewhere.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch, without the suite's JAX ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Tolerances. On integer-valued operands the kernel equals its plain version
bit for bit: every product and partial sum is an integer below 2**24, exact
in float32 in any order, and both sides round the same value once. On
uniform operands bf16/fp16 stay within ``k1.plain_gap_bound`` (the two
float32 summation orders plus one output rounding), f32 within atol
1e-5 * k (a tenth of the repo's f32 validation contract).
"""

import numpy as np
import pytest
import torch

from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.registry import load_impl_class
from torch_parity import to_numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _uniform(shape, dtype, gen, device):
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,n,k,dtype",
    [
        (1024, 1024, 1024, torch.bfloat16),
        (1000, 776, 520, torch.bfloat16),
        (7, 9, 33, torch.bfloat16),
        (513, 257, 129, torch.float16),
        (300, 200, 100, torch.float32),
        (129, 131, 7, torch.float32),
    ],
)
def test_kernel_matches_plain(cuda_device, m, n, k, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = _uniform((m, k), dtype, gen, cuda_device)
    b = _uniform((k, n), dtype, gen, cuda_device)
    before = k1.LAUNCHES
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    want = k1.matmul_plain(a, b)
    assert got.shape == (m, n) and got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(
            to_numpy(got), to_numpy(want), rtol=0, atol=1e-5 * k
        )
    else:
        gap = (got.float() - want.float()).abs()
        bound = k1.plain_gap_bound(a, b, got, want)
        assert bool((gap <= bound).all()), float((gap - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("m,n,k", [(1000, 776, 520), (256, 384, 2048), (7, 9, 33)])
def test_kernel_exact_on_integer_operands(cuda_device, m, n, k, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randint(-4, 5, (m, k), generator=gen, device=cuda_device).to(dtype)
    b = torch.randint(-4, 5, (k, n), generator=gen, device=cuda_device).to(dtype)
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.matmul_plain(a, b))


@pytest.mark.cuda
def test_kernel_rejects_strided_operands(cuda_device):
    a = torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k1.matmul(a.t(), a)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
def test_cuda_member_runs_k1_and_validates(cuda_device, family):
    impl = load_impl_class(family, "cuda")(1024, 512, 768, dtype="bfloat16")
    assert impl.device.type == "cuda"
    before = k1.LAUNCHES
    result = impl.run()
    assert k1.LAUNCHES == before + 1
    assert impl.validate(result)


# -- flash attention (K8a, K8b, K9) --------------------------------------------
#
# Exact on band inputs: with q = 0 every live score is 0, so p = 1 exactly on
# the live band and 0 off it, acc sums integer-valued v exactly in float32,
# l counts the live keys, and both sides divide once and round once: o, acc,
# m and l are bit for bit equal, and a wrong band (a missed or extra tile or
# key) shows as a different count or sum. On uniform [-1, 1] inputs the
# output stays within ``fa.plain_gap_bound`` (p rounded for the tensor
# cores, two summation orders, the score gap, one output rounding); so it
# does on peaked inputs, whose softmax puts nearly all weight on one key a
# row, so that |o| stays near max|v| and a wrong score shows.

from ddlb_tpu_torch.ops import flash_attention as fa  # noqa: E402

#: (sq, skv, h, h_kv, dh, row_offset, causal, window)
FLASH_CASES = [
    (256, 256, 4, 4, 128, 0, True, 0),       # triangle (K8a)
    (200, 200, 2, 2, 128, 0, True, 0),       # ragged triangle
    (128, 512, 4, 2, 128, 384, True, 100),   # offset, window, GQA (K8b)
    (320, 320, 4, 2, 128, 0, True, 100),     # window at offset 0, GQA (K8b)
    (130, 70, 2, 1, 128, 0, False, 0),       # not causal, ragged
    (64, 64, 2, 2, 128, 100, True, 60),      # rows with an empty band
    (16, 16, 16, 4, 128, 0, True, 0),        # a serve bucket below one tile, GQA
]
FLASH_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _band_qkv(sq, skv, h, h_kv, dh, dtype, gen, device):
    q = torch.zeros((sq, h, dh), dtype=dtype, device=device)
    k = torch.randint(-4, 5, (skv, h_kv, dh), generator=gen, device=device)
    v = torch.randint(-4, 5, (skv, h_kv, dh), generator=gen, device=device)
    return q, k.to(dtype), v.to(dtype)


def _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, device):
    return (
        _uniform((sq, h, dh), dtype, gen, device),
        _uniform((skv, h_kv, dh), dtype, gen, device),
        _uniform((skv, h_kv, dh), dtype, gen, device),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_exact_on_band_inputs(cuda_device, case, dtype):
    sq, skv, h, h_kv, dh, off, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = _band_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
    kw = dict(scale=dh**-0.5, row_offset=off, causal=causal, window=window)
    case_name, _ = fa.forward_case(sq, skv, off, causal, window)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[case_name] == before[case_name] + 1
    o_plain, lse_plain = fa.flash_forward_plain(q, k, v, **kw)
    assert torch.equal(o, o_plain)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-6, atol=0)


def _peaked_qkv(sq, skv, h, h_kv, dh, dtype, gen, device, shift):
    """Uniform k, v and q = 4 * k at key ``(i + shift) % skv`` of its kv
    head: that key scores about 15, the others about 0 ± 1.3, so each row's
    softmax peaks on one key and ``|o|`` stays near ``max|v|`` however long
    the band (4 * k is exact in every operand type)."""
    _, k, v = _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, device)
    rows = (torch.arange(sq, device=device) + shift) % skv
    q = (4 * k[rows]).repeat_interleave(h // h_kv, dim=1)
    return q, k, v


def _assert_forward_within_bound(q, k, v, kw):
    skv, dh = k.shape[0], k.shape[2]
    o, lse = fa.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    o_plain, lse_plain = fa.flash_forward_plain(q, k, v, **kw)
    gap = (o.float() - o_plain.float()).abs()
    bound = fa.plain_gap_bound(q, k, v, o, o_plain, scale=dh**-0.5, n_terms=skv)
    assert bool((gap <= bound).all()), float((gap - bound).max())
    ds = fa.score_gap(q, k, dh**-0.5)
    empty = lse_plain == fa.NEG_INF
    assert torch.equal(lse == fa.NEG_INF, empty)
    lse_gap = (lse - lse_plain).abs()[~empty]
    assert bool((lse_gap <= 4 * ds + 2 * skv * 2.0**-23 + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_within_bound(cuda_device, case, dtype):
    sq, skv, h, h_kv, dh, off, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
    kw = dict(scale=dh**-0.5, row_offset=off, causal=causal, window=window)
    _assert_forward_within_bound(q, k, v, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_within_bound_on_peaked_inputs(cuda_device, case, dtype):
    """QKᵀ, the scale and exp, held where ``|o|`` is near ``max|v|`` on
    every row whose peak key is live (the query's own position)."""
    sq, skv, h, h_kv, dh, off, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = _peaked_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device, off)
    kw = dict(scale=dh**-0.5, row_offset=off, causal=causal, window=window)
    _assert_forward_within_bound(q, k, v, kw)


#: (sq, skv, h, h_kv, dh, row_offset, col_offset, mode, window)
CHUNK_CASES = [
    (256, 256, 4, 4, 128, 512, 512, "diagonal", 0),
    (256, 256, 4, 4, 128, 512, 256, "past", 0),
    (128, 192, 4, 2, 128, 300, 200, "offset", 90),
    (100, 60, 2, 2, 128, 40, 70, "offset", 0),  # ragged, partly in the future
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_flash_chunk_exact_on_band_inputs(cuda_device, case, dtype):
    sq, skv, h, h_kv, dh, row_off, col_off, mode, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = _band_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
    kw = dict(scale=dh**-0.5, row_offset=row_off, col_offset=col_off,
              causal=mode, window=window)
    start = fa.init_flash_carry(sq, h, dh, cuda_device)
    # fold twice: the second fold reads the carry the first one wrote
    want = fa.flash_chunk_plain(q, k, v, start, **kw)
    want = fa.flash_chunk_plain(q, k, v, want, **kw)
    carry = tuple(t.clone() for t in start)
    before = fa.LAUNCHES["chunk"]
    got = fa.flash_attention_chunk(q, k, v, carry, **kw)
    got = fa.flash_attention_chunk(q, k, v, got, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["chunk"] == before + 2
    assert all(g is c for g, c in zip(got, carry))  # updated in place
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_chunk_chain_matches_full_attention(cuda_device, dtype):
    """Rank 3 of a 4-chunk ring: the diagonal chunk, then three past ones,
    finished by finalize_flash_carry, against the plain forward over the
    whole sequence at offset 3 * s."""
    s, h, dh = 192, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = _uniform_qkv(4 * s, 4 * s, h, h, dh, dtype, gen, cuda_device)
    q = q[3 * s:].contiguous()
    carry = fa.init_flash_carry(s, h, dh, cuda_device)
    for src in (3, 2, 1, 0):
        carry = fa.flash_attention_chunk(
            q, k[src * s:(src + 1) * s].contiguous(),
            v[src * s:(src + 1) * s].contiguous(), carry, scale=dh**-0.5,
            row_offset=3 * s, col_offset=src * s,
            causal="diagonal" if src == 3 else "past",
        )
    got = fa.finalize_flash_carry(carry, torch.float32)
    want = fa.flash_forward_plain(
        q, k, v, scale=dh**-0.5, row_offset=3 * s
    )[0].float()
    bound = fa.plain_gap_bound(q, k, v, got, want, scale=dh**-0.5, n_terms=4 * s)
    # the plain forward rounds its output to the operand dtype: one more
    # spacing of that dtype
    bound = bound + want.abs() * torch.finfo(dtype).eps
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
def test_flash_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((64, 2, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q.transpose(0, 1), q.transpose(0, 1),
                         q.transpose(0, 1), scale=1.0)
    for dh in (64, 96):
        odd = torch.zeros((64, 2, dh), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_forward(odd, odd, odd, scale=1.0)


# -- decode attention (K11, K12) -------------------------------------------------
#
# Held against their plain versions within ``da.plain_gap_bound``: both sides
# compute in float32 from the same dequantized operands, in other orders
# (the score gap, two summation orders of at most S keys, exp, one output
# rounding, all times max|v|). Uniform [-1, 1] inputs, and peaked ones
# whose query is 4x the key at the sequence's own position, so |o| stays
# near max|v| and a wrong score, scale, mask or page shows.

from ddlb_tpu_torch.ops import decode_attention as da  # noqa: E402

#: (b, S, h, h_kv, window, int8)
DECODE_CASES = [
    (4, 1000, 4, 4, 0, False),      # MHA, ragged positions
    (3, 777, 8, 2, 0, False),       # GQA 4
    (4, 1000, 16, 1, 0, False),     # MQA, G = 16
    (4, 1000, 8, 4, 100, False),    # window
    (4, 1000, 4, 4, 0, True),       # int8
    (2, 513, 8, 1, 50, True),       # int8, G = 8, window
]


def _quantize(x):
    s = (x.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-30)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _decode_inputs(b, S, h, h_kv, dh, dtype, int8, gen, device, peaked, pos):
    k = _uniform((b, S, h_kv, dh), torch.float32, gen, device)
    v = _uniform((b, S, h_kv, dh), torch.float32, gen, device)
    if int8:
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        k_deq, v_deq = (k.float() * ks).to(dtype), (v.float() * vs).to(dtype)
    else:
        k, v = k.to(dtype), v.to(dtype)
        ks = vs = None
        k_deq, v_deq = k, v
    if peaked:
        rows = k_deq[torch.arange(b, device=device), pos.clamp(max=S - 1).long()]
        q = (4 * rows.float()).repeat_interleave(h // h_kv, dim=1).to(dtype)
    else:
        q = _uniform((b, h, dh), dtype, gen, device)
    return q, k, v, ks, vs, float(k_deq.float().abs().max()), float(v_deq.float().abs().max())


def _positions(b, S, gen, device):
    pos = torch.randint(0, S, (b,), generator=gen, device=device).to(torch.int32)
    pos[0] = 0
    if b > 1:
        pos[-1] = S  # a parked lane: every key live
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_within_bound(cuda_device, case, dtype, peaked):
    b, S, h, h_kv, window, int8 = case
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    pos = _positions(b, S, gen, cuda_device)
    q, k, v, ks, vs, kmax, vmax = _decode_inputs(
        b, S, h, h_kv, 128, dtype, int8, gen, cuda_device, peaked, pos)
    before = da.LAUNCHES["decode"]
    got = da.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, window=window)
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode"] == before + 1
    want = da.decode_attention_plain(q, k, v, pos, k_scale=ks, v_scale=vs, window=window)
    assert got.shape == (b, h, 128) and got.dtype == dtype
    bound = da.plain_gap_bound(q, kmax, vmax, got, want, n_terms=S)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= bound).all()), float((gap - bound).max())


def _paged(k, v, ks, vs, pos, ps, gen, device, extra_pages=3):
    """A contiguous cache scattered into shuffled pool pages; entries past
    each sequence's page of ``pos`` stay the sentinel; sequence 1 shares
    sequence 0's first page (two slots on one page)."""
    b, S = k.shape[:2]
    mp = S // ps
    P = b * mp + extra_pages
    perm = torch.randperm(b * mp, generator=gen, device=device)
    table = torch.full((b, mp), P, dtype=torch.int32, device=device)
    pools = [torch.zeros((P, ps) + tuple(x.shape[2:]), dtype=x.dtype, device=device)
             if x is not None else None for x in (k, v, ks, vs)]
    for i in range(b):
        for j in range(mp):
            if j > int(pos[i]) // ps:
                continue
            page = int(perm[i * mp + j])
            table[i, j] = page
            for pool, x in zip(pools, (k, v, ks, vs)):
                if pool is not None:
                    pool[page] = x[i, j * ps:(j + 1) * ps]
    if b > 1:
        table[1, 0] = table[0, 0]
    return pools, table


@pytest.mark.cuda
@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_decode_kernel_within_bound(cuda_device, case, dtype, peaked):
    b, S, h, h_kv, window, int8 = case
    ps = 64
    S = S // ps * ps
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    pos = _positions(b, S, gen, cuda_device)
    q, k, v, ks, vs, kmax, vmax = _decode_inputs(
        b, S, h, h_kv, 128, dtype, int8, gen, cuda_device, peaked, pos)
    (kp, vp, ksp, vsp), table = _paged(k, v, ks, vs, pos, ps, gen, cuda_device)
    if b > 2:
        table[2] = kp.shape[0]  # an all-sentinel row gives zeros
    before = da.LAUNCHES["paged"]
    got = da.paged_decode_attention(q, kp, vp, table, pos, k_scale=ksp,
                                    v_scale=vsp, window=window)
    torch.cuda.synchronize()
    assert da.LAUNCHES["paged"] == before + 1
    want = da.paged_decode_attention_plain(q, kp, vp, table, pos, k_scale=ksp,
                                           v_scale=vsp, window=window)
    bound = da.plain_gap_bound(q, kmax, vmax, got, want, n_terms=S)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= bound).all()), float((gap - bound).max())
    if b > 2:
        assert bool((got[2] == 0).all())


@pytest.mark.cuda
def test_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, 3)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                            k[..., :64].contiguous(), 3)
    q6 = torch.zeros((2, 6, 128), dtype=torch.bfloat16, device=cuda_device)
    k2 = torch.zeros((2, 64, 2, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="query heads per kv head"):
        da.decode_attention(q6, k2, k2, 3)


# -- the int8 GEMM (K7) ----------------------------------------------------------
#
# Bit for bit: K7 and its plain version both sum the int8 products exactly
# (int32 in the kernel, float64 in the plain version) and apply the same
# epilogue, (float)acc * sa * sb rounded once to the output dtype.

from ddlb_tpu_torch.ops import quantized_matmul as qm  # noqa: E402

#: (m, n, k): ragged edges (one row, odd widths, k not a multiple of 16 or
#: of the 64-byte k step), the decode MLP's two products and a square tile
INT8_SHAPES = [
    (1, 200, 64), (127, 200, 2048), (37, 77, 40), (129, 131, 7), (3, 16, 0),
    (8, 8192, 2048), (8, 2048, 8192), (1024, 1024, 1024),
]
INT8_OUT = [torch.bfloat16, torch.float16, torch.float32]


def _int8_operands(m, n, k, gen, device):
    aq = torch.randint(-127, 128, (m, k), generator=gen, device=device).to(torch.int8)
    bq = torch.randint(-127, 128, (k, n), generator=gen, device=device).to(torch.int8)
    sa = torch.rand((m, 1), generator=gen, device=device) * 2e-2 + 1e-4
    sb = torch.rand((1, n), generator=gen, device=device) * 2e-2 + 1e-4
    return aq, bq, sa, sb


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", INT8_OUT)
@pytest.mark.parametrize("m,n,k", INT8_SHAPES)
def test_int8_kernel_bit_equal_to_plain(cuda_device, m, n, k, out_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    ops = _int8_operands(m, n, k, gen, cuda_device)
    before = qm.LAUNCHES
    got = qm.int8_matmul_kernel(*ops, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qm.LAUNCHES == before + 1
    want = qm.int8_matmul_plain(*ops, out_dtype=out_dtype)
    assert got.shape == (m, n) and got.dtype == out_dtype
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    aq, bq, sa, sb = _int8_operands(64, 64, 64, gen, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul_kernel(aq.t(), bq, sa, sb)
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul_kernel(aq, bq.t().contiguous().t(), sa, sb)
    with pytest.raises(ValueError, match="int8 operands"):
        qm.int8_matmul_kernel(aq.float(), bq, sa, sb)
    with pytest.raises(ValueError, match="float32"):
        qm.int8_matmul_kernel(aq, bq, sa.half(), sb)
    with pytest.raises(ValueError, match="operands on"):
        qm.int8_matmul_kernel(aq, bq.cpu(), sa, sb)
    with pytest.raises(ValueError, match="overflow"):
        big = torch.zeros((1, qm.MAX_K + 1), dtype=torch.int8, device=cuda_device)
        qm.int8_matmul_kernel(big, big.t().contiguous(), sa[:1], sb[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "family", ["tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall"]
)
def test_quantized_member_runs_k7_and_validates(cuda_device, family):
    impl = load_impl_class(family, "quantized")(
        1024, 512, 768, dtype="bfloat16", kernel="pallas", quantize="dynamic"
    )
    assert impl.device.type == "cuda"
    before = qm.LAUNCHES
    result = impl.run()
    assert qm.LAUNCHES == before + 1
    assert impl.validate(result)


# -- the flash backward (K10a-K10d) --------------------------------------------
#
# The kernels against flash_backward_plain on the card, on uniform and on
# peaked inputs, within fa.backward_gap_bound: the score gap, the order of
# the dP products and of the float32 sums, and the rounding of P and dS to
# the operand type before the tensor-core products, each scaled by the
# magnitudes the plain tile loop sums (|dS||K|, |dS||Q|, P|dO|).

#: (sq, skv, h, h_kv, row_offset, col_offset, mode, window)
BACKWARD_CASES = [
    (256, 256, 4, 4, 0, 0, "offset", 0),        # triangle (K10a/K10b)
    (200, 200, 2, 2, 0, 0, "offset", 0),        # ragged triangle
    (192, 192, 2, 2, 192, 192, "diagonal", 0),  # a diagonal ring chunk: triangle
    (128, 512, 4, 2, 384, 0, "offset", 100),    # offset, window, GQA (K10c/K10d)
    (320, 320, 4, 2, 0, 0, "offset", 100),      # window at offset 0, GQA
    (100, 300, 2, 2, 150, 20, "offset", 0),     # ragged, both offsets
    (128, 128, 8, 2, 256, 128, "past", 0),      # a past ring chunk, GQA 4
    (130, 70, 2, 1, 0, 0, "none", 0),           # bidirectional, ragged
    (64, 64, 2, 2, 100, 0, "offset", 60),       # rows with an empty band
]


def _backward_forward(q, k, v, row_offset, col_offset, mode, window):
    """o and the lse of the softmax over this span, as the forward gives
    them to the backward."""
    if mode in ("past", "none"):
        return fa.flash_forward_plain(q, k, v, scale=q.shape[2] ** -0.5, causal=False)
    rel = 0 if mode == "diagonal" else row_offset - col_offset
    return fa.flash_forward_plain(q, k, v, scale=q.shape[2] ** -0.5, row_offset=rel,
                                  window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_flash_backward_within_bound(cuda_device, case, dtype, peaked):
    sq, skv, h, h_kv, ro, co, mode, window = case
    dh = 128
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    if peaked:
        q, k, v = _peaked_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device, ro - co)
    else:
        q, k, v = _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
    do = _uniform((sq, h, dh), dtype, gen, cuda_device)
    o, lse = _backward_forward(q, k, v, ro, co, mode, window)
    kw = dict(scale=dh**-0.5, row_offset=ro, col_offset=co, causal=mode, window=window)
    case_name, _, _ = fa.backward_case(sq, skv, ro, co, mode, window)
    before = dict(fa.LAUNCHES)
    got = fa.flash_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for pass_ in ("dq", "dkv"):
        key = f"bwd_{pass_}_{case_name}"
        assert fa.LAUNCHES[key] == before[key] + 1
    want = fa.flash_backward_plain(q, k, v, o, lse, do, **kw)
    bounds = fa.backward_gap_bound(q, k, v, o, lse, do, want, **kw)
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        gap = (g - w).abs()
        assert bool(torch.isfinite(g).all()), name
        assert bool((gap <= b).all()), (name, float((gap - b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_attention_gradient_through_the_kernels(cuda_device, dtype):
    """autograd through ``flash_attention`` (K8a forward, K10a/K10b
    backward) against autograd of the plain float32 einsum attention on
    the same (rounded) operands: in half precision within 2e-2 relative
    plus 3e-2 (the kernels round P and dS to the operand type and the
    gradients come back in it; they are of order 1), in float32 within
    1e-4."""
    sq, h, dh = 192, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = _uniform_qkv(sq, sq, h, h, dh, dtype, gen, cuda_device)
    w = _uniform((sq, h, dh), torch.float32, gen, cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, scale=dh**-0.5)
    grads = torch.autograd.grad((out.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["bwd_dq_tri"] == before["bwd_dq_tri"] + 1
    assert fa.LAUNCHES["bwd_dkv_tri"] == before["bwd_dkv_tri"] + 1
    ref = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    s = torch.einsum("qhd,khd->hqk", ref[0], ref[1]) * dh**-0.5
    mask = torch.ones((sq, sq), dtype=torch.bool, device=cuda_device).tril()
    p = torch.softmax(s.masked_fill(~mask, fa.NEG_INF), -1)
    o_ref = torch.einsum("hqk,khd->qhd", p, ref[2])
    want = torch.autograd.grad((o_ref * w).sum(), ref)
    half = dtype != torch.float32
    for g, r in zip(grads, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r, rtol=2e-2 if half else 0,
                                   atol=3e-2 if half else 1e-4)
