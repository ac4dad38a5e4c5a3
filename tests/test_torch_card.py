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
    before, tiles = k1.LAUNCHES, dict(k1.TILES)
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    tile = k1.tile_for(dtype, k, n)
    assert k1.TILES == dict(tiles, **{tile: tiles[tile] + 1})
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


#: K1's Hopper tile at ragged widths: m not a multiple of 128, n not of
#: 256, k not of 64 (rows still 16-byte multiples), and m past the rows a
#: 2-D grid of 128-row tiles could cover (the old wmma kernel's limit)
WGMMA_CASES = [
    (300, 264, 72, torch.bfloat16),
    (129, 520, 200, torch.float16),
    (1000, 776, 520, torch.float16),
    (64, 8, 8, torch.bfloat16),
    (k1._MAX_ROWS + 1000, 8, 8, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,dtype", WGMMA_CASES)
def test_wgmma_tile_matches_plain(cuda_device, m, n, k, dtype):
    """Integer operands bit for bit, uniform ones within plain_gap_bound,
    each call one launch of the wgmma tile."""
    assert k1.tile_for(dtype, k, n) == "wgmma"
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for integer in (True, False):
        if integer:
            a = torch.randint(-4, 5, (m, k), generator=gen, device=cuda_device).to(dtype)
            b = torch.randint(-4, 5, (k, n), generator=gen, device=cuda_device).to(dtype)
        else:
            a, b = _uniform((m, k), dtype, gen, cuda_device), _uniform((k, n), dtype, gen, cuda_device)
        tiles = dict(k1.TILES)
        got = k1.matmul(a, b)
        torch.cuda.synchronize()
        assert k1.TILES == dict(tiles, wgmma=tiles["wgmma"] + 1)
        want = k1.matmul_plain(a, b)
        if integer:
            assert torch.equal(got, want)
        else:
            gap = (got.float() - want.float()).abs()
            assert bool((gap <= k1.plain_gap_bound(a, b, got, want)).all())


@pytest.mark.cuda
def test_misaligned_base_takes_the_wmma_tile(cuda_device):
    """A base that is not 16-byte aligned cannot be a TMA map: the wmma
    tile takes it, and the result still matches the plain version."""
    store = torch.randint(-4, 5, (64 * 64 + 1,), device=cuda_device).to(torch.bfloat16)
    a = store[1:].view(64, 64)
    assert k1.tile_for(a.dtype, 64, 64, a.data_ptr()) == "wmma"
    tiles = dict(k1.TILES)
    got = k1.matmul(a, a)
    torch.cuda.synchronize()
    assert k1.TILES == dict(tiles, wmma=tiles["wmma"] + 1)
    assert torch.equal(got, k1.matmul_plain(a, a))


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
    # the band kernel's edges (K8b in bf16/fp16)
    (512, 256, 4, 2, 128, 0, True, 100),     # query tile 3 reaches no key
    (129, 1000, 8, 2, 128, 723, True, 300),  # offset off the tile grid, ragged
    (127, 129, 4, 4, 128, 0, False, 0),      # not causal, ragged both ways
    (1000, 1000, 8, 2, 128, 0, True, 300),   # window at offset 0, ragged
    (300, 1000, 4, 2, 128, 700, True, 0),    # causal edge across two key tiles
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
    kernel = fa.forward_kernel(case_name, dtype)
    before, tiles = dict(fa.LAUNCHES), dict(fa.FORWARD_TILES)
    o, lse = fa.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[case_name] == before[case_name] + 1
    assert fa.FORWARD_TILES == dict(tiles, **{kernel: tiles[kernel] + 1})
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
    # the band kernel's edges (K9 in bf16/fp16)
    (512, 768, 4, 2, 128, 1000, 0, "offset", 600),       # query tile 3 reaches no key
    (1000, 1000, 8, 2, 128, 5000, 5000, "diagonal", 300),  # diagonal with a window
    (127, 129, 4, 2, 128, 900, 500, "offset", 0),        # offsets off the tile grid
    (129, 127, 8, 2, 128, 0, 0, "past", 0),              # past, ragged, GQA 4
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
    before, tiles = fa.LAUNCHES["chunk"], dict(fa.FORWARD_TILES)
    got = fa.flash_attention_chunk(q, k, v, carry, **kw)
    got = fa.flash_attention_chunk(q, k, v, got, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["chunk"] == before + 2
    kernel = fa.forward_kernel("chunk", dtype)
    assert kernel == ("simt" if dtype == torch.float32 else "band")
    assert fa.FORWARD_TILES == dict(tiles, **{kernel: tiles[kernel] + 2})
    assert all(g is c for g, c in zip(got, carry))  # updated in place
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_flash_chunk_within_bound(cuda_device, case, dtype, peaked):
    """One fold into a fresh carry on uniform (or peaked: q at the key of
    its own position) inputs: the normalised output within
    ``plain_gap_bound``, m within the score gap and l within a relative
    ``4 Δs + 2 skv 2**-23 + 2**-20`` (two summation orders and exp), rows
    with nothing live exactly as the plain version leaves them."""
    sq, skv, h, h_kv, dh, row_off, col_off, mode, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    if peaked:
        shift = row_off - col_off if mode == "offset" else 0
        q, k, v = _peaked_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device, shift)
    else:
        q, k, v = _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
    scale = dh**-0.5
    kw = dict(scale=scale, row_offset=row_off, col_offset=col_off, causal=mode,
              window=window)
    want = fa.flash_chunk_plain(q, k, v, fa.init_flash_carry(sq, h, dh, cuda_device), **kw)
    got = fa.flash_attention_chunk(q, k, v, fa.init_flash_carry(sq, h, dh, cuda_device), **kw)
    torch.cuda.synchronize()
    o = fa.finalize_flash_carry(got, torch.float32)
    o_plain = fa.finalize_flash_carry(want, torch.float32)
    bound = fa.plain_gap_bound(q, k, v, o, o_plain, scale=scale, n_terms=skv)
    assert bool(((o - o_plain).abs() <= bound).all()), float(((o - o_plain).abs() - bound).max())
    ds = fa.score_gap(q, k, scale)
    empty = want[2] == 0.0
    assert torch.equal(got[2] == 0.0, empty)
    assert torch.equal(got[1][empty], want[1][empty])
    assert bool(((got[1] - want[1]).abs() <= ds + 1e-6).all())
    rel = 4 * ds + 2 * skv * 2.0**-23 + 2.0**-20
    assert bool(((got[2] - want[2]).abs() <= rel * want[2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_band_kernel_leaves_an_unreached_carry_as_it_was(cuda_device, dtype):
    """A fold whose whole band is empty (a window behind the chunk, or no
    keys at all) leaves every bit of a carry that holds earlier folds;
    the forward on the same band gives o = 0 and lse = NEG_INF."""
    sq, h, h_kv, dh = 300, 4, 2, 128
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    acc = _uniform((h, sq, dh), torch.float32, gen, cuda_device)
    m = _uniform((h, sq, 1), torch.float32, gen, cuda_device) * 3
    l = torch.rand((h, sq, 1), generator=gen, device=cuda_device) + 1
    for skv, row_off, window in ((256, 5000, 100), (0, 0, 0)):
        q, k, v = _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
        carry = (acc.clone(), m.clone(), l.clone())
        tiles = dict(fa.FORWARD_TILES)
        got = fa.flash_attention_chunk(q, k, v, carry, scale=dh**-0.5, row_offset=row_off,
                                       col_offset=0, causal="offset", window=window)
        o, lse = fa.flash_forward(q, k, v, scale=dh**-0.5, row_offset=row_off,
                                  window=window)
        torch.cuda.synchronize()
        assert fa.FORWARD_TILES == dict(tiles, band=tiles["band"] + 2)
        for g, w in zip(got, (acc, m, l)):
            assert torch.equal(g, w)
        assert not bool(o.any()) and bool((lse == fa.NEG_INF).all())


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
    tiles = dict(fa.FORWARD_TILES)
    for src in (3, 2, 1, 0):
        carry = fa.flash_attention_chunk(
            q, k[src * s:(src + 1) * s].contiguous(),
            v[src * s:(src + 1) * s].contiguous(), carry, scale=dh**-0.5,
            row_offset=3 * s, col_offset=src * s,
            causal="diagonal" if src == 3 else "past",
        )
    kernel = fa.forward_kernel("chunk", dtype)
    assert fa.FORWARD_TILES == dict(tiles, **{kernel: tiles[kernel] + 4})
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

#: (b, S, h, h_kv, window, int8); every case runs in bf16 and fp16 (the
#: tensor-core kernel) and float32 (the SIMT one), contiguous and paged
#: (64-key pages, sequence 1's first page shared with sequence 0's: two
#: slots on one page)
DECODE_CASES = [
    (4, 1000, 4, 4, 0, False),      # MHA, ragged positions
    (3, 777, 8, 2, 0, False),       # GQA 4
    (4, 1000, 16, 1, 0, False),     # MQA, G = 16
    (4, 1000, 8, 4, 100, False),    # window (across pages when paged)
    (4, 1000, 4, 4, 0, True),       # int8
    (2, 513, 8, 1, 50, True),       # int8, G = 8, window
    (3, 700, 16, 1, 0, True),       # int8, G = 16
    (4, 1000, 16, 2, 150, True),    # int8, G = 8, a window across pages
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
    before, tiles = da.LAUNCHES["decode"], dict(da.DECODE_TILES)
    got = da.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, window=window)
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode"] == before + 1
    design = "simt" if dtype == torch.float32 else "mma"
    assert da.DECODE_TILES == dict(tiles, **{design: tiles[design] + 1})
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
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False)])
def test_decode_kernel_is_deterministic_and_replays(cuda_device, paged, dtype, int8):
    """Two calls, and two replays of a CUDA graph that captured a third,
    give the same output bit for bit: the last block of each (sequence, kv
    head) merges the splits in split order, and every launch leaves the
    arrival counters zero. The shape splits each sequence many ways."""
    b, S, h, h_kv, ps = 2, 4096, 16, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    pos = torch.tensor([S - 1, 2000], dtype=torch.int32, device=cuda_device)
    q, k, v, ks, vs, _, _ = _decode_inputs(b, S, h, h_kv, 128, dtype, int8, gen,
                                           cuda_device, False, pos)
    if paged:
        (k, v, ks, vs), table = _paged(k, v, ks, vs, pos, ps, gen, cuda_device)
        assert da.num_splits(S, b, h_kv, da._sm_count(0), ps) > 1

        def call():
            return da.paged_decode_attention(q, k, v, table, pos, k_scale=ks, v_scale=vs)
    else:
        assert da.num_splits(S, b, h_kv, da._sm_count(0)) > 1

        def call():
            return da.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)

    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    assert torch.equal(call(), first)


@pytest.mark.cuda
def test_decode_two_slots_on_one_page(cuda_device):
    """Two sequences with the same query mapped to the same pages at the
    same position read the same keys: their outputs are equal bit for bit."""
    h, ps, P = 16, 64, 6
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    pool = _uniform((P, ps, h, 128), torch.bfloat16, gen, cuda_device)
    pool_v = _uniform((P, ps, h, 128), torch.bfloat16, gen, cuda_device)
    q = _uniform((1, h, 128), torch.bfloat16, gen, cuda_device).expand(2, h, 128).contiguous()
    table = torch.tensor([[4, 1, 3], [4, 1, 3]], dtype=torch.int32, device=cuda_device)
    pos = torch.tensor([150, 150], dtype=torch.int32, device=cuda_device)
    got = da.paged_decode_attention(q, pool, pool_v, table, pos)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    want = da.paged_decode_attention_plain(q, pool, pool_v, table, pos)
    bound = da.plain_gap_bound(q, 1.0, 1.0, got, want, n_terms=3 * ps)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
def test_decode_tiles_show_the_design(cuda_device):
    """bf16 and fp16 queries run the tensor-core kernel, float32 ones the
    SIMT kernel, one launch a call whatever the split."""
    b, S, h = 8, 8193, 16
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    pos = torch.full((b,), S - 1, dtype=torch.int32, device=cuda_device)
    for dtype, design in ((torch.bfloat16, "mma"), (torch.float16, "mma"),
                          (torch.float32, "simt")):
        q, k, v, _, _, _, _ = _decode_inputs(b, S, h, 4, 128, dtype, False, gen,
                                             cuda_device, False, pos)
        da.reset_launches()
        da.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert da.LAUNCHES == {"decode": 1, "paged": 0}
        assert da.DECODE_TILES == {"mma": int(design == "mma"), "simt": int(design == "simt")}


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


#: the Hopper tiles' edges (TMA widths, k % 16 == 0, k not a multiple of
#: their 128-byte stage): m on both sides of the small-m cut (small_m's N
#: = 8, 16, 32 and 64 at m = 1, 8, 17 and 64; wgmma at 65 and 129), n
#: ragged to both tiles' column blocks (at 131 the output's rows are not
#: a multiple of 16 bytes, so wgmma stores through its staged epilogue
#: instead of TMA); at 200 columns the small_m grid splits k, at 33,800
#: (529 tiles of 64) it does not
K7_TILE_M = [1, 8, 17, 64, 65, 129]
K7_TILE_NK = [(200, 1040), (1000, 272), (131, 528)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", INT8_OUT)
@pytest.mark.parametrize("n,k", K7_TILE_NK)
@pytest.mark.parametrize("m", K7_TILE_M)
def test_int8_hopper_tiles_bit_equal_to_plain(cuda_device, m, n, k, out_dtype):
    """K7 on a column-major weight runs ``small_m`` (m <= 64) or ``wgmma``
    and equals the plain version bit for bit; the launch is counted on
    that tile alone. Twice in a row: small_m leaves its split-k workspace
    zero for the next launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * n + k)
    aq, bq, sa, sb = _int8_operands(m, n, k, gen, cuda_device)
    col = qm.column_major(bq)
    tile = "small_m" if m <= qm.SMALL_M else "wgmma"
    assert qm.tile_for(m, n, k, qm.layout_of(col), aq.data_ptr(), col.data_ptr()) == tile
    want = qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)
    for _ in range(2):
        before = dict(qm.TILES)
        got = qm.int8_matmul_kernel(aq, col, sa, sb, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert qm.TILES == dict(before, **{tile: before[tile] + 1})
        assert got.shape == (m, n) and got.dtype == out_dtype
        assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [8, 64])
def test_int8_small_m_single_split_bit_equal_to_plain(cuda_device, m, out_dtype):
    """small_m at 529 weight tiles (33,800 columns): one k split, the
    epilogue from each block's own sums."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    aq, bq, sa, sb = _int8_operands(m, 33800, 256, gen, cuda_device)
    got = qm.int8_matmul_kernel(aq, qm.column_major(bq), sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", INT8_OUT)
@pytest.mark.parametrize("m,n,k,offset", [(129, 131, 7, 0), (1000, 776, 520, 0),
                                          (8, 200, 1024, 1), (300, 264, 64, 1)])
def test_int8_mma_tile_on_a_column_major_weight(cuda_device, m, n, k, offset, out_dtype):
    """The mma tile's K-major read of a column-major weight, where TMA
    cannot take the operands: k not a multiple of 16, or an unaligned base
    (A one byte into its storage)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    aq, bq, sa, sb = _int8_operands(m, n, k, gen, cuda_device)
    if offset:
        storage = torch.empty(m * k + offset, dtype=torch.int8, device=cuda_device)
        storage[offset:].view(m, k).copy_(aq)
        aq = storage[offset:].view(m, k)
    col = qm.column_major(bq)
    assert qm.tile_for(m, n, k, "col", aq.data_ptr(), col.data_ptr()) == "mma"
    before = dict(qm.TILES)
    got = qm.int8_matmul_kernel(aq, col, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qm.TILES == dict(before, mma=before["mma"] + 1)
    assert torch.equal(got, qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype))


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    aq, bq, sa, sb = _int8_operands(64, 64, 64, gen, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul_kernel(aq.t(), bq, sa, sb)
    with pytest.raises(ValueError, match="row-major or column-major"):
        qm.int8_matmul_kernel(aq, torch.cat([bq, bq], 1)[:, ::2], sa, sb)
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
# magnitudes the plain tile loop sums (|dS||K|, |dS||Q|, P|dO|). Each pass
# is counted by kernel (``BACKWARD_TILES``): in bf16/fp16 the triangle on
# the Hopper wgmma passes (tri_bwd), the rectangle on the Hopper band
# passes (band_bwd, the same shape over a runtime band); float32 on SIMT.

#: K8a's Hopper kernel at ragged lengths (below one tile, one short of
#: it, one past it, ragged past several) and GQA 8/2: (sq, h, h_kv)
WGMMA_FLASH_CASES = [(1, 2, 2), (127, 2, 2), (129, 8, 2), (1000, 8, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", WGMMA_FLASH_CASES)
def test_wgmma_flash_forward_matches_plain(cuda_device, case, dtype):
    """The triangle on the wgmma kernel: exact on band inputs, within
    plain_gap_bound and the lse tolerance on uniform and peaked ones,
    every call one wgmma launch."""
    sq, h, h_kv = case
    dh = 128
    kw = dict(scale=dh**-0.5)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    assert fa.forward_kernel(fa.forward_case(sq, sq, 0, True, 0)[0], dtype) == "wgmma"
    tiles = dict(fa.FORWARD_TILES)
    q, k, v = _band_qkv(sq, sq, h, h_kv, dh, dtype, gen, cuda_device)
    o, lse = fa.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    o_plain, lse_plain = fa.flash_forward_plain(q, k, v, **kw)
    assert torch.equal(o, o_plain)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-6, atol=0)
    _assert_forward_within_bound(*_uniform_qkv(sq, sq, h, h_kv, dh, dtype, gen, cuda_device), kw)
    _assert_forward_within_bound(
        *_peaked_qkv(sq, sq, h, h_kv, dh, dtype, gen, cuda_device, 0), kw)
    assert fa.FORWARD_TILES == dict(tiles, wgmma=tiles["wgmma"] + 3)


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
    # the triangle across the Hopper kernels' seams (128-row dQ tiles,
    # 128-key dK/dV tiles over 64-query steps, the producers' rings)
    (320, 320, 4, 4, 0, 0, "offset", 0),        # 64 x 5: an odd number of steps
    (129, 129, 2, 2, 0, 0, "offset", 0),        # one past a tile
    (1000, 1000, 8, 2, 0, 0, "offset", 0),      # ragged, GQA 4
    (2048, 2048, 16, 16, 0, 0, "offset", 0),    # the rings wrap many times
    # the band's edges (128-row dQ tiles, 128-key tiles in 64-key halves,
    # 64-query dK/dV steps)
    (384, 512, 4, 4, 192, 0, "offset", 0),      # a causal edge across two key tiles
    (512, 1100, 8, 2, 576, 0, "offset", 200),   # a window edge across two, GQA 4, ragged
    (256, 1024, 4, 4, 1000, 0, "offset", 100),  # blocks with an empty band
    (64, 256, 2, 2, 2048, 0, "offset", 300),    # every block empty: the window behind the keys
    (300, 500, 4, 4, 0, 0, "none", 0),          # bidirectional, sq != skv
    (1000, 1000, 4, 2, 0, 0, "offset", 256),    # a window at offset 0, ragged
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
    kernel = fa.backward_kernel(case_name, dtype)
    assert kernel == ("simt" if dtype == torch.float32
                      else "wgmma" if case_name == "tri" else "band")
    before, tiles = dict(fa.LAUNCHES), dict(fa.BACKWARD_TILES)
    got = fa.flash_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for pass_ in ("dq", "dkv"):
        key = f"bwd_{pass_}_{case_name}"
        assert fa.LAUNCHES[key] == before[key] + 1
    assert fa.BACKWARD_TILES == dict(tiles, **{kernel: tiles[kernel] + 2})
    want = fa.flash_backward_plain(q, k, v, o, lse, do, **kw)
    bounds = fa.backward_gap_bound(q, k, v, o, lse, do, want, **kw)
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        gap = (g - w).abs()
        assert bool(torch.isfinite(g).all()), name
        assert bool((gap <= b).all()), (name, float((gap - b).max()))


#: rectangles on the band passes: (sq, skv, h, h_kv, row_offset, col_offset,
#: mode, window)
BAND_DETERMINISM_CASES = [
    (777, 1500, 4, 2, 723, 0, "offset", 300),
    (512, 512, 8, 2, 1536, 512, "past", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", BAND_DETERMINISM_CASES)
def test_band_backward_is_deterministic(cuda_device, case, dtype):
    """Two calls of the band passes on the same inputs give bit-identical
    dq, dk and dv: each gradient is summed in one direction, in a fixed
    order, without atomics."""
    sq, skv, h, h_kv, ro, co, mode, window = case
    dh = 128
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v = _uniform_qkv(sq, skv, h, h_kv, dh, dtype, gen, cuda_device)
    do = _uniform((sq, h, dh), dtype, gen, cuda_device)
    o, lse = _backward_forward(q, k, v, ro, co, mode, window)
    kw = dict(scale=dh**-0.5, row_offset=ro, col_offset=co, causal=mode, window=window)
    assert fa.backward_kernel(fa.backward_case(sq, skv, ro, co, mode, window)[0], dtype) == "band"
    tiles = dict(fa.BACKWARD_TILES)
    first = fa.flash_backward(q, k, v, o, lse, do, **kw)
    second = fa.flash_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.BACKWARD_TILES == dict(tiles, band=tiles["band"] + 4)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name


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
    before, tiles = dict(fa.LAUNCHES), dict(fa.BACKWARD_TILES)
    out = fa.flash_attention(*leaves, scale=dh**-0.5)
    grads = torch.autograd.grad((out.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["bwd_dq_tri"] == before["bwd_dq_tri"] + 1
    assert fa.LAUNCHES["bwd_dkv_tri"] == before["bwd_dkv_tri"] + 1
    kernel = "simt" if dtype == torch.float32 else "wgmma"
    assert fa.BACKWARD_TILES == dict(tiles, **{kernel: tiles[kernel] + 2})
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_forward_lse_feeds_the_backward(cuda_device, dtype):
    """At 1024², the wgmma forward's lse (natural-log units) is what K10a and
    K10b (the wgmma backward) read: autograd through ``flash_attention``
    against autograd of the plain float32 einsum attention, within the
    tolerance of ``test_flash_attention_gradient_through_the_kernels``."""
    sq, h, dh = 1024, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = _uniform_qkv(sq, sq, h, h, dh, dtype, gen, cuda_device)
    w = _uniform((sq, h, dh), torch.float32, gen, cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tiles, before = dict(fa.FORWARD_TILES), dict(fa.LAUNCHES)
    bwd_tiles = dict(fa.BACKWARD_TILES)
    out = fa.flash_attention(*leaves, scale=dh**-0.5)
    grads = torch.autograd.grad((out.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    assert fa.FORWARD_TILES == dict(tiles, wgmma=tiles["wgmma"] + 1)
    assert fa.BACKWARD_TILES == dict(bwd_tiles, wgmma=bwd_tiles["wgmma"] + 2)
    assert fa.LAUNCHES["bwd_dq_tri"] == before["bwd_dq_tri"] + 1
    assert fa.LAUNCHES["bwd_dkv_tri"] == before["bwd_dkv_tri"] + 1
    ref = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    s = torch.einsum("qhd,khd->hqk", ref[0], ref[1]) * dh**-0.5
    mask = torch.ones((sq, sq), dtype=torch.bool, device=cuda_device).tril()
    p = torch.softmax(s.masked_fill(~mask, fa.NEG_INF), -1)
    o_ref = torch.einsum("hqk,khd->qhd", p, ref[2])
    want = torch.autograd.grad((o_ref * w).sum(), ref)
    for g, r in zip(grads, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r, rtol=2e-2, atol=3e-2)


# -- K2 / K3: the ring collective matmuls, d virtual ranks on one card -------------

from ddlb_tpu_torch.ops import collective_matmul as cm  # noqa: E402

#: (d, m_loc, n, k) a rank; K3 contracts k per rank (its k / d)
RING_CASES = [
    (1, 256, 384, 512),
    (2, 256, 384, 512),
    (3, 200, 776, 520),
    (4, 512, 512, 1024),
    (4, 130, 264, 72),
]
RING_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _ring_operands(d, m_loc, n, k, dtype, gen, device, integer):
    def make(shape):
        if integer:
            return torch.randint(-4, 5, shape, generator=gen, device=device).to(dtype)
        return _uniform(shape, dtype, gen, device)

    ag = ([make((m_loc, k)) for _ in range(d)], make((k, n)))
    rs = ([make((d * m_loc, k)) for _ in range(d)], [make((k, n)) for _ in range(d)])
    return ag, rs


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", RING_DTYPES)
@pytest.mark.parametrize("d,m_loc,n,k", RING_CASES)
def test_ring_kernels_loopback_match_virtual(cuda_device, d, m_loc, n, k, dtype,
                                             integer):
    """K2 and K3 running d virtual ranks in one launch, three calls on one
    ring (the epoch counters), against the plain ring run in one process:
    bit for bit on integer operands (every sum exact in float32, so both
    sides round the same values at every hop); else K2 within K1's
    ``plain_gap_bound`` and K3 within ``ring_matmul_rs_gap_bound``
    (the GEMM gap and the roundings, hop by hop), f32 within 1e-5 * k."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 7 + m_loc)
    (shards, b), (a_rs, b_rs) = _ring_operands(d, m_loc, n, k, dtype, gen,
                                               cuda_device, integer)
    ring_ag = cm.loopback_ring("ag", d, m_loc * k, dtype, cuda_device)
    ring_rs = cm.loopback_ring("rs", d, m_loc * n, dtype, cuda_device)
    want_ag = cm.ring_ag_matmul_virtual(shards, b)
    want_rs = cm.ring_matmul_rs_virtual(a_rs, b_rs)
    a_full = torch.cat(shards)
    rs_bounds = None if integer or dtype == torch.float32 else \
        cm.ring_matmul_rs_gap_bound(a_rs, b_rs)
    for call in range(3):
        before = dict(cm.LAUNCHES)
        got_ag = cm.ring_ag_matmul_loopback(shards, b, ring_ag)
        got_rs = cm.ring_matmul_rs_loopback(a_rs, b_rs, ring_rs)
        torch.cuda.synchronize()
        assert cm.LAUNCHES == {"ag": before["ag"] + 1, "rs": before["rs"] + 1}
        for r in range(d):
            g_ag, w_ag, g_rs, w_rs = got_ag[r], want_ag[r], got_rs[r], want_rs[r]
            assert g_ag.shape == (d * m_loc, n) and g_rs.shape == (m_loc, n)
            if integer:
                assert torch.equal(g_ag, w_ag), (call, r)
                assert torch.equal(g_rs, w_rs), (call, r)
            elif dtype == torch.float32:
                np.testing.assert_allclose(to_numpy(g_ag), to_numpy(w_ag), rtol=0, atol=1e-5 * k)
                np.testing.assert_allclose(to_numpy(g_rs), to_numpy(w_rs), rtol=0, atol=1e-5 * k)
            else:
                gap = (g_ag.float() - w_ag.float()).abs()
                assert bool((gap <= k1.plain_gap_bound(a_full, b, g_ag, w_ag)).all()), (call, r)
                gap = (g_rs.float() - w_rs.float()).abs()
                assert bool((gap <= rs_bounds[r]).all()), (call, r, float((gap - rs_bounds[r]).max()))
    assert ring_ag.epoch == ring_rs.epoch == 3


@pytest.mark.cuda
def test_ring_kernels_reject_what_they_do_not_take(cuda_device):
    a = torch.zeros((64, 32), device=cuda_device, dtype=torch.bfloat16)
    b = torch.zeros((32, 16), device=cuda_device, dtype=torch.bfloat16)
    ring = cm.loopback_ring("ag", 2, 64 * 32, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="'ag' ring passed to the 'rs'"):
        cm.ring_matmul_rs_loopback([a, a], [b, b], ring)
    with pytest.raises(ValueError, match="ring of torch.bfloat16"):
        cm.ring_ag_matmul_loopback([a.half(), a.half()], b.half(), ring)
    with pytest.raises(ValueError, match="does not fit"):
        cm.ring_ag_matmul_loopback([torch.cat([a, a])] * 2, b, ring)
    with pytest.raises(ValueError, match="contiguous"):
        cm.ring_ag_matmul_loopback([a[:, :16], a[:, :16]], b[:16], ring)
    with pytest.raises(ValueError, match="3 shards on a ring of 2"):
        cm.ring_ag_matmul_loopback([a, a, a], b, ring)
    # a CUDA tensor never takes the plain version: without this world's
    # peer ring the wrapper raises
    from ddlb_tpu_torch.runtime import Runtime

    with pytest.raises(ValueError, match="needs this world's peer ring"):
        cm.ring_ag_matmul(a, b, Runtime("cuda"))
    with pytest.raises(ValueError, match="needs this world's peer ring"):
        cm.ring_matmul_rs(a, b, Runtime("cuda"), ring)


# -- K4, K5 and K6 in loopback: d virtual ranks in one launch ---------------------

from ddlb_tpu_torch.ops import alltoall_matmul as am  # noqa: E402
from ddlb_tpu_torch.ops import ring_collectives as rc  # noqa: E402

#: (d, rows a rank, k): K5 splits the rows a rank into d chunks
RING_COLL_CASES = [
    (1, 64, 256),
    (2, 256, 512),
    (3, 96, 520),
    (4, 512, 1024),
    (4, 132, 72),
]
#: (d, g, n, k): g tokens a routing group
A2A_CASES = [
    (1, 64, 128, 256),
    (2, 128, 256, 512),
    (3, 100, 776, 520),
    (4, 256, 512, 1024),
    (4, 130, 264, 72),
]


def _make(shape, dtype, gen, device, integer):
    if integer:
        return torch.randint(-4, 5, shape, generator=gen, device=device).to(dtype)
    return _uniform(shape, dtype, gen, device)


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", RING_DTYPES)
@pytest.mark.parametrize("d,m_loc,k", RING_COLL_CASES)
def test_ring_collectives_loopback_match_virtual(cuda_device, d, m_loc, k, dtype, integer):
    """K4 and K5 running d virtual ranks in one launch, three calls on one
    ring each (the epoch counters), against the plain ring run in one
    process: bit for bit on any operands (K4 copies; K5 rounds the same
    float32 sum of the same two values at every hop, in the same order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 11 + m_loc)
    shards = [_make((m_loc, k), dtype, gen, cuda_device, integer) for _ in range(d)]
    ring_ag = rc.loopback_ring("all_gather", d, m_loc * k, dtype, cuda_device)
    ring_rs = rc.loopback_ring("reduce_scatter", d, (m_loc // d) * k, dtype, cuda_device)
    want_ag = rc.ring_all_gather_virtual(shards)
    want_rs = rc.ring_reduce_scatter_virtual(shards)
    for call in range(3):
        before = dict(rc.LAUNCHES)
        got_ag = rc.ring_all_gather_loopback(shards, ring_ag)
        got_rs = rc.ring_reduce_scatter_loopback(shards, ring_rs)
        torch.cuda.synchronize()
        assert rc.LAUNCHES == {"ag": before["ag"] + 1, "rs": before["rs"] + 1}
        for r in range(d):
            assert got_ag[r].shape == (d * m_loc, k) and got_rs[r].shape == (m_loc // d, k)
            assert torch.equal(got_ag[r], want_ag[r]), (call, r)
            assert torch.equal(got_rs[r], want_rs[r]), (call, r)
    assert ring_ag.epoch == ring_rs.epoch == 3


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", RING_DTYPES)
@pytest.mark.parametrize("d,g,n,k", A2A_CASES)
def test_alltoall_matmul_loopback_matches_virtual(cuda_device, d, g, n, k, dtype, integer):
    """K6 running d virtual ranks in one launch, three calls on one set of
    buffers, against the one-process version: bit for bit on integer
    operands (every sum exact in float32), else each group within K1's
    ``plain_gap_bound`` (f32 within 1e-5 * k)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 13 + g)
    shards = [_make((d * g, k), dtype, gen, cuda_device, integer) for _ in range(d)]
    experts = [_make((k, n), dtype, gen, cuda_device, integer) for _ in range(d)]
    bufs = am.loopback_buffers(d, g, k, n, dtype, cuda_device)
    want = am.alltoall_expert_matmul_virtual(shards, experts)
    for call in range(3):
        before = am.LAUNCHES["a2a"]
        got = am.alltoall_expert_matmul_loopback(shards, experts, bufs)
        torch.cuda.synchronize()
        assert am.LAUNCHES["a2a"] == before + 1
        for r in range(d):
            assert got[r].shape == (d * g, n) and got[r].dtype == dtype
            if integer:
                assert torch.equal(got[r], want[r]), (call, r)
            elif dtype == torch.float32:
                np.testing.assert_allclose(to_numpy(got[r]), to_numpy(want[r]), rtol=0,
                                           atol=1e-5 * k)
            else:
                for e in range(d):
                    rows = slice(e * g, (e + 1) * g)
                    bound = k1.plain_gap_bound(shards[r][rows], experts[e], got[r][rows],
                                               want[r][rows])
                    gap = (got[r][rows].float() - want[r][rows].float()).abs()
                    assert bool((gap <= bound).all()), (call, r, e)
    assert bufs.epoch == 3


#: the Hopper tile's edges, (d, rows a rank, n, k): K2's m_loc and K6's g
#: not multiples of the tile's 128 rows, n not a multiple of its 256
#: columns, k not a multiple of its 64-deep stage
HOPPER_CASES = [(d, rows, 776, 520) for d in (2, 3, 4) for rows in (1000, 100)]


def _hopper_operands(shapes, dtype, gen, device, kind):
    out = []
    for shape in shapes:
        if kind == "integer":
            x = torch.randint(-4, 5, shape, generator=gen, device=device).float()
        else:
            x = torch.rand(shape, generator=gen, device=device) * 2 - 1
            if kind == "dyadic":
                x = torch.round(x * 16) / 16
        out.append(x.to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "dyadic", "uniform"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,rows,n,k", HOPPER_CASES)
def test_hopper_tile_k2_and_k6_loopback_match_virtual(cuda_device, d, rows, n, k, dtype,
                                                      kind):
    """K2 and K6 on the Hopper tile (``csrc/hopper_gemm.cuh``), d virtual
    ranks in one launch, three calls on one ring and one buffer set (the
    epochs advance), at widths that reach every ragged edge of the tile:
    bit for bit against the plain versions on integer and dyadic operands
    (every sum exact in float32), within K1's ``plain_gap_bound`` on
    uniform ones; the tile counters show the Hopper tile ran."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 17 + rows)
    shards = _hopper_operands([(rows, k)] * d, dtype, gen, cuda_device, kind)
    (b,) = _hopper_operands([(k, n)], dtype, gen, cuda_device, kind)
    tokens = _hopper_operands([(d * rows, k)] * d, dtype, gen, cuda_device, kind)
    experts = _hopper_operands([(k, n)] * d, dtype, gen, cuda_device, kind)
    assert cm.tile_for(dtype, k, n) == am.tile_for(dtype) == "wgmma"
    ring = cm.loopback_ring("ag", d, rows * k, dtype, cuda_device)
    bufs = am.loopback_buffers(d, rows, k, n, dtype, cuda_device)
    want_ag = cm.ring_ag_matmul_virtual(shards, b)
    want_a2a = am.alltoall_expert_matmul_virtual(tokens, experts)
    a_full = torch.cat(shards)
    for call in range(3):
        before = (dict(cm.TILES), dict(am.TILES))
        got_ag = cm.ring_ag_matmul_loopback(shards, b, ring)
        got_a2a = am.alltoall_expert_matmul_loopback(tokens, experts, bufs)
        torch.cuda.synchronize()
        assert cm.TILES == dict(before[0], wgmma=before[0]["wgmma"] + 1)
        assert am.TILES == dict(before[1], wgmma=before[1]["wgmma"] + 1)
        for r in range(d):
            if kind != "uniform":
                assert torch.equal(got_ag[r], want_ag[r]), (call, r)
                assert torch.equal(got_a2a[r], want_a2a[r]), (call, r)
                continue
            gap = (got_ag[r].float() - want_ag[r].float()).abs()
            assert bool((gap <= k1.plain_gap_bound(a_full, b, got_ag[r], want_ag[r])).all()), \
                (call, r)
            for e in range(d):
                rows_e = slice(e * rows, (e + 1) * rows)
                got, want = got_a2a[r][rows_e], want_a2a[r][rows_e]
                bound = k1.plain_gap_bound(tokens[r][rows_e], experts[e], got, want)
                assert bool(((got.float() - want.float()).abs() <= bound).all()), (call, r, e)
    assert ring.epoch == bufs.epoch == 3 and ring.tile == "wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "dyadic", "uniform"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wmma_tile_k2_loopback_matches_virtual(cuda_device, dtype, kind):
    """K2 on 16-bit operands whose rows TMA cannot load (k and n not
    multiples of 8 elements) runs K1's wmma tile beside put blocks: three
    virtual ranks in one launch, three calls on one ring, bit for bit
    against the plain ring on integer and dyadic operands, within K1's
    ``plain_gap_bound`` on uniform ones; the tile counter shows it ran."""
    d, rows, n, k = 3, 130, 262, 74
    gen = torch.Generator(device=cuda_device).manual_seed(d * 17 + rows)
    shards = _hopper_operands([(rows, k)] * d, dtype, gen, cuda_device, kind)
    (b,) = _hopper_operands([(k, n)], dtype, gen, cuda_device, kind)
    assert cm.tile_for(dtype, k, n) == "wmma"
    ring = cm.loopback_ring("ag", d, rows * k, dtype, cuda_device)
    want = cm.ring_ag_matmul_virtual(shards, b)
    a_full = torch.cat(shards)
    for call in range(3):
        before = dict(cm.TILES)
        got = cm.ring_ag_matmul_loopback(shards, b, ring)
        torch.cuda.synchronize()
        assert cm.TILES == dict(before, wmma=before["wmma"] + 1)
        for r in range(d):
            if kind != "uniform":
                assert torch.equal(got[r], want[r]), (call, r)
                continue
            gap = (got[r].float() - want[r].float()).abs()
            assert bool((gap <= k1.plain_gap_bound(a_full, b, got[r], want[r])).all()), \
                (call, r)
    assert ring.epoch == 3 and ring.tile == "wmma"


#: K3 on the Hopper tile, (d, m_loc, n, k/d): m_loc not a multiple of the
#: tile's 128 rows, n not of its 256 columns, k/d not of its 64-deep stage
#: (d = 1 is one step that stores the GEMM into the output)
K3_HOPPER_CASES = [(1, 1000, 776, 520), (2, 1000, 776, 520), (3, 130, 264, 72),
                   (4, 100, 776, 520)]


def _k3_loopback_against_virtual(d, m_loc, n, kd, dtype, kind, tile, device):
    """Three K3 loopback calls on one ring against ``ring_matmul_rs_virtual``:
    bit for bit on integer and dyadic operands (every partial and every
    hop's sum exact in float32, so both sides round the same values), within
    ``ring_matmul_rs_gap_bound`` on uniform ones; ``RS_TILES`` grows by one
    on ``tile`` a call and ``TILES`` (K2's) not at all."""
    gen = torch.Generator(device=device).manual_seed(d * 19 + m_loc)
    a = _hopper_operands([(d * m_loc, kd)] * d, dtype, gen, device, kind)
    b = _hopper_operands([(kd, n)] * d, dtype, gen, device, kind)
    assert cm.tile_for(dtype, kd, n) == tile
    ring = cm.loopback_ring("rs", d, m_loc * n, dtype, device)
    want = cm.ring_matmul_rs_virtual(a, b)
    bounds = cm.ring_matmul_rs_gap_bound(a, b) if kind == "uniform" else None
    for call in range(3):
        before = (dict(cm.RS_TILES), dict(cm.TILES), dict(cm.LAUNCHES))
        got = cm.ring_matmul_rs_loopback(a, b, ring)
        torch.cuda.synchronize()
        assert cm.RS_TILES == dict(before[0], **{tile: before[0][tile] + 1})
        assert cm.TILES == before[1]
        assert cm.LAUNCHES == dict(before[2], rs=before[2]["rs"] + 1)
        for r in range(d):
            assert got[r].shape == (m_loc, n) and got[r].dtype == dtype
            if kind != "uniform":
                assert torch.equal(got[r], want[r]), (call, r)
                continue
            gap = (got[r].float() - want[r].float()).abs()
            assert bool((gap <= bounds[r]).all()), (call, r, float((gap - bounds[r]).max()))
    assert ring.epoch == 3 and ring.tile == tile


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "dyadic", "uniform"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,m_loc,n,kd", K3_HOPPER_CASES)
def test_hopper_tile_k3_loopback_matches_virtual(cuda_device, d, m_loc, n, kd, dtype, kind):
    """K3 on the Hopper tile (``ring_rs_wgmma_kernel``), d virtual ranks in
    one launch, at widths that reach every ragged edge of the tile and of a
    chunk (TMA fills the last tile of a chunk with zeros, not the next
    chunk's rows)."""
    _k3_loopback_against_virtual(d, m_loc, n, kd, dtype, kind, "wgmma", cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "dyadic", "uniform"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wmma_tile_k3_loopback_matches_virtual(cuda_device, dtype, kind):
    """K3 on 16-bit operands whose rows TMA cannot load (k/d and n not
    multiples of 8 elements) runs K1's wmma tile."""
    _k3_loopback_against_virtual(3, 130, 262, 74, dtype, kind, "wmma", cuda_device)


#: K5 on its per-block flags, (d, rows a rank, k): a chunk far smaller than
#: the grid (7 units: most blocks have no share and still signal), a
#: ragged one, and the collectives path's [2048, 8192] a rank at d = 4
K5_CASES = [(2, 14, 8), (3, 3 * 67, 520), (4, 2048, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "dyadic", "uniform"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d,m_loc,k", K5_CASES)
def test_k5_loopback_bit_for_bit_over_three_calls(cuda_device, d, m_loc, k, dtype, kind):
    """K5, d virtual ranks in one launch, three calls on one ring (every
    block's arrival and credit words advance one epoch a call), bit for bit
    against ``ring_reduce_scatter_virtual`` on integer, dyadic and uniform
    operands: both round the same float32 sum of the same two values at
    every hop, in the same order."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 23 + m_loc)
    shards = _hopper_operands([(m_loc, k)] * d, dtype, gen, cuda_device, kind)
    ring = rc.loopback_ring("reduce_scatter", d, (m_loc // d) * k, dtype, cuda_device)
    want = rc.ring_reduce_scatter_virtual(shards)
    for call in range(3):
        before = dict(rc.LAUNCHES)
        got = rc.ring_reduce_scatter_loopback(shards, ring)
        torch.cuda.synchronize()
        assert rc.LAUNCHES == dict(before, rs=before["rs"] + 1)
        for r in range(d):
            assert got[r].shape == (m_loc // d, k)
            assert torch.equal(got[r], want[r]), (call, r)
    assert ring.epoch == 3


#: K4 on its per-block flags, (d, rows a rank, k): a shard far smaller than
#: the grid (most blocks have no share and still signal), a ragged one,
#: and the collectives path's [2048, 8192] a rank at d = 4
K4_CASES = [(2, 2, 8), (3, 67, 520), (4, 2048, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "uniform"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d,m_loc,k", K4_CASES)
def test_k4_loopback_bit_for_bit_twice_on_one_ring(cuda_device, d, m_loc, k, dtype, kind):
    """K4, d virtual ranks in one launch, two calls in a row on one ring
    (every block's arrival and credit words advance one epoch a call), bit
    for bit against ``ring_all_gather_virtual``: it copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 29 + m_loc)
    shards = _hopper_operands([(m_loc, k)] * d, dtype, gen, cuda_device, kind)
    ring = rc.loopback_ring("all_gather", d, m_loc * k, dtype, cuda_device)
    want = rc.ring_all_gather_virtual(shards)
    for call in range(2):
        before = dict(rc.LAUNCHES)
        got = rc.ring_all_gather_loopback(shards, ring)
        torch.cuda.synchronize()
        assert rc.LAUNCHES == dict(before, ag=before["ag"] + 1)
        for r in range(d):
            assert got[r].shape == (d * m_loc, k)
            assert torch.equal(got[r], want[r]), (call, r)
    assert ring.epoch == 2


@pytest.mark.cuda
def test_trio_kernels_reject_what_they_do_not_take(cuda_device):
    a = torch.zeros((64, 32), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((32, 16), device=cuda_device, dtype=torch.bfloat16)
    ring = rc.loopback_ring("all_gather", 2, 64 * 32, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="'all_gather' ring passed to the 'reduce_scatter'"):
        rc.ring_reduce_scatter_loopback([a, a], ring)
    with pytest.raises(ValueError, match="ring of torch.bfloat16"):
        rc.ring_all_gather_loopback([a.half(), a.half()], ring)
    with pytest.raises(ValueError, match="does not fit"):
        rc.ring_all_gather_loopback([torch.cat([a, a])] * 2, ring)
    with pytest.raises(ValueError, match="contiguous"):
        rc.ring_all_gather_loopback([a[:, :16], a[:, :16]], ring)
    with pytest.raises(ValueError, match="3 shards on a ring of 2"):
        rc.ring_all_gather_loopback([a, a, a], ring)
    bufs = am.loopback_buffers(2, 32, 32, 16, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="buffers for g=32"):
        am.alltoall_expert_matmul_loopback([a[:32], a[:32]], [w, w], bufs)
    with pytest.raises(ValueError, match="contiguous"):
        am.alltoall_expert_matmul_loopback([a[:, :16]] * 2, [w[:16]] * 2)
    # a CUDA tensor never takes the plain version: without this world's
    # peer ring or buffers the wrappers raise
    from ddlb_tpu_torch.runtime import Runtime

    rt = Runtime("cuda")
    with pytest.raises(ValueError, match="needs this world's peer ring"):
        rc.ring_all_gather(a, rt)
    with pytest.raises(ValueError, match="needs this world's peer ring"):
        rc.ring_reduce_scatter(a, rt, ring)
    with pytest.raises(ValueError, match="needs this world's peer buffers"):
        am.alltoall_expert_matmul(a, w, rt)


@pytest.mark.cuda
@pytest.mark.parametrize("family,options", [
    ("collectives", {"op": "all_gather"}),
    ("collectives", {"op": "reduce_scatter"}),
    ("collectives", {"op": "all_reduce"}),
    ("ep_alltoall", {"algorithm": "a2a_rdma"}),
    ("dp_allreduce", {"algorithm": "ring_rdma"}),
])
def test_trio_cuda_members_run_their_kernels_and_validate(cuda_device, family, options):
    """At world 1 the cuda members launch K4, K5 (both for all_reduce), K6 or
    K3 once a call, on buffers set up once, and validate."""
    impl = load_impl_class(family, "cuda")(256, 64, 512, dtype="bfloat16", **options)
    counts = (lambda: (dict(rc.LAUNCHES), am.LAUNCHES["a2a"], dict(cm.LAUNCHES)))
    before = counts()
    result = impl.run()
    torch.cuda.synchronize()
    after = counts()
    launched = (after[0]["ag"] - before[0]["ag"], after[0]["rs"] - before[0]["rs"],
                after[1] - before[1], after[2]["rs"] - before[2]["rs"])
    op = options.get("op")
    want = (int(op in ("all_gather", "all_reduce")), int(op in ("reduce_scatter", "all_reduce")),
            int(family == "ep_alltoall"), int(family == "dp_allreduce"))
    assert launched == want
    assert impl.validate(result)


# -- K2 / K3 over NCCL: four ranks, one card each ------------------------------------

NCCL_WORLD = 4
NCCL_DEADLINE_S = 300
#: (m_loc, n, k) a rank; integer operands (exact) and uniform ones
NCCL_SHAPES = [(256, 384, 512), (130, 264, 72)]
NCCL_CALLS = 3


def _nccl_rank_main(rank, port, results):
    import os
    import traceback

    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(NCCL_WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    from ddlb_tpu_torch.runtime import Runtime

    try:
        rt = Runtime("cuda")
        d, dev = NCCL_WORLD, rt.device
        out = []
        for (m_loc, n, k) in NCCL_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                for integer in (True, False):
                    gen = torch.Generator(device=dev).manual_seed(m_loc + n)
                    (shards, b), (a_rs, b_rs) = _ring_operands(d, m_loc, n, k, dtype, gen,
                                                               dev, integer)
                    ring_ag = cm.peer_ring(rt, "ag", m_loc * k, dtype)
                    ring_rs = cm.peer_ring(rt, "rs", m_loc * n, dtype)
                    want_ag = cm.ring_ag_matmul_plain(shards[rank], b, rt)
                    want_rs = cm.ring_matmul_rs_plain(a_rs[rank], b_rs[rank], rt)
                    before = dict(cm.LAUNCHES)
                    tiles, rs_tiles = dict(cm.TILES), dict(cm.RS_TILES)
                    for _ in range(NCCL_CALLS):
                        got_ag = cm.ring_ag_matmul(shards[rank], b, rt, ring_ag)
                        got_rs = cm.ring_matmul_rs(a_rs[rank], b_rs[rank], rt, ring_rs)
                    torch.cuda.synchronize()
                    launches = {key: cm.LAUNCHES[key] - before[key] for key in before}
                    # K2's and K3's launches by tile
                    launches["tiles"] = {key: cm.TILES[key] - tiles[key] for key in tiles
                                         if cm.TILES[key] != tiles[key]}
                    launches["rs_tiles"] = {key: cm.RS_TILES[key] - rs_tiles[key]
                                            for key in rs_tiles
                                            if cm.RS_TILES[key] != rs_tiles[key]}
                    if integer:
                        ok_ag, ok_rs = torch.equal(got_ag, want_ag), torch.equal(got_rs, want_rs)
                    elif dtype == torch.float32:
                        ok_ag = bool(((got_ag - want_ag).abs() <= 1e-5 * k).all())
                        ok_rs = bool(((got_rs - want_rs).abs() <= 1e-5 * k).all())
                    else:
                        gap = (got_ag.float() - want_ag.float()).abs()
                        ok_ag = bool((gap <= k1.plain_gap_bound(
                            torch.cat(shards), b, got_ag, want_ag)).all())
                        bound = cm.ring_matmul_rs_gap_bound(a_rs, b_rs)[rank]
                        ok_rs = bool(((got_rs.float() - want_rs.float()).abs() <= bound).all())
                    out.append(((m_loc, n, k, str(dtype), integer), ok_ag, ok_rs, launches))
        trio = []
        for (m_loc, n, k) in NCCL_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                for integer in (True, False):
                    trio.append(((m_loc, n, k, str(dtype), integer),
                                 *_nccl_trio(rt, rank, m_loc, n, k, dtype, integer)))
        results.put((rank, "ok", (out, trio)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _nccl_trio(rt, rank, m_loc, n, k, dtype, integer):
    """K4, K5 and K6 on this rank's card, three calls on one ring or set of
    buffers, against their plain versions over NCCL: (K4 equal, K5 equal,
    K6 within bounds, launches by kernel). K4 and K5 are bit for bit on any
    operands; K6 on integer ones, else each group within K1's
    ``plain_gap_bound`` (f32 within 1e-5 * k)."""
    d, dev = NCCL_WORLD, rt.device
    gen = torch.Generator(device=dev).manual_seed(m_loc + n + 1)
    m_loc -= m_loc % d  # K5's chunks and K6's groups
    shards = [_make((m_loc, k), dtype, gen, dev, integer) for _ in range(d)]
    experts = [_make((k, n), dtype, gen, dev, integer) for _ in range(d)]
    g = m_loc // d
    ring_ag = rc.peer_ring(rt, "all_gather", m_loc * k, dtype)
    ring_rs = rc.peer_ring(rt, "reduce_scatter", g * k, dtype)
    bufs = am.peer_buffers(rt, g, k, n, dtype)
    want_ag = rc.ring_all_gather_plain(shards[rank], rt)
    want_rs = rc.ring_reduce_scatter_plain(shards[rank], rt)
    want_a2a = am.alltoall_expert_matmul_plain(shards[rank], experts[rank], rt)
    before = (dict(rc.LAUNCHES), am.LAUNCHES["a2a"], dict(am.TILES))
    for _ in range(NCCL_CALLS):
        got_ag = rc.ring_all_gather(shards[rank], rt, ring_ag)
        got_rs = rc.ring_reduce_scatter(shards[rank], rt, ring_rs)
        got_a2a = am.alltoall_expert_matmul(shards[rank], experts[rank], rt, bufs)
    torch.cuda.synchronize()
    launches = {"ag": rc.LAUNCHES["ag"] - before[0]["ag"],
                "rs": rc.LAUNCHES["rs"] - before[0]["rs"],
                "a2a": am.LAUNCHES["a2a"] - before[1],
                "tiles": {key: am.TILES[key] - before[2][key] for key in before[2]
                          if am.TILES[key] != before[2][key]}}
    if integer:
        ok_a2a = torch.equal(got_a2a, want_a2a)
    elif dtype == torch.float32:
        ok_a2a = bool(((got_a2a - want_a2a).abs() <= 1e-5 * k).all())
    else:
        ok_a2a = True
        for e in range(d):
            rows = slice(e * g, (e + 1) * g)
            mine = shards[rank][rows]
            bound = k1.plain_gap_bound(mine, experts[e], got_a2a[rows], want_a2a[rows])
            ok_a2a &= bool(((got_a2a[rows].float() - want_a2a[rows].float()).abs()
                            <= bound).all())
    return torch.equal(got_ag, want_ag), torch.equal(got_rs, want_rs), ok_a2a, launches


@pytest.mark.cuda
def test_ring_kernels_over_nccl_match_plain_on_four_cards(cuda_device):
    """K2 and K3, then K4, K5 and K6, on four cards (one process each, peer
    memory from symmetric memory over NVLink), three calls on one ring,
    against their plain versions over NCCL (``batch_isend_irecv`` hops):
    bit for bit on integer operands (K4 and K5 on any), else within the
    bounds of the loopback tests; exactly one launch of each kernel a
    call, K2, K3 and K6 on the Hopper tile for bf16 (SIMT for float32)."""
    import multiprocessing as mp
    import queue
    import socket

    if torch.cuda.device_count() < NCCL_WORLD:
        pytest.skip(f"needs {NCCL_WORLD} cards, {torch.cuda.device_count()} visible")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_nccl_rank_main, args=(r, port, results), daemon=True)
             for r in range(NCCL_WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(NCCL_WORLD):
            rank, status, payload = results.get(timeout=NCCL_DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {NCCL_WORLD}-card world did not finish in {NCCL_DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    for rank, (cases, trio) in got.items():
        assert len(cases) == len(trio) == len(NCCL_SHAPES) * 4
        for case, ok_ag, ok_rs, launches in cases:
            # every 16-bit shape here has TMA's widths (K3's k/d too): K2 and
            # K3 ran the Hopper tile
            tile = "simt" if "float32" in case[3] else "wgmma"
            assert ok_ag and ok_rs, (rank, case, ok_ag, ok_rs)
            assert launches == {"ag": NCCL_CALLS, "rs": NCCL_CALLS,
                                "tiles": {tile: NCCL_CALLS},
                                "rs_tiles": {tile: NCCL_CALLS}}, (rank, case, launches)
        for case, ok_k4, ok_k5, ok_k6, launches in trio:
            tile = "simt" if "float32" in case[3] else "wgmma"
            assert ok_k4 and ok_k5 and ok_k6, (rank, case, ok_k4, ok_k5, ok_k6)
            assert launches == {**dict.fromkeys(("ag", "rs", "a2a"), NCCL_CALLS),
                                "tiles": {tile: NCCL_CALLS}}, (rank, case, launches)


# -- the LM head's float32 product on the tensor cores ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 256, 512), (1, 8, 2048, 16384)])
def test_head_product_matches_the_float32_product(cuda_device, shape):
    """``ops.accum.float32_product`` (``mm.dtype`` on bf16 operands) against
    ``torch.matmul(h.float(), head.float())``, the product it replaces, and
    its gradients against autograd of that product: both sum exact bf16
    products in float32 in other orders, so they differ by at most
    ``2 * k * 2**-23 * (|h| @ |head|)`` (the gradients by the same rule
    over their own contraction, plus one rounding to bf16)."""
    from ddlb_tpu_torch.ops.accum import float32_product

    b, s, dm, vocab = shape
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    h = _uniform((b, s, dm), torch.bfloat16, gen, cuda_device).requires_grad_(True)
    w = _uniform((dm, vocab), torch.bfloat16, gen, cuda_device).requires_grad_(True)
    g = torch.rand((b, s, vocab), generator=gen, device=cuda_device) - 0.5
    got = float32_product(h, w)
    want = torch.matmul(h.float(), w.float())
    assert got.dtype == torch.float32 and got.shape == want.shape
    mag = h.detach().float().abs() @ w.detach().float().abs()
    assert bool(((got - want).abs() <= 2 * dm * 2.0**-23 * mag).all())
    gh, gw = torch.autograd.grad((got * g).sum(), (h, w))
    wh, ww = torch.autograd.grad((want * g).sum(), (h, w))
    assert gh.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16
    for got_g, want_g, bound in (
        (gh, wh, 2 * vocab * 2.0**-23 * (g.abs() @ w.detach().float().abs().t())),
        (gw, ww, 2 * b * s * 2.0**-23 * (h.detach().float().abs().reshape(-1, dm).t()
                                         @ g.abs().reshape(-1, vocab))),
    ):
        spacing = torch.exp2(torch.floor(torch.log2(
            want_g.float().abs().clamp_min(1e-30)))) * 2.0**-7
        assert bool(((got_g.float() - want_g.float()).abs() <= bound + spacing).all())
