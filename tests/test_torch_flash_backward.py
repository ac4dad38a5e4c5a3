"""The flash backward's plain version and the differentiable flash
attention against the JAX package, on the CPU.

``flash_backward_plain`` (K10a-K10d's plain version) is held against
``flash_attention_bwd`` run in interpret mode, in every causal mode, with
windows, GQA groups of 1, 2 and 4 and nonzero offsets, in float32 and
bfloat16, on numpy-seeded inputs with blocks of 16 on both sides: both
run the same float32 tile recurrence and differ only in the order of
float32 sums, so float32 agrees within rtol = atol = 1e-5, and bfloat16
operands (upcast to float32 on both sides) within the same. The triangle
is also held at the Hopper kernels' tile split (128 x 128 for dQ, 128 keys
x 64 queries for dK/dV), ragged and GQA 4/2, with the JAX side on blocks
that divide the length. The
autograd Function behind ``flash_attention`` and ``ring_flash_attention``
is held against autograd of plain float32 einsum attention (atol 1e-5),
and per-chunk backward calls against the whole-span call, as
``tests/test_flash_grad.py`` does for the JAX package. The kernels
themselves run only on the card (``test_torch_card.py``); here the host
side of a launch runs against a stand-in library, and a line-for-line
Python transcription of the Hopper passes' walk over the band is held
against the brute-force mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlb_tpu.ops import flash_attention as jfa
from ddlb_tpu_torch.ops import flash_attention as fa
from torch_parity import install_fake_flash_lib

BLOCK = 16
DH = 16
TOL = dict(rtol=1e-5, atol=1e-5)

#: id -> (sq, skv, h, h_kv, row_offset, col_offset, mode, window)
CASES = {
    "triangle": (64, 64, 2, 2, 0, 0, "offset", 0),
    "offset_gqa2": (32, 64, 4, 2, 32, 0, "offset", 0),
    "window": (64, 64, 2, 2, 0, 0, "offset", 24),
    "offset_window_gqa4": (32, 48, 4, 1, 40, 16, "offset", 20),
    "diagonal": (32, 32, 2, 2, 32, 32, "diagonal", 0),
    "diagonal_gqa2": (32, 32, 4, 2, 64, 64, "diagonal", 0),
    "past_gqa4": (32, 32, 4, 1, 64, 32, "past", 0),
    "none": (32, 48, 2, 2, 0, 0, "none", 0),
    "empty_band_rows": (32, 32, 2, 2, 60, 0, "offset", 20),
    # the triangle at the Hopper kernels' tile split (SPLITS)
    "ragged_triangle_64x128": (200, 200, 2, 2, 0, 0, "offset", 0),
    "ragged_triangle_128x128": (200, 200, 2, 2, 0, 0, "offset", 0),
    "gqa2_triangle_64x128": (192, 192, 4, 2, 0, 0, "offset", 0),
    "gqa2_triangle_128x128": (192, 192, 4, 2, 0, 0, "offset", 0),
}
#: id -> (the JAX side's block, the plain version's block_q, block_kv);
#: the other cases take BLOCK on both sides
SPLITS = {
    "ragged_triangle_64x128": (40, 64, 128),
    "ragged_triangle_128x128": (40, 128, 128),
    "gqa2_triangle_64x128": (32, 64, 128),
    "gqa2_triangle_128x128": (32, 128, 128),
}


def _inputs(sq, skv, h, h_kv, seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(-1, 1, shape).astype(np.float32)
              for shape in ((sq, h, DH), (skv, h_kv, DH), (skv, h_kv, DH), (sq, h, DH))]
    if dtype == "bfloat16":  # both sides see the same rounded values
        arrays = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]
    return arrays


def _forward_for(q, k, v, ro, co, mode, window, block=BLOCK):
    """The JAX forward's (o, lse) over this span, as the backward takes
    them: relative offsets, or no mask for past and none."""
    if mode in ("past", "none"):
        off, causal = 0, False
    else:
        off, causal = (0 if mode == "diagonal" else ro - co), True
    return jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), off,
                              DH**-0.5, block, block, True, causal, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_backward_plain_matches_pallas(case, dtype):
    sq, skv, h, h_kv, ro, co, mode, window = CASES[case]
    jax_block, block_q, block_kv = SPLITS.get(case, (BLOCK, BLOCK, BLOCK))
    q, k, v, do = _inputs(sq, skv, h, h_kv, len(case), dtype)
    o, lse = _forward_for(q, k, v, ro, co, mode, window, jax_block)
    want = jfa.flash_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do),
        scale=DH**-0.5, row_offset=ro, col_offset=co, block_q=jax_block,
        block_kv=jax_block, interpret=True, causal=mode, window=window,
    )
    tq, tk, tv, to, tl, tdo = (torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do))
    if dtype == "bfloat16":
        tq, tk, tv, tdo = (x.bfloat16() for x in (tq, tk, tv, tdo))
    before, tiles = dict(fa.LAUNCHES), dict(fa.BACKWARD_TILES)
    got = fa.flash_backward(tq, tk, tv, to, tl, tdo, scale=DH**-0.5, row_offset=ro,
                            col_offset=co, causal=mode, window=window)
    # a CPU tensor takes the plain version
    assert fa.LAUNCHES == before and fa.BACKWARD_TILES == tiles
    plain = fa.flash_backward_plain(tq, tk, tv, to, tl, tdo, scale=DH**-0.5,
                                    row_offset=ro, col_offset=co, causal=mode,
                                    window=window, block_q=block_q, block_kv=block_kv)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize(
    "sq,skv,ro,co,mode,window",
    [(64, 64, 0, 0, "offset", 0), (40, 64, 50, 10, "offset", 0),
     (64, 64, 0, 0, "diagonal", 0), (32, 32, 64, 32, "past", 0),
     (64, 64, 0, 0, "none", 0), (48, 64, 30, 0, "offset", 20)],
)
def test_backward_case_follows_the_dispatch_rule(sq, skv, ro, co, mode, window):
    """The triangle exactly where ``flash_attention_bwd`` takes its
    triangular grids (:839-849)."""
    case, r, c = fa.backward_case(sq, skv, ro, co, mode, window)
    tri = ((mode == "diagonal" and sq == skv)
           or (mode == "offset" and not window and ro == co == 0 and sq == skv))
    assert case == ("tri" if tri else "rect")
    if mode == "diagonal" and sq == skv:
        assert (r, c) == (0, 0)


@pytest.mark.parametrize(
    "case,dtype,kernel",
    [
        ("tri", torch.bfloat16, "wgmma"),
        ("tri", torch.float16, "wgmma"),
        ("tri", torch.float32, "simt"),
        ("rect", torch.bfloat16, "band"),
        ("rect", torch.float16, "band"),
        ("rect", torch.float32, "simt"),
    ],
)
def test_backward_kernel_choice(case, dtype, kernel):
    """In bf16/fp16 the triangle takes the Hopper wgmma passes (tri_bwd)
    and the rectangle the Hopper band passes (band_bwd); float32 the SIMT
    kernels."""
    assert fa.backward_kernel(case, dtype) == kernel


@pytest.mark.parametrize("dtype", [torch.int8, torch.float64])
def test_backward_kernel_rejects_other_dtypes(dtype):
    with pytest.raises(ValueError, match="flash kernels take"):
        fa.backward_kernel("tri", dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("case", ["triangle", "window", "diagonal", "past_gqa4"])
def test_cpu_backward_counts_no_kernel(case, dtype):
    """A CPU tensor takes the plain version whatever kernel its case would
    run on the card: no launch by case and none by kernel."""
    sq, skv, h, h_kv, ro, co, mode, window = CASES[case]
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(sq, skv, h, h_kv, 13, "float32"))
    o, lse = fa.flash_forward_plain(q, k, v, scale=DH**-0.5, causal=mode != "past")
    kw = dict(scale=DH**-0.5, row_offset=ro, col_offset=co, causal=mode, window=window)
    before, tiles = dict(fa.LAUNCHES), dict(fa.BACKWARD_TILES)
    got = fa.flash_backward(q, k, v, o, lse, do, **kw)
    assert fa.LAUNCHES == before and fa.BACKWARD_TILES == tiles
    for g, w in zip(got, fa.flash_backward_plain(q, k, v, o, lse, do, **kw)):
        assert torch.equal(g, w)


def test_reset_launches_zeroes_the_backward_counts():
    fa.BACKWARD_TILES["wgmma"] += 2
    fa.LAUNCHES["bwd_dq_tri"] += 1
    fa.reset_launches()
    assert not any(fa.BACKWARD_TILES.values()) and not any(fa.LAUNCHES.values())


def _einsum_attention(q, k, v, scale, row_offset=0, window=0):
    """Plain float32 causal attention, ``[s, h, dh]``, GQA repeated."""
    group = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(group, 1) for x in (k, v))
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    rows = row_offset + torch.arange(q.shape[0])[:, None]
    cols = torch.arange(k.shape[0])[None, :]
    mask = rows >= cols
    if window:
        mask &= cols > rows - window
    p = torch.softmax(s.masked_fill(~mask, fa.NEG_INF), -1)
    return torch.einsum("hqk,khd->qhd", p, v)


@pytest.mark.parametrize(
    "sq,skv,h,h_kv,row_offset,window",
    [(32, 32, 2, 2, 0, 0), (16, 64, 4, 2, 48, 0), (40, 40, 4, 1, 0, 12),
     (24, 48, 2, 2, 24, 10)],
)
def test_flash_attention_grads_match_autodiff(sq, skv, h, h_kv, row_offset, window):
    """The autograd Function (forward plus the flash backward) against
    autograd of the einsum formulation at float32 / 1e-5."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(sq, skv, h, h_kv, 3, "float32"))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, scale=DH**-0.5, row_offset=row_offset,
                             window=window)
    grads = torch.autograd.grad((out * w).sum(), leaves)
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_ref = _einsum_attention(*ref, DH**-0.5, row_offset, window)
    want = torch.autograd.grad((o_ref * w).sum(), ref)
    torch.testing.assert_close(out, o_ref, rtol=0, atol=1e-5)
    for g, r in zip(grads, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def test_backward_chunks_compose():
    """Per-chunk backward calls with the global lse sum to the whole-span
    backward (``tests/test_flash_grad.py:70``): the property the ring's
    backward rests on."""
    sq, h, d = 64, 2, 4
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(sq, sq, h, h, 5, "float32"))
    o, lse = fa.flash_forward_plain(q, k, v, scale=DH**-0.5, block_q=8, block_kv=8)
    full = fa.flash_backward_plain(q, k, v, o, lse, do, scale=DH**-0.5,
                                   block_q=8, block_kv=8)
    s_c = sq // d
    dq = torch.zeros_like(full[0])
    dks, dvs = [], []
    for c in range(d):
        rows = slice(c * s_c, (c + 1) * s_c)
        dq_c, dk_c, dv_c = fa.flash_backward_plain(
            q, k[rows], v[rows], o, lse, do, scale=DH**-0.5, col_offset=c * s_c,
            block_q=8, block_kv=8,
        )
        dq += dq_c
        dks.append(dk_c)
        dvs.append(dv_c)
    torch.testing.assert_close(dq, full[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.cat(dks), full[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.cat(dvs), full[2], rtol=0, atol=1e-5)


def test_ring_flash_at_one_rank_is_flash_attention():
    """On a ring of one the ring Function is the diagonal chunk: the same
    output and gradients as ``flash_attention``."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(48, 48, 4, 2, 9, "float32"))
    outs = []
    for fn in (
        lambda a, b, c: fa.flash_attention(a, b, c, scale=DH**-0.5),
        lambda a, b, c: fa.ring_flash_attention(
            a, b, c, shift=lambda *ts: ts, axis_size=1, axis_index=0, scale=DH**-0.5),
    ):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        outs.append((out, *torch.autograd.grad((out * w).sum(), leaves)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_backward_rejects_what_it_does_not_take():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(16, 16, 2, 2, 1, "float32"))
    o, lse = fa.flash_forward_plain(q, k, v, scale=1.0)
    with pytest.raises(ValueError, match="unknown causal mode"):
        fa.flash_backward(q, k, v, o, lse, do, scale=1.0, causal="future")
    with pytest.raises(ValueError, match="window composes with causal='offset'"):
        fa.flash_backward(q, k, v, o, lse, do, scale=1.0, causal="past", window=4)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_backward(q, k, v, o, lse[:, :8], do, scale=1.0)


# -- the host side of a launch, through a stand-in library ---------------------


@pytest.fixture
def fake_lib(monkeypatch):
    """``backward_pass`` on CPU tensors through a stand-in library, every
    count zeroed before and after."""
    yield install_fake_flash_lib(
        monkeypatch, fa, ("ddlb_flash_bwd_dq", "ddlb_flash_bwd_dkv", "ddlb_flash_bwd_dq_tri",
                          "ddlb_flash_bwd_dkv_tri", "ddlb_flash_bwd_dq_band",
                          "ddlb_flash_bwd_dkv_band"))
    fa.reset_launches()


def _pass_operands(sq, skv, h, h_kv, dtype):
    q, do = torch.zeros((sq, h, 128), dtype=dtype), torch.ones((sq, h, 128), dtype=dtype)
    k, v = torch.zeros((skv, h_kv, 128), dtype=dtype), torch.ones((skv, h_kv, 128), dtype=dtype)
    lse, delta = torch.zeros((h, sq, 1)), torch.zeros((h, sq, 1))
    return q, k, v, do, lse, delta


#: (sq, skv, h, h_kv, row_offset, col_offset, mode, window, dtype, entry
#: suffix, case, kernel, the offsets and masked flag passed)
BACKWARD_LAUNCHES = [
    (256, 256, 8, 2, 0, 0, "offset", 0, torch.bfloat16, "_tri", "tri", "wgmma", None),
    (256, 256, 4, 4, 512, 512, "diagonal", 0, torch.float16, "_tri", "tri", "wgmma", None),
    (512, 512, 4, 4, 0, 0, "offset", 100, torch.bfloat16, "_band", "rect", "band", (0, 0, 1)),
    (777, 1500, 4, 2, 723, 0, "offset", 300, torch.float16, "_band", "rect", "band",
     (723, 0, 1)),
    (256, 256, 8, 8, 512, 0, "past", 0, torch.bfloat16, "_band", "rect", "band", (512, 0, 0)),
    (300, 500, 4, 4, 0, 0, "none", 0, torch.bfloat16, "_band", "rect", "band", (0, 0, 0)),
    (384, 512, 4, 4, 192, 0, "offset", 0, torch.bfloat16, "_band", "rect", "band",
     (192, 0, 1)),
    (200, 300, 4, 2, 900, 500, "diagonal", 0, torch.bfloat16, "_band", "rect", "band",
     (900, 500, 1)),
    (700, 900, 4, 2, 650, 100, "offset", 200, torch.float32, "", "rect", "simt",
     (650, 100, 1)),
    (128, 128, 2, 2, 256, 128, "past", 0, torch.float32, "", "rect", "simt", (256, 128, 0)),
]


@pytest.mark.parametrize("case", BACKWARD_LAUNCHES)
@pytest.mark.parametrize("name", ["dq", "dkv"])
def test_backward_launch_passes_the_band(fake_lib, case, name):
    """One backward pass: the entry point of the kernel ``backward_kernel``
    names (``_tri`` for the triangle and ``_band`` for the rectangle in
    bf16/fp16, the float32 one otherwise) with the operands' and the
    outputs' own pointers, the shapes, the scale, the offsets (a square
    diagonal chunk at 0), the masked flag (0 for past and none) and the
    window; counted once by case and once by kernel."""
    sq, skv, h, h_kv, ro, co, mode, window, dtype, suffix, case_name, kernel, passed = case
    q, k, v, do, lse, delta = _pass_operands(sq, skv, h, h_kv, dtype)
    out = ((torch.empty((sq, h, 128)),) if name == "dq"
           else (torch.empty((skv, h_kv, 128)), torch.empty((skv, h_kv, 128))))
    fa.backward_pass(name, q, k, v, do, lse, delta, out, scale=0.5, row_offset=ro,
                     col_offset=co, causal=mode, window=window)
    head = (fa._DTYPE_CODES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in out))
    if kernel == "wgmma":
        want = head + (sq, h, h_kv, 128, 0.5, 7)
    else:
        want = head + (sq, skv, h, h_kv, 128, 0.5, *passed, window, 7)
    assert fake_lib.calls == [(f"ddlb_flash_bwd_{name}{suffix}", want)]
    assert fa.LAUNCHES == dict(dict.fromkeys(fa.LAUNCHES, 0), **{f"bwd_{name}_{case_name}": 1})
    assert fa.BACKWARD_TILES == dict(dict.fromkeys(fa.BACKWARD_TILES, 0), **{kernel: 1})


@pytest.mark.parametrize("name", ["dq", "dkv"])
def test_a_refused_band_backward_raises(fake_lib, name):
    """A pass the library refuses raises, naming the kernel, after one
    call: nothing retries it on another kernel or on the plain version."""
    fake_lib.rc = 1
    q, k, v, do, lse, delta = _pass_operands(200, 300, 4, 2, torch.bfloat16)
    out = ((torch.empty((200, 4, 128)),) if name == "dq"
           else (torch.empty((300, 2, 128)), torch.empty((300, 2, 128))))
    with pytest.raises(RuntimeError, match=r"\(rect, band\) launch failed: refused"):
        fa.backward_pass(name, q, k, v, do, lse, delta, out, scale=0.5, row_offset=100,
                         col_offset=0, causal="offset", window=50)
    assert len(fake_lib.calls) == 1
    assert fa.BACKWARD_TILES == dict(dict.fromkeys(fa.BACKWARD_TILES, 0), band=1)


# -- the band passes' walk, transcribed ------------------------------------------
#
# band_bwd in csrc/flash_attention.cu line for line: a dQ block (128 query
# rows) streams the 128-key tiles of key_range and each consumer warpgroup
# (64 rows) runs the 64-key halves its rows reach; a dK/dV block (128 keys)
# streams the 64-row query steps of query_range and each warpgroup (64
# keys) skips the steps its keys do not reach. A step is masked when it
# holds a dead pair, keys past skv (dQ) or rows past sq (dK/dV).

ROWS, HALF, Q_STEP = 128, 64, 64


def _key_range(b, qa, qb):
    sq, skv, q_base, k_base, causal, window = b
    lo = max(0, q_base + qa - window + 1 - k_base) if window else 0
    hi = min(skv, q_base + qb - k_base) if causal else skv
    return (0, 0) if qb <= qa or hi <= lo else (lo, hi)


def _query_range(b, ka, kb):
    sq, skv, q_base, k_base, causal, window = b
    lo = max(0, k_base + ka - q_base) if causal else 0
    hi = min(sq, k_base + kb - 1 + window - q_base) if window else sq
    return (0, 0) if kb <= ka or hi <= lo else (lo, hi)


def _steps_of(n, lo, hi):
    first = lo // n
    return first, ((hi + n - 1) // n if hi > lo else first)


def _has_dead(b, qa, qb, ka, kb):
    sq, skv, q_base, k_base, causal, window = b
    return bool((causal and k_base + kb - 1 > q_base + qa)
                or (window and k_base + ka <= q_base + qb - 1 - window))


def _dq_walk(b):
    """For each block: its rows, the key tiles [first, last) it issues, and
    the (rows, keys, masked) steps its consumers run."""
    sq, skv = b[:2]
    for qt in range(-(-sq // ROWS)):
        q0 = qt * ROWS
        first, last = _steps_of(ROWS, *_key_range(b, q0, min(q0 + ROWS, sq)))
        steps = []
        for c in range(2):
            ra = q0 + HALF * c
            wf, wl = _steps_of(HALF, *_key_range(b, ra, min(ra + HALF, sq)))
            for kt in range(last - 1, first - 1, -1):
                for h2 in range(max(wf - 2 * kt, 0), min(wl - 2 * kt, 2)):
                    ka = kt * ROWS + HALF * h2
                    masked = ka + HALF > skv or _has_dead(b, ra, min(ra + HALF, sq), ka,
                                                         ka + HALF)
                    steps.append(((ra, min(ra + HALF, sq)), (ka, min(ka + HALF, skv)), masked))
        yield (q0, min(q0 + ROWS, sq)), (first, last), steps


def _dkv_walk(b):
    """For each block: its keys, the query steps [first, last) it issues
    (for each query head of the group), and the (rows, keys, masked) steps
    its consumers run."""
    sq, skv = b[:2]
    for kt in range(-(-skv // ROWS)):
        k0 = kt * ROWS
        first, last = _steps_of(Q_STEP, *_query_range(b, k0, min(k0 + ROWS, skv)))
        steps = []
        for c in range(2):
            kb = k0 + HALF * c
            ke = min(kb + HALF, skv)
            q_lo, q_hi = _query_range(b, kb, ke)
            for step in range(first, last):
                q0 = step * Q_STEP
                if q0 + Q_STEP <= q_lo or q0 >= q_hi:
                    continue
                masked = q0 + Q_STEP > sq or _has_dead(b, q0, q0 + Q_STEP, kb, ke)
                steps.append(((q0, min(q0 + Q_STEP, sq)), (kb, ke), masked))
        yield (k0, min(k0 + ROWS, skv)), (first, last), steps


#: (sq, skv, row_offset, col_offset, mode, window): offsets that put the
#: causal and window edges at every phase of the tiles, ragged lengths,
#: rows and keys with an empty band, the unmasked modes
WALK_CASES = [
    (256, 256, 0, 0, "offset", 0), (300, 300, 0, 0, "offset", 0),
    (384, 512, 192, 0, "offset", 0), (200, 700, 450, 0, "offset", 0),
    (512, 1100, 576, 0, "offset", 200), (777, 1500, 723, 0, "offset", 300),
    (256, 1024, 1000, 0, "offset", 100), (64, 256, 2048, 0, "offset", 300),
    (320, 320, 0, 0, "offset", 100), (1000, 1000, 0, 0, "offset", 256),
    (300, 1000, 128, 700, "offset", 0), (100, 300, 150, 20, "offset", 0),
    (64, 64, 100, 0, "offset", 60), (200, 300, 900, 500, "diagonal", 0),
    (500, 300, 0, 600, "offset", 0), (129, 77, 40, 0, "offset", 1),
    (2048, 2048, 2048, 0, "past", 0), (130, 70, 0, 0, "none", 0),
    (300, 500, 0, 0, "none", 0), (257, 383, 300, 44, "offset", 37),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_band_walk_visits_the_live_pairs_once(case):
    """The dQ walk and the dK/dV walk each visit every live pair of the
    brute-force mask (``_mask`` over the rectangle) exactly once; every
    step that holds a dead pair runs the masked pass; a block whose band
    is empty issues no tile; and every tile issued and every step run
    holds a live pair (the walk covers the band, not the rectangle)."""
    sq, skv, ro, co, mode, window = case
    _, ro, co = fa.backward_case(sq, skv, ro, co, mode, window)
    masked = mode not in ("past", "none")
    b = (sq, skv, ro, co, int(masked), window)
    live = fa._mask(ro, co, sq, skv, masked, window, "cpu").numpy()
    for walk, unit in ((_dq_walk, ROWS), (_dkv_walk, Q_STEP)):
        name = walk.__name__
        visits = np.zeros((sq, skv), np.int64)
        for (lo, hi), (first, last), steps in walk(b):
            band = live[lo:hi] if walk is _dq_walk else live[:, lo:hi].T
            assert (last == first) == (not band.any()), (name, lo)
            for t in range(first, last):
                assert band[:, t * unit:(t + 1) * unit].any(), (name, lo, t)
            for (r0, r1), (k0, k1), is_masked in steps:
                assert live[r0:r1, k0:k1].any(), (name, r0, k0)
                assert is_masked or live[r0:r1, k0:k1].all(), (name, r0, k0)
                visits[r0:r1, k0:k1] += 1
        np.testing.assert_array_equal(visits[live], 1, err_msg=name)
