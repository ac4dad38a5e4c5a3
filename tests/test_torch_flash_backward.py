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
themselves run only on the card (``test_torch_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlb_tpu.ops import flash_attention as jfa
from ddlb_tpu_torch.ops import flash_attention as fa

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
        ("rect", torch.bfloat16, "mma"),
        ("rect", torch.float16, "mma"),
        ("rect", torch.float32, "simt"),
    ],
)
def test_backward_kernel_choice(case, dtype, kernel):
    """The triangle in bf16/fp16 takes the Hopper wgmma passes; the
    rectangle stays on flash_bwd_*_mma (the forward's band kernel has no
    backward); float32 on the SIMT kernels."""
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
