"""The flash kernels' plain versions against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

``flash_forward_plain`` (K8a/K8b) is held against ``_flash_forward`` (the
triangular grid at offset 0, the rectangular one otherwise) and
``flash_chunk_plain`` (K9) against ``flash_attention_chunk``, on the same
numpy-seeded float32 inputs at tiny shapes with blocks of 16 on both
sides. Tolerance: rtol = atol = 1e-5, since both sides run the same
float32 online-softmax recurrence over the same tiles and differ only in
the order of float32 sums; rows with nothing live must be exactly 0
(output) and exactly NEG_INF (lse) on both.

The kernels themselves run only on the card (``test_torch_card.py``); here
the wrapper's dispatch, the live-band arithmetic and the rule that only a
CPU tensor takes the plain version are checked too.
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

#: id -> (sq, skv, h, h_kv, row_offset, causal, window)
FORWARD_CASES = {
    "triangle": (64, 64, 2, 2, 0, True, 0),
    "offset": (32, 64, 2, 2, 32, True, 0),
    "window": (64, 64, 2, 2, 0, True, 24),
    "gqa_offset_window": (32, 64, 4, 1, 32, True, 20),
    "not_causal": (32, 48, 2, 2, 0, False, 0),
    "empty_band_rows": (32, 32, 2, 2, 60, True, 40),
}

#: id -> (sq, skv, h, h_kv, row_offset, col_offset, mode, window)
CHUNK_CASES = {
    "diagonal": (32, 32, 2, 2, 64, 64, "diagonal", 0),
    "past": (32, 32, 4, 2, 64, 32, "past", 0),
    "offset_window": (32, 48, 2, 2, 40, 16, "offset", 20),
    "diagonal_window_gqa": (32, 32, 4, 2, 32, 32, "diagonal", 12),
}


def _qkv(sq, skv, h, h_kv, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(-1, 1, (sq, h, DH)).astype(np.float32),
        rng.uniform(-1, 1, (skv, h_kv, DH)).astype(np.float32),
        rng.uniform(-1, 1, (skv, h_kv, DH)).astype(np.float32),
    )


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("case", list(FORWARD_CASES), ids=str)
def test_forward_plain_matches_pallas(case):
    sq, skv, h, h_kv, off, causal, window = FORWARD_CASES[case]
    q, k, v = _qkv(sq, skv, h, h_kv, seed=len(case))
    o_ref, lse_ref = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), off, DH**-0.5,
        BLOCK, BLOCK, True, causal, window,
    )
    o, lse = fa.flash_forward_plain(
        *_torch(q, k, v), scale=DH**-0.5, row_offset=off, causal=causal,
        window=window, block_q=BLOCK, block_kv=BLOCK,
    )
    assert o.shape == (sq, h, DH) and lse.shape == (h, sq, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)
    empty = np.asarray(lse_ref) == fa.NEG_INF
    if case == "empty_band_rows":
        assert empty.any() and not empty.all()
    np.testing.assert_array_equal(lse.numpy() == fa.NEG_INF, empty)
    assert not o.numpy()[np.moveaxis(empty[..., 0], 0, 1)].any()


@pytest.mark.parametrize("case", list(CHUNK_CASES), ids=str)
def test_chunk_plain_matches_pallas(case):
    sq, skv, h, h_kv, row_off, col_off, mode, window = CHUNK_CASES[case]
    q, k, v = _qkv(sq, skv, h, h_kv, seed=10 + len(case))
    kw = dict(scale=DH**-0.5, row_offset=row_off, col_offset=col_off,
              block_q=BLOCK, block_kv=BLOCK, causal=mode, window=window)
    # two folds of the same chunk: the second reads a carry that is not
    # the initial one
    ref = jfa.init_flash_carry(sq, h, DH)
    got = fa.init_flash_carry(sq, h, DH)
    for _ in range(2):
        ref = jfa.flash_attention_chunk(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ref,
            interpret=True, **kw,
        )
        got = fa.flash_chunk_plain(*_torch(q, k, v), got, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(
        fa.finalize_flash_carry(got, torch.float32).numpy(),
        np.asarray(jfa.finalize_flash_carry(ref, jnp.float32)), **TOL,
    )


def test_public_forward_on_cpu_is_the_plain_version():
    """``flash_attention`` on CPU tensors equals ``flash_forward_plain``,
    and matches the JAX ``flash_attention`` (which collapses a window
    covering the whole sequence to the triangle)."""
    q, k, v = _qkv(48, 48, 2, 2, seed=3)
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=DH**-0.5,
        block_q=BLOCK, block_kv=BLOCK, interpret=True, window=64,
    )
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(*_torch(q, k, v), scale=DH**-0.5, window=64)
    assert fa.LAUNCHES == before  # plain calls are not launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "sq,skv,off,causal,window,case",
    [
        (64, 64, 0, True, 0, ("tri", 0)),
        (64, 64, 0, True, 64, ("tri", 0)),    # the band covers everything
        (64, 64, 0, True, 63, ("rect", 63)),
        (64, 64, 32, True, 0, ("rect", 0)),
        (32, 64, 0, True, 0, ("rect", 0)),
        (64, 64, 0, False, 0, ("rect", 0)),
        (64, 64, 64, True, 200, ("rect", 200)),  # only at offset 0
    ],
)
def test_forward_dispatch_rule(sq, skv, off, causal, window, case):
    assert fa.forward_case(sq, skv, off, causal, window) == case


@pytest.mark.parametrize(
    "sq,skv,row,col,causal,window",
    [(37, 53, 0, 0, True, 0), (37, 53, 20, 5, True, 9), (16, 16, 100, 0, True, 30),
     (20, 31, 0, 0, False, 0), (20, 31, 50, 60, True, 0)],
)
def test_live_pairs_counts_the_mask(sq, skv, row, col, causal, window):
    mask = fa._mask(row, col, sq, skv, causal, window, "cpu")
    assert fa.live_pairs(sq, skv, row, col, causal, window) == int(mask.sum())


@pytest.mark.parametrize("window", [0, 5, 16, 40])
def test_ring_chunk_live_matches_jax(window):
    for my in range(4):
        for src in range(4):
            want = bool(jfa._ring_chunk_live(src, my, 16, window))
            assert fa.ring_chunk_live(src, my, 16, window) == want


@pytest.mark.parametrize(
    "q_start,k_start,causal,window",
    [(0, 0, True, 0), (0, 16, True, 0), (15, 16, True, 0), (64, 16, True, 30),
     (64, 40, True, 30), (0, 48, False, 0)],
)
def test_band_live_matches_jax(q_start, k_start, causal, window):
    want = jfa._band_live(q_start, k_start, 16, 16, causal, window)
    assert fa.band_live(q_start, k_start, 16, 16, causal, window) == bool(want)


def test_bound_refuses_a_dropped_key():
    """``plain_gap_bound`` is tight enough to refuse an output that lost
    one live key, as a kernel with a wrong band would."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.rand(s, generator=gen) * 2 - 1 for s in
               ((128, 2, 64), (128, 2, 64), (128, 2, 64)))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want, _ = fa.flash_forward_plain(q, k, v, scale=0.125)
    k_cut, v_cut = k.clone(), v.clone()
    k_cut[100], v_cut[100] = -1e4, 0.0  # key 100 gets no weight
    bad, _ = fa.flash_forward_plain(q, k_cut, v_cut, scale=0.125)
    bound = fa.plain_gap_bound(q, k, v, bad, want, scale=0.125, n_terms=128)
    assert bool(((bad.float() - want.float()).abs() > bound).any())
    same = fa.plain_gap_bound(q, k, v, want, want, scale=0.125, n_terms=128)
    assert bool((same > 0).all())


def test_bound_refuses_a_short_causal_edge_on_a_long_peaked_band():
    """At 2048 keys a causal edge one key short (each query loses its own
    key) is refused on every row of peaked inputs (q = 4 * k: the own key
    dominates the softmax, so |o| stays near max|v|), while on uniform
    inputs late rows average so many keys that the loss hides below the
    bound: the card checks hold the kernels on both."""
    gen = torch.Generator().manual_seed(1)
    s, h, dh = 2048, 2, 128
    k, v, q_uniform = (
        (torch.rand((s, h, dh), generator=gen) * 2 - 1).bfloat16()
        for _ in range(3)
    )
    refused = {}
    for name, q in (("peaked", 4 * k), ("uniform", q_uniform)):
        want, _ = fa.flash_forward_plain(q, k, v, scale=dh**-0.5)
        short, _ = fa.flash_forward_plain(q, k, v, scale=dh**-0.5, row_offset=-1)
        bound = fa.plain_gap_bound(q, k, v, short, want, scale=dh**-0.5,
                                   n_terms=s)
        refused[name] = ((short.float() - want.float()).abs() > bound).any(-1)
    assert bool(refused["peaked"].all())
    assert not bool(refused["uniform"].all())


def test_non_cpu_tensors_never_take_the_plain_version():
    q = torch.empty((64, 2, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_chunk(
            q, q, q, fa.init_flash_carry(64, 2, 128, "meta"), scale=1.0,
            row_offset=0, col_offset=0,
        )


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(window=-1), "window must be >= 0"),
        (dict(window=4, causal=False), "requires causal"),
    ],
)
def test_forward_rejections(kwargs, match):
    q = torch.zeros((16, 2, DH))
    with pytest.raises(ValueError, match=match):
        fa.flash_forward(q, q, q, scale=1.0, **kwargs)


def test_chunk_rejections():
    q = torch.zeros((16, 2, DH))
    carry = fa.init_flash_carry(16, 2, DH)
    kw = dict(scale=1.0, row_offset=0, col_offset=0)
    with pytest.raises(ValueError, match="unknown causal mode"):
        fa.flash_attention_chunk(q, q, q, carry, causal="future", **kw)
    with pytest.raises(ValueError, match="window composes"):
        fa.flash_attention_chunk(q, q, q, carry, causal="past", window=4, **kw)
    with pytest.raises(ValueError, match="carry must be"):
        fa.flash_attention_chunk(q, q, q, fa.init_flash_carry(8, 2, DH), **kw)
    with pytest.raises(ValueError, match="not divisible by n_kv_heads"):
        fa.flash_attention_chunk(
            torch.zeros((16, 3, DH)), q, q, fa.init_flash_carry(16, 3, DH), **kw
        )
