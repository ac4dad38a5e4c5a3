"""The plain versions of K11 and K12 against the JAX package's kernels.

``decode_attention`` and ``paged_decode_attention`` of the JAX package run
in Pallas interpret mode on the CPU; the port's wrappers take their plain
versions on CPU tensors. Both get the same numpy inputs. Cases follow
``tests/test_decode_attention.py``: MHA, GQA, an int8 cache, a window, and
all of them at once, at ragged positions that include 0 and S_max (a
parked lane, every key live), then the paged forms with shuffled pages,
sentinel tails, an all-sentinel row and two slots sharing a page.

Tolerances: float32 at rtol 0, atol 1e-5 (the same float32 math in other
summation orders, as the JAX package's own kernel-vs-einsum test);
bfloat16 within 1 bf16 ulp of the larger magnitude, since both sides
compute in float32 from the same bf16 (or dequantized) operands and round
the output once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddlb_tpu.models.decode import _quantize_kv
from ddlb_tpu.ops.decode_attention import (
    decode_attention as jax_decode,
    paged_decode_attention as jax_paged,
)
from ddlb_tpu_torch.models.decode import quantize_kv
from ddlb_tpu_torch.ops import decode_attention as da
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy
from torch_parity import assert_within_bf16_ulps, to_numpy

B, S, H, DH, PS = 4, 24, 4, 8, 8

CASES = {
    "mha": dict(),
    "gqa": dict(h_kv=2),
    "int8": dict(int8=True),
    "gqa-int8-window": dict(h_kv=2, int8=True, window=6),
    "window": dict(window=5),
    "mqa": dict(h_kv=1),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, case, jdtype):
    """q, the cache (``{k, v[, k_scale, v_scale]}``) as numpy, and
    positions 0, S (parked), and two drawn ones."""
    h_kv = case.get("h_kv", H)
    q = np.asarray(jnp.asarray(rng.normal(0, 1, (B, H, DH)), jdtype))
    k = rng.normal(0, 1, (B, S, h_kv, DH)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, h_kv, DH)).astype(np.float32)
    if case.get("int8"):
        qk, sk = _quantize_kv(jnp.asarray(k))
        qv, sv = _quantize_kv(jnp.asarray(v))
        cache = {"k": qk, "k_scale": sk, "v": qv, "v_scale": sv}
    else:
        cache = {"k": jnp.asarray(k, jdtype), "v": jnp.asarray(v, jdtype)}
    cache = {name: np.asarray(arr) for name, arr in cache.items()}
    pos = np.array([0, S, *rng.integers(1, S, B - 2)], np.int32)
    return q, cache, pos


_t = _tensor_from_numpy


def _assert_close(got, want, dtype):
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=0, atol=1e-5)
    else:
        assert got.dtype == torch.bfloat16
        assert_within_bf16_ulps(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_plain_decode_matches_jax(case, dtype):
    jdtype, _ = DTYPES[dtype]
    opts = CASES[case]
    rng = np.random.default_rng(3)
    q, cache, pos = _inputs(rng, opts, jdtype)
    window = opts.get("window", 0)
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(pos), k_scale=cache.get("k_scale"),
        v_scale=cache.get("v_scale"), window=window, block_s=8, interpret=True,
    )
    before = dict(da.LAUNCHES)
    got = da.decode_attention(
        _t(q), _t(cache["k"]), _t(cache["v"]), torch.from_numpy(pos),
        k_scale=_t(cache["k_scale"]) if "k_scale" in cache else None,
        v_scale=_t(cache["v_scale"]) if "v_scale" in cache else None,
        window=window,
    )
    assert da.LAUNCHES == before  # a CPU tensor launches nothing
    _assert_close(got, want, dtype)


def _page_scatter(cache, rng, pos):
    """The contiguous cache scattered into a pool with a shuffled page
    order and three never-mapped pages; table entries past each
    sequence's page of ``pos`` stay the sentinel (the allocator's shape);
    row 1 maps its first page to row 0's (two slots on one page) and row 2
    is all sentinel."""
    mp = S // PS
    num_pages = B * mp + 3
    perm = rng.permutation(B * mp)
    table = np.full((B, mp), num_pages, np.int32)
    pools = {
        name: np.zeros((num_pages, PS) + arr.shape[2:], arr.dtype)
        for name, arr in cache.items()
    }
    for i in range(B):
        for j in range(mp):
            if j > pos[i] // PS:
                continue
            page = int(perm[i * mp + j])
            table[i, j] = page
            for name, arr in cache.items():
                pools[name][page] = arr[i, j * PS:(j + 1) * PS]
    table[1, 0] = table[0, 0]
    table[2] = num_pages
    return pools, table


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_plain_paged_decode_matches_jax(case, dtype):
    jdtype, _ = DTYPES[dtype]
    opts = CASES[case]
    rng = np.random.default_rng(7)
    q, cache, pos = _inputs(rng, opts, jdtype)
    pools, table = _page_scatter(cache, rng, pos)
    window = opts.get("window", 0)
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
        jnp.asarray(table), jnp.asarray(pos),
        k_scale=pools.get("k_scale"), v_scale=pools.get("v_scale"),
        window=window, interpret=True,
    )
    got = da.paged_decode_attention(
        _t(q), _t(pools["k"]), _t(pools["v"]), torch.from_numpy(table),
        torch.from_numpy(pos),
        k_scale=_t(pools["k_scale"]) if "k_scale" in pools else None,
        v_scale=_t(pools["v_scale"]) if "v_scale" in pools else None,
        window=window,
    )
    _assert_close(got, want, dtype)
    assert bool((got[2] == 0).all())  # the all-sentinel row


def test_scalar_pos_broadcasts():
    rng = np.random.default_rng(4)
    q, cache, _ = _inputs(rng, {}, jnp.float32)
    want = jax_decode(jnp.asarray(q), jnp.asarray(cache["k"]),
                      jnp.asarray(cache["v"]), jnp.int32(5), block_s=8,
                      interpret=True)
    for pos in (5, torch.tensor(5, dtype=torch.int32)):
        got = da.decode_attention(_t(q), _t(cache["k"]), _t(cache["v"]), pos)
        _assert_close(got, want, "float32")


@pytest.mark.parametrize(
    "s_len", [da.PLAIN_BLOCK, da.PLAIN_BLOCK + 1, 2 * da.PLAIN_BLOCK + 187]
)
def test_plain_tiles_do_not_change_the_result(s_len):
    """A cache of one or more plain tiles, the last one ragged, gives
    dense softmax attention (float64, one pass over every key) within
    float32 summation order: atol 1e-5, with GQA, a window, and positions
    0 and S_max."""
    rng = np.random.default_rng(5)
    h_kv, window, G = 2, 300, H // 2
    q = rng.normal(0, 1, (B, H, DH)).astype(np.float32)
    k = rng.normal(0, 1, (B, s_len, h_kv, DH)).astype(np.float32)
    v = rng.normal(0, 1, (B, s_len, h_kv, DH)).astype(np.float32)
    pos = np.array([0, s_len, *rng.integers(1, s_len, B - 2)], np.int32)
    got = da.decode_attention_plain(_t(q), _t(k), _t(v), torch.from_numpy(pos),
                                    window=window)
    qs = q.reshape(B, h_kv, G, DH).astype(np.float64) / np.sqrt(DH)
    s = np.einsum("bkgd,bskd->bkgs", qs, k.astype(np.float64))
    cols = np.arange(s_len)[None, :]
    live = (cols <= pos[:, None]) & (cols > pos[:, None] - window)
    s = np.where(live[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bkgs,bskd->bkgd", p, v.astype(np.float64))
    want /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want.reshape(B, H, DH), rtol=0,
                               atol=1e-5)


def test_quantizer_matches_jax():
    x = np.random.default_rng(6).normal(0, 3, (5, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the all-zero row guard
    qj, sj = _quantize_kv(jnp.asarray(x))
    qt, st = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_bad_args():
    q = torch.zeros((2, 4, 8))
    k8 = torch.zeros((2, 8, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="needs k_scale"):
        da.decode_attention(q, k8, k8, 0)
    k3 = torch.zeros((2, 8, 3, 8))
    with pytest.raises(ValueError, match="divisible"):
        da.decode_attention(q, k3, k3, 0)
    with pytest.raises(ValueError, match="window"):
        da.decode_attention(q, torch.zeros((2, 8, 4, 8)), torch.zeros((2, 8, 4, 8)), 0, window=-1)
    with pytest.raises(ValueError, match="neither int8"):
        k16 = torch.zeros((2, 8, 4, 8), dtype=torch.float16)
        da.decode_attention(q, k16, k16, 0)
    with pytest.raises(ValueError, match="table"):
        pool = torch.zeros((3, 4, 4, 8))
        da.paged_decode_attention(q, pool, pool, torch.zeros((3, 2), dtype=torch.int32), 0)


def test_num_splits_and_live_keys():
    # the serving path's shapes on a 132-SM card
    assert da.num_splits(8193, 8, 16, 132) == 5
    assert da.num_splits(8193, 8, 4, 132) == 17
    assert da.num_splits(100, 8, 16, 132) == 1
    assert da.num_splits(10**6, 1, 1, 132) == da.MAX_SPLITS
    assert da.live_keys(np.array([0, 5, 30]), 24) == 1 + 6 + 24
    assert da.live_keys(np.array([10]), 24, window=4) == 4
    table = np.array([[0, 3, 1]])  # page 1 (id 3) unmapped of 3 pages
    assert da.live_keys(np.array([23]), 24, table=table, num_pages=3, page_size=8) == 16
