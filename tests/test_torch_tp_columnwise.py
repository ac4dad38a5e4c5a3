"""The port's tp_columnwise members against their JAX counterparts.

Both packages build their operands from the same numpy seed. The JAX
members run on the 8-device CPU simulation (``conftest.py``; the ``pallas``
member in Pallas interpret mode); the port runs on the CPU at world 1, where
the all-gather is the identity (``test_torch_multirank.py`` covers d = 2).
Tolerances: float32 at rtol 1e-5 / atol 1e-5 (summation-order noise near
zero crossings); bfloat16 within 1 bf16 ulp, since both sides keep the sum
in float32 and round once.
"""

import numpy as np
import pytest
import torch

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.primitives.base import operands_from_numpy
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port
from torch_parity import assert_within_bf16_ulps, bits, to_numpy

M, N, K = 256, 128, 256
FAMILY = "tp_columnwise"

#: (port member, JAX member, JAX-only options)
PAIRS = [
    ("pytorch", "jax_spmd", {}),
    ("cuda", "pallas", {"block_m": 128, "block_n": 128, "block_k": 128}),
]


def port(name, dtype="float32", **options):
    return load_port(FAMILY, name)(M, N, K, dtype=dtype, device="cpu", **options)


def jax_impl(name, dtype="float32", **options):
    return load_jax(FAMILY, name)(M, N, K, dtype=dtype, **options)


def assert_parity(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(
            to_numpy(got), to_numpy(want), rtol=1e-5, atol=1e-5
        )
    else:
        assert_within_bf16_ulps(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operands_bit_identical(dtype):
    ours = port("pytorch", dtype)
    theirs = jax_impl("jax_spmd", dtype)
    for mine, ref in zip(ours.get_inputs(), theirs.get_inputs()):
        assert mine.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(bits(mine), bits(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operands_from_numpy_matches_jax_placement(dtype):
    theirs = jax_impl("jax_spmd", dtype)
    host_a, host_b = theirs._host_operands()
    a, b = operands_from_numpy(host_a, host_b, dtype)
    np.testing.assert_array_equal(bits(a), bits(theirs.get_inputs()[0]))
    # an already-converted JAX array pulled to the host moves bit for bit
    a2, b2 = operands_from_numpy(
        np.asarray(theirs.get_inputs()[0]), np.asarray(theirs.get_inputs()[1]),
        dtype,
    )
    np.testing.assert_array_equal(bits(a2), bits(a))
    np.testing.assert_array_equal(bits(b2), bits(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["AG_before", "AG_after"])
@pytest.mark.parametrize("ours,theirs,jax_opts", PAIRS)
def test_member_matches_jax(ours, theirs, jax_opts, order, dtype):
    impl = port(ours, dtype, order=order)
    ref = jax_impl(theirs, dtype, order=order, **jax_opts)
    got = impl.run()
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    assert_parity(got, ref.run(), dtype)
    assert impl.validate(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", ["sharded", "unsharded"])
def test_compute_only_matches_jax(size, dtype):
    impl = port("compute_only", dtype, size=size)
    ref = jax_impl("compute_only", dtype, size=size)
    got, want = impl.run(), ref.run()
    # the JAX world has 8 partitions, so its sharded GEMM is the first m/8
    # rows; at world 1 the port's shard is the whole of A
    rows = want.shape[0]
    assert got.shape == (M, N)
    assert_parity(got[:rows], want, dtype)
    assert impl.validate(got)


def test_int_dtype_exact():
    impl = port("pytorch", "int32")
    got = impl.run()
    assert got.dtype == torch.int32
    a, b = impl._host_operands()
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)
    assert impl.validate(got)


def test_cuda_member_rejects_dtypes_k1_lacks():
    with pytest.raises(ValueError, match="K1 matmul takes"):
        port("cuda", "int32")


def test_validate_catches_a_wrong_result():
    impl = port("pytorch", "float32")
    bad = impl.run().clone()
    bad[3, 5] += 1.0
    assert not impl.validate(bad)


@pytest.mark.parametrize(
    "name,options,match",
    [
        ("pytorch", {"bogus": 1}, "Unknown option"),
        ("pytorch", {"order": "sideways"}, "not in allowed values"),
        ("compute_only", {"size": "half"}, "not in allowed values"),
    ],
)
def test_rejections_match_jax(name, options, match):
    jax_name = {"pytorch": "jax_spmd"}.get(name, name)
    with pytest.raises(ValueError, match=match):
        jax_impl(jax_name, **options)
    with pytest.raises(ValueError, match=match):
        port(name, **options)


def test_non_divisible_m_rejected_as_in_jax():
    """At d = 8 (the JAX world here) both packages refuse m = 257 with the
    same message; the port's check runs on its own partition count."""
    match = "m=257 must be divisible by partitions=8"
    with pytest.raises(ValueError, match=match):
        load_jax(FAMILY, "jax_spmd")(M + 1, N, K)
    impl = object.__new__(load_port(FAMILY, "pytorch"))
    impl.m, impl.n, impl.k, impl.num_partitions = M + 1, N, K, 8
    with pytest.raises(ValueError, match=match):
        impl._check_shapes()


def test_unknown_dtype_rejected():
    with pytest.raises(ValueError, match="Unsupported dtype"):
        port("pytorch", "float8")


def test_deterministic_seeding():
    cls = load_port(FAMILY, "pytorch")
    a1 = cls(M, N, K, seed=7, device="cpu").a
    a2 = cls(M, N, K, seed=7, device="cpu").a
    a3 = cls(M, N, K, seed=8, device="cpu").a
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, a3)
