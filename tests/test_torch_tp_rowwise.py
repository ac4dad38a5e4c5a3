"""The port's tp_rowwise members against their JAX counterparts.

Same inputs from the same seed; the JAX members run on the 8-device CPU
simulation (``pallas`` in interpret mode), the port on the CPU at world 1,
where the reduce-scatter is the identity (``test_torch_multirank.py``
covers d = 2).

Tolerances. float32: rtol 1e-5 / atol 1e-5. bfloat16 against
``jax_spmd``: 1 bf16 ulp, since XLA's CPU backend keeps the partial
products and their reduce-scatter in f32 and rounds once, as the port does.
bfloat16 against ``pallas``: its Pallas GEMM writes each of the d = 8
partial products in bf16 before the reduce-scatter sums them, and the sum
may round again at each of its d - 1 steps, while the port at world 1
rounds the f32 sum once. Each rounding moves a value by at most half a bf16
ulp of the largest magnitude involved, so the two agree within d ulps
(2d - 1 half-ulps on the JAX side, one on the port's) at the largest of
|partial_r| and |result| for that element.
"""

import numpy as np
import pytest
import torch

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port
from torch_parity import assert_within_bf16_ulps, to_numpy

M, N, K = 256, 128, 256
FAMILY = "tp_rowwise"

#: (port member, JAX member, JAX-only options, JAX rounds partials to bf16)
PAIRS = [
    ("pytorch", "jax_spmd", {}, False),
    ("cuda", "pallas", {"block_m": 128, "block_n": 128, "block_k": 128}, True),
]


def port(name, dtype="float32", **options):
    return load_port(FAMILY, name)(M, N, K, dtype=dtype, device="cpu", **options)


def jax_impl(name, dtype="float32", **options):
    return load_jax(FAMILY, name)(M, N, K, dtype=dtype, **options)


def partial_scale(impl, d):
    """Elementwise max of |partial_r| over the JAX world's d k-blocks and
    of |full product|: the magnitude the bf16 roundings act at."""
    a, b = impl._host_operands()
    a, b = a.astype(np.float64), b.astype(np.float64)
    kd = K // d
    partials = [a[:, r * kd:(r + 1) * kd] @ b[r * kd:(r + 1) * kd] for r in range(d)]
    return np.max(np.abs(np.stack(partials + [a @ b])), axis=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ours,theirs,jax_opts,bf16_partials", PAIRS)
def test_member_matches_jax(ours, theirs, jax_opts, bf16_partials, dtype):
    impl = port(ours, dtype)
    ref = jax_impl(theirs, dtype, **jax_opts)
    got, want = impl.run(), ref.run()
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(
            to_numpy(got), to_numpy(want), rtol=1e-5, atol=1e-5
        )
    elif bf16_partials:
        d = ref.num_partitions
        assert_within_bf16_ulps(got, want, ulps=d, scale=partial_scale(impl, d))
    else:
        assert_within_bf16_ulps(got, want)
    assert impl.validate(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_only_unsharded_matches_jax(dtype):
    impl = port("compute_only", dtype, size="unsharded")
    ref = jax_impl("compute_only", dtype, size="unsharded")
    got = impl.run()
    if dtype == "float32":
        np.testing.assert_allclose(
            to_numpy(got), to_numpy(ref.run()), rtol=1e-5, atol=1e-5
        )
    else:
        assert_within_bf16_ulps(got, ref.run())
    assert impl.validate(got)


def test_compute_only_sharded_is_one_partition():
    """At world 1 the one partition's k-block is all of k: the sharded
    GEMM is the whole product (the JAX world's is a k/8 partial)."""
    impl = port("compute_only", size="sharded")
    assert impl.a.shape == (M, K) and impl.b.shape == (K, N)
    a, b = impl._host_operands()
    np.testing.assert_allclose(impl.run().numpy(), a @ b, rtol=1e-5, atol=1e-5)
    assert impl.validate(impl.run())


def test_validate_checks_own_rows():
    impl = port("pytorch")
    bad = impl.run().clone()
    bad[-1, 0] += 1.0
    assert not impl.validate(bad)


def test_int_dtype_exact():
    impl = port("pytorch", "int64")
    got = impl.run()
    a, b = impl._host_operands()
    np.testing.assert_array_equal(got.numpy(), a @ b)
    assert impl.validate(got)


@pytest.mark.parametrize(
    "shape,match",
    [
        ((M, N, K + 1), "k=257 must be divisible by partitions=8"),
        ((M + 1, N, K), "m=257 must be divisible by partitions=8"),
    ],
)
def test_non_divisible_rejected_as_in_jax(shape, match):
    """At d = 8 (the JAX world here) both packages refuse the shape with
    the same message; the port's check runs on its own partition count."""
    with pytest.raises(ValueError, match=match):
        load_jax(FAMILY, "jax_spmd")(*shape)
    impl = object.__new__(load_port(FAMILY, "pytorch"))
    impl.m, impl.n, impl.k = shape
    impl.num_partitions = 8
    with pytest.raises(ValueError, match=match):
        impl._check_shapes()


@pytest.mark.parametrize(
    "name,options,match",
    [
        ("pytorch", {"order": "AG_before"}, "Unknown option"),
        ("compute_only", {"size": "quarter"}, "not in allowed values"),
    ],
)
def test_rejections_match_jax(name, options, match):
    jax_name = {"pytorch": "jax_spmd"}.get(name, name)
    with pytest.raises(ValueError, match=match):
        jax_impl(jax_name, **options)
    with pytest.raises(ValueError, match=match):
        port(name, **options)
