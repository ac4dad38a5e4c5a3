"""The port's quantized members and its dp_allreduce and ep_alltoall
families against the JAX package's.

Same inputs from the same seed. The JAX members run on a one-device mesh
of the CPU simulation (``kernel=pallas`` in interpret mode), so both
packages quantize the same operand shards: the k-sharded members quantize
per shard, and a JAX world of 8 would hold other shards than the port at
world 1. ``test_torch_multirank.py`` covers d = 2.

Tolerances. The quantized members: bit for bit. Both packages quantize
with the same float32 operations, sum int8 products exactly and apply the
same epilogue; at world 1 no collective touches the values. The
unquantized members: float32 at rtol 1e-5 / atol 1e-5, bfloat16 within 1
bf16 ulp (XLA's CPU backend and the port both sum in float32 and round
once; the routed ``compute_only`` einsum upcasts the operands in both).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.cli.benchmark import run_benchmark
from ddlb_tpu_torch.ops import quantized_matmul as qm
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port
from torch_parity import assert_within_bf16_ulps, to_numpy

M, N, K = 64, 48, 96
FAMILIES = ("tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall")
GRID = list(itertools.product(("xla", "pallas"), ("static", "dynamic")))


def _one_device_mesh():
    return jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])


def port(family, name, dtype="float32", **options):
    return load_port(family, name)(M, N, K, dtype=dtype, device="cpu", **options)


def jax_impl(family, name, dtype="float32", **options):
    return load_jax(family, name)(
        M, N, K, dtype=dtype, mesh=_one_device_mesh(), **options
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,quantize", GRID)
@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_member_bit_equal_to_jax(family, kernel, quantize, dtype):
    impl = port(family, "quantized", dtype, kernel=kernel, quantize=quantize)
    ref = jax_impl(family, "quantized", dtype, kernel=kernel, quantize=quantize)
    before = qm.LAUNCHES
    got = impl.run()
    assert qm.LAUNCHES == before  # CPU tensors take K7's plain version
    want = _tensor_from_numpy(np.asarray(ref.run()))
    assert got.shape == (M, N) and got.dtype == want.dtype
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())
    assert impl.validate(got)


@pytest.mark.parametrize("family", FAMILIES)
def test_static_and_dynamic_quantize_alike(family):
    """Quantizing at set-up or inside the step quantizes the same values."""
    a = port(family, "quantized", "bfloat16", quantize="static").run()
    b = port(family, "quantized", "bfloat16", quantize="dynamic").run()
    assert torch.equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_validation_catches_a_wrong_row(family):
    impl = port(family, "quantized")
    bad = impl.run().clone()
    bad[-1, 0] += 3.0 * qm.quantization_atol(K)
    assert not impl.validate(bad)


#: (family, port member, JAX member, options) of the unquantized members
PLAIN_CASES = [
    ("dp_allreduce", "compute_only", "compute_only", {"size": "sharded"}),
    ("dp_allreduce", "compute_only", "compute_only", {"size": "unsharded"}),
    ("dp_allreduce", "pytorch", "jax_spmd", {"strategy": "all_reduce"}),
    ("dp_allreduce", "pytorch", "jax_spmd", {"strategy": "rs_ag"}),
    ("ep_alltoall", "compute_only", "compute_only", {"size": "sharded"}),
    ("ep_alltoall", "compute_only", "compute_only", {"size": "unsharded"}),
    ("ep_alltoall", "pytorch", "jax_spmd", {}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,ours,theirs,options", PLAIN_CASES)
def test_member_matches_jax(family, ours, theirs, options, dtype):
    impl = port(family, ours, dtype, **options)
    got, want = impl.run(), jax_impl(family, theirs, dtype, **options).run()
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got, want)
    assert impl.validate(got)


def test_routed_oracle_matches_jax_at_eight_partitions():
    """The routed oracle at d = 8 (group e of each partition through
    expert e) is the JAX family's, and the seeded operands are its too
    (float32 sums in another order: rtol 1e-5, atol 1e-5)."""
    ours = object.__new__(load_port("ep_alltoall", "pytorch"))
    ours.m, ours.n, ours.k, ours.dtype, ours.seed = M, N, K, "float32", 42
    ours.num_partitions = 8
    theirs = load_jax("ep_alltoall", "jax_spmd")(M, N, K, dtype="float32")
    assert theirs.num_partitions == 8
    for x, y in zip(ours._host_tokens_experts(), theirs._host_tokens_experts()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(
        ours._expected_full(), theirs._expected_full(), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("family", FAMILIES)
def test_int_dtype_rejected(family):
    for make in (port, jax_impl):
        with pytest.raises(ValueError, match="floating operand dtypes"):
            make(family, "quantized", "int32")


@pytest.mark.parametrize("option", ["block_m", "block_n", "block_k", "tune"])
def test_tpu_tile_options_not_ported(option):
    value = True if option == "tune" else 128
    with pytest.raises(ValueError, match="not ported"):
        port("tp_columnwise", "quantized", kernel="pallas", **{option: value})


@pytest.mark.parametrize("family", ["dp_allreduce", "ep_alltoall"])
@pytest.mark.parametrize(
    "member", ["jax_spmd_hier", "jax_spmd_striped", "xla_gspmd", "overlap", "pallas"]
)
def test_members_not_yet_ported(family, member):
    load_jax(family, member)  # the JAX package has it
    with pytest.raises(ValueError, match="not yet ported"):
        load_port(family, member)


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_names_point_at_the_port_member(family):
    with pytest.raises(ValueError, match="counterpart is 'pytorch'"):
        load_port(family, "jax_spmd")


@pytest.mark.parametrize(
    "family,name,options,shape,match",
    [
        ("ep_alltoall", "pytorch", {}, (M + 8, N, K), "partitions\\^2=64"),
        ("dp_allreduce", "pytorch", {}, (M, N, K + 1), "k=97 must be divisible"),
        ("dp_allreduce", "pytorch", {"strategy": "rs_ag"}, (M + 1, N, K),
         "m=65 must be divisible by partitions=8 for strategy=rs_ag"),
    ],
)
def test_shape_rejections_match_jax(family, name, options, shape, match):
    """At d = 8 (the JAX world here) both packages refuse the shape with
    the same message; the port's check runs on its own partition count."""
    jax_name = {"pytorch": "jax_spmd"}[name]
    with pytest.raises(ValueError, match=match):
        load_jax(family, jax_name)(*shape, **options)
    impl = object.__new__(load_port(family, name))
    impl.m, impl.n, impl.k = shape
    impl.num_partitions = 8
    impl.options = {"strategy": "all_reduce", **options}
    with pytest.raises(ValueError, match=match):
        impl._check_shapes()


def test_quantized_sweep_through_the_runner(tmp_path):
    """``scripts/config_quantized.json``'s grid, at a small shape, through
    the port's runner: every row valid with a finite time."""
    rows = run_benchmark({
        "primitive": "dp_allreduce",
        "m": M, "n": N, "k": K,
        "dtype": "bfloat16",
        "validate": True,
        "num_iterations": 2,
        "num_warmups": 1,
        "device": "cpu",
        "output_csv": str(tmp_path / "rows.csv"),
        "implementations": {
            "pytorch": [{"strategy": ["all_reduce", "rs_ag"]}],
            "quantized": [{"kernel": ["xla", "pallas"],
                           "quantize": ["static", "dynamic"]}],
        },
    })
    assert len(rows) == 6
    for row in rows:
        assert row["valid"] and not row["error"], row
        assert np.isfinite(row["median time (ms)"])
