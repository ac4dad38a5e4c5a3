"""The port's cp_ring_attention members against their JAX counterparts.

Both packages draw q, k, v from one numpy generator with the same seed, so
the operands are bit for bit equal. The JAX members run on the 8-device CPU
simulation (``conftest.py``; the flash members in Pallas interpret mode
with blocks of 16); the port runs on the CPU at world 1, where every
collective is the identity and the flash wrappers take their plain
versions (``test_torch_multirank.py`` covers d = 2). Both results are the
full ``[m, h, k]`` attention. Tolerances: float32 at rtol = atol = 1e-5
(the same float32 math in other summation orders); bfloat16 within 1 bf16
ulp, since both sides compute in float32 from the same bf16 operands and
round once.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.cli.benchmark import load_config, run_benchmark
from ddlb_tpu_torch.primitives.registry import (
    implementation_names,
    load_impl_class as load_port,
)
from torch_parity import assert_within_bf16_ulps, bits, to_numpy

FAMILY = "cp_ring_attention"
M, N, K = 128, 64, 16  # seq 128, 4 heads of 16
#: ulysses at the JAX side's d = 8 needs 8 heads
N_ULYSSES = 128
BLOCKS = {"block_q": 16, "block_kv": 16}
GQA_WINDOW = {"window": 24, "n_kv_heads": 2}

#: id -> (member, width, options, JAX-only options)
CASES = {
    "compute_only": ("compute_only", N, {"size": "unsharded"}, {}),
    "ring_skip": ("ring", N, {"skip_masked_blocks": True}, {}),
    "ring_noskip": ("ring", N, {"skip_masked_blocks": False}, {}),
    "allgather": ("allgather", N, {}, {}),
    "ulysses_einsum": ("ulysses", N_ULYSSES, {"compute": "einsum"}, {}),
    "ulysses_flash": ("ulysses", N_ULYSSES, {"compute": "flash"}, BLOCKS),
    "flash": ("flash", N, {}, BLOCKS),
    "ring_flash_skip": ("ring_flash", N, {"skip_masked_blocks": True}, BLOCKS),
    "ring_flash_noskip": ("ring_flash", N, {"skip_masked_blocks": False}, BLOCKS),
    "flash_window_gqa": ("flash", N, GQA_WINDOW, BLOCKS),
    "ring_window_gqa": ("ring", N, GQA_WINDOW, {}),
    "ring_flash_window_gqa": ("ring_flash", N, GQA_WINDOW, BLOCKS),
}


def port(name, n=N, dtype="float32", **options):
    return load_port(FAMILY, name)(M, n, K, dtype=dtype, device="cpu", **options)


def jax_impl(name, n=N, dtype="float32", **options):
    return load_jax(FAMILY, name)(M, n, K, dtype=dtype, **options)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_member_matches_jax(case, dtype):
    name, n, options, jax_only = CASES[case]
    ours = port(name, n, dtype, **options)
    theirs = jax_impl(name, n, dtype, **options, **jax_only)
    got, want = ours.run(), theirs.run()
    assert tuple(got.shape) == (M, n // K, K)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(
            to_numpy(got), to_numpy(want), rtol=1e-5, atol=1e-5
        )
    else:
        assert_within_bf16_ulps(got, want)
    assert ours.validate(got)


def test_sharded_compute_only_is_the_diagonal_block():
    """At world 1 the diagonal block is the whole sequence; the row is not
    validated (the JAX member's rule)."""
    ours = port("compute_only", size="sharded")
    want = jax_impl("compute_only", size="unsharded").run()
    np.testing.assert_allclose(
        to_numpy(ours.run()), to_numpy(want), rtol=1e-5, atol=1e-5
    )
    garbage = torch.full((M, N // K, K), 7.0)
    assert ours.validate(garbage)
    assert not port("compute_only", size="unsharded").validate(garbage)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operands_bit_identical(dtype):
    ours = port("ring", dtype=dtype, **GQA_WINDOW)
    theirs = jax_impl("ring", dtype=dtype, **GQA_WINDOW)
    for mine, ref in zip(ours.get_inputs(), theirs.get_inputs()):
        np.testing.assert_array_equal(bits(mine), bits(ref))
    assert ours.get_inputs()[1].shape == (M, 2, K)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("options", [{}, GQA_WINDOW], ids=["causal", "window_gqa"])
def test_oracle_matches_jax(dtype, options):
    ours = port("allgather", dtype=dtype, **options)._expected_full()
    theirs = jax_impl("allgather", dtype=dtype, **options)._expected_full()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "options", [{}, {"window": 16}, {"window": M}, {"window": 4 * M}],
    ids=["causal", "window", "window_m", "window_beyond"],
)
def test_flops_match_jax(options):
    assert port("ring", **options).flops() == jax_impl("ring", **options).flops()


@pytest.mark.parametrize("name", implementation_names(FAMILY))
def test_option_schema_matches_jax(name):
    """The JAX schema less the TPU tile sizes (block_q, block_kv), which
    the port leaves out."""
    ours = load_port(FAMILY, name).option_schema()
    theirs = load_jax(FAMILY, name).option_schema()
    tiles = ("block_q", "block_kv")
    for mine, ref in zip(ours, theirs):
        assert mine == {k: v for k, v in ref.items() if k not in tiles}


def test_registry_names_match_jax():
    from ddlb_tpu.primitives.registry import implementation_names as jax_names

    assert set(implementation_names(FAMILY)) == set(jax_names(FAMILY))


@pytest.mark.parametrize(
    "name,shape,options",
    [
        ("ring", (M + 1, N, K), {}),             # m not divisible (JAX at d=8)
        ("ring", (M, N + 1, K), {}),             # width not whole heads
        ("allgather", (M, N, K), {"n_kv_heads": 3}),
        ("ulysses", (M, N, K), {"n_kv_heads": 3}),
    ],
)
def test_shape_rejections_match_jax(name, shape, options):
    with pytest.raises(ValueError) as theirs:
        load_jax(FAMILY, name)(*shape, dtype="float32", **options)
    try:
        load_port(FAMILY, name)(*shape, dtype="float32", device="cpu", **options)
    except ValueError as ours:
        assert str(ours) == str(theirs.value)
    else:  # m = 129 splits over the port's world of 1
        assert "divisible by partitions=8" in str(theirs.value)


@pytest.mark.parametrize("name", ["ring", "flash", "ring_flash", "ulysses"])
def test_integer_dtypes_rejected(name):
    with pytest.raises(ValueError, match="floating dtype"):
        port(name, dtype="int32")


@pytest.mark.parametrize("name", ["flash", "ring_flash"])
def test_flash_members_reject_float64(name):
    with pytest.raises(ValueError, match="flash kernels take"):
        port(name, dtype="float64")


def test_unknown_option_rejected():
    with pytest.raises(ValueError, match="Unknown option 'block_q'"):
        port("flash", block_q=16)


def test_runner_row_through_the_cli_config(tmp_path):
    """The shipped sweep config, cut to a tiny shape on the CPU with the
    host clock, through the port's config path: every row valid, with the
    family's FLOP count."""
    config = load_config(
        str(Path(__file__).resolve().parent.parent / "scripts"
            / "config_cp_ring_attention.json")
    )
    config["benchmark"].update(
        m=[M], n=[N], k=[K], num_iterations=2, num_warmups=1, device="cpu",
        time_measurement_backend="host_clock",
        output_csv=str(tmp_path / "rows.csv"),
    )
    config["benchmark"]["implementations"]["ring_flash"] = [{}]
    rows = run_benchmark(config)
    assert len(rows) == 9
    assert (tmp_path / "rows.csv").read_text().count("\n") == 10
    for row in rows:
        assert row["valid"] and not row["error"], row
        assert row["platform"] == "cpu" and row["primitive"] == FAMILY
        expected_tflops = 2.0 * M * M * N / 1e9 / row["mean time (ms)"]
        assert abs(row["Throughput (TFLOPS)"] - expected_tflops) <= 1e-9 * expected_tflops


@pytest.mark.parametrize(
    "family,name,options",
    [
        ("tp_columnwise", "pytorch", {"order": "AG_before"}),
        ("tp_columnwise", "cuda", {"order": "AG_after"}),
        ("tp_columnwise", "compute_only", {"size": "unsharded"}),
        ("tp_rowwise", "pytorch", {}),
        ("tp_rowwise", "cuda", {}),
        ("tp_rowwise", "compute_only", {"size": "sharded"}),
    ],
)
def test_gemm_rows_unchanged_through_call_args(family, name, options):
    """``run()`` calls ``_fn(*_call_args)``; for the GEMM families the
    operands are still ``(a, b)``, and the result is ``_fn(a, b)``."""
    impl = load_port(family, name)(64, 48, 32, dtype="float32", device="cpu",
                                   **options)
    assert impl._call_args == (impl.a, impl.b)
    assert impl.get_inputs() == (impl.a, impl.b)
    assert torch.equal(impl.run(), impl._fn(impl.a, impl.b))
    assert impl.validate(impl.run())
