"""The port's runner, CLI, runtime and registry on the CPU."""

import csv
import json

import numpy as np
import pytest
import torch

from ddlb_tpu import benchmark as jax_benchmark
from ddlb_tpu.cli import benchmark as jax_cli
from ddlb_tpu.native import robust_stats as jax_robust_stats
from ddlb_tpu.options import OptionsManager as JaxOptionsManager
from ddlb_tpu_torch import benchmark as port_benchmark
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.options import OptionsManager
from ddlb_tpu_torch.primitives import registry
from ddlb_tpu_torch.primitives.base import Primitive
from ddlb_tpu_torch.runtime import Runtime
from ddlb_tpu_torch.utils import timing

#: the identity, statistics and environment columns of the JAX package's
#: make_result_row that the port keeps under the same names
SHARED_COLUMNS = (
    "implementation", "primitive", "base_implementation",
    "mean time (ms)", "std time (ms)", "min time (ms)", "max time (ms)",
    "median time (ms)", "p95 time (ms)", "m", "n", "k", "dtype",
    "Throughput (TFLOPS)", "Throughput std (TFLOPS)", "unit",
    "world_size", "num_processes", "hostname", "platform",
    "time_measurement_backend", "barrier_at_each_iteration",
    "option", "valid", "error",
)


def _cpu_config(tmp_path, primitive="tp_columnwise", implementations=None):
    return {
        "primitive": primitive,
        "m": 64,
        "n": 32,
        "k": [48, 64],
        "dtype": "float32",
        "validate": True,
        "num_iterations": 3,
        "num_warmups": 1,
        "time_measurement_backend": "host_clock",
        "barrier_at_each_iteration": True,
        "output_csv": str(tmp_path / "rows_{timestamp}.csv"),
        "device": "cpu",
        "implementations": implementations
        or {
            "compute_only": [{"size": ["sharded", "unsharded"]}],
            "pytorch": [{"order": ["AG_before", "AG_after"]}],
            "cuda": [{}],
        },
    }


def _read_csv(tmp_path):
    (path,) = tmp_path.glob("rows_*.csv")
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_run_benchmark_writes_rows_with_jax_column_names(tmp_path, capsys):
    rows = port_cli.run_benchmark(_cpu_config(tmp_path))
    assert len(rows) == 2 * 5  # two shapes x five expanded configs
    assert all(r["valid"] and not r["error"] for r in rows), rows
    assert all(np.isfinite(r["median time (ms)"]) for r in rows)
    assert {r["platform"] for r in rows} == {"cpu"}
    csv_rows = _read_csv(tmp_path)
    assert len(csv_rows) == len(rows)

    jax_row = jax_benchmark.make_result_row(
        {"impl_id": "x_0", "primitive": "tp_columnwise", "m": 1, "n": 1, "k": 1},
        times_ms=np.array([1.0]), flop_count=2.0, option_repr="-",
        valid=True, error="", world_size=1, num_processes=1, platform="cpu",
    )
    for column in SHARED_COLUMNS:
        assert column in jax_row, column
        assert column in csv_rows[0], column
    assert "Benchmark results" in capsys.readouterr().out


def test_shipped_config_shape_is_read(tmp_path):
    """scripts/config.json's shape (a 'benchmark' block) with the port's
    member names; the JAX package's ``xla_gspmd`` runs as ``compiled``."""
    cfg = {"benchmark": _cpu_config(
        tmp_path,
        implementations={
            "pytorch": [{"order": ["AG_before"]}],
            "overlap": [{"algorithm": ["default"]}],
            "xla_gspmd": [{}],
        },
    )}
    cfg["benchmark"]["k"] = 32
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    rows = port_cli.run_benchmark(port_cli.load_config(str(path)))
    by_impl = {r["implementation"]: r for r in rows}
    assert by_impl["pytorch_0"]["valid"]
    assert by_impl["overlap_0"]["valid"] and not by_impl["overlap_0"]["error"]
    assert by_impl["compiled_0"]["valid"] and not by_impl["compiled_0"]["error"]
    assert by_impl["compiled_0"]["base_implementation"] == "compiled"


def test_unknown_config_key_rejected(tmp_path):
    cfg = _cpu_config(tmp_path)
    cfg["isolation"] = "subprocess"
    with pytest.raises(ValueError, match="not supported by ddlb_tpu_torch"):
        port_cli.run_benchmark(cfg)


def test_cli_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "rows_cli.csv"
    port_cli.main([
        "--device", "cpu", "--primitive", "tp_rowwise",
        "--impl", "cuda", "--impl", "pytorch",
        "-m", "32", "-n", "16", "-k", "32,64",
        "--num-iterations", "2", "--num-warmups", "1", "--csv", str(out),
    ])
    rows = _read_csv(tmp_path)
    assert [r["implementation"] for r in rows] == ["cuda_0", "pytorch_0"] * 2
    assert all(r["valid"] == "True" and r["primitive"] == "tp_rowwise" for r in rows)
    assert "Results written to" in capsys.readouterr().out


@pytest.mark.parametrize(
    "spec",
    [
        "pytorch;order=AG_before,AG_after",
        "overlap;algorithm=coll_pipeline,p2p_pipeline;s=4",
        "compute_only;size=sharded",
    ],
)
def test_impl_spec_and_expansion_match_jax(spec):
    assert port_cli.parse_impl_spec(spec) == jax_cli.parse_impl_spec(spec)
    name, opts = port_cli.parse_impl_spec(spec)
    blocks = {name: [opts]}
    assert port_cli.assign_impl_ids(
        port_cli.generate_config_combinations(blocks)
    ) == jax_cli.assign_impl_ids(jax_cli.generate_config_combinations(blocks))


def test_device_loop_backend_needs_the_card(tmp_path):
    cfg = _cpu_config(tmp_path, implementations={"pytorch": [{}]})
    cfg["time_measurement_backend"] = "device_loop"
    rows = port_cli.run_benchmark(cfg)
    assert all("needs the card" in r["error"] for r in rows)
    with pytest.raises(ValueError, match="needs the card"):
        timing.device_loop(lambda: None, Runtime("cpu"), 3)


def test_error_row_for_a_bad_option(tmp_path):
    rows = port_cli.run_benchmark(
        _cpu_config(tmp_path, implementations={"pytorch": [{"order": ["x"]}]})
    )
    assert all("not in allowed values" in r["error"] for r in rows)
    assert all(np.isnan(r["mean time (ms)"]) for r in rows)


@pytest.mark.parametrize(
    "sample",
    [[1.0, 2.0, 4.0, 8.0], [0.5], [3.0, float("nan")], list(np.linspace(1, 2, 17))],
)
def test_robust_stats_matches_jax(sample):
    ours = port_benchmark.robust_stats(sample)
    theirs = jax_robust_stats(sample)
    for name in port_benchmark.STAT_NAMES:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-12)


@pytest.mark.parametrize(
    "overrides",
    [
        {"s": 4},
        {"s": 0},
        {"s": 65},
        {"s": "4"},
        {"s": True},
        {"mode": "b"},
        {"mode": "z"},
        {"free": "anything"},
        {"nope": 1},
        {"implementation": "pytorch", "s": 64},
    ],
)
def test_options_manager_matches_jax(overrides):
    """The same schema accepts and refuses the same overrides, with the
    same messages, in both packages (ranges, lists, unknown names)."""
    defaults = {"s": 1, "mode": "a", "free": 0}
    allowed = {"s": (1, 64), "mode": ["a", "b"]}
    outcomes = []
    for cls in (JaxOptionsManager, OptionsManager):
        try:
            outcomes.append(("ok", cls(defaults, allowed).parse(overrides)))
        except ValueError as exc:
            outcomes.append(("error", str(exc)))
    assert outcomes[0] == outcomes[1]


def test_runtime_defaults_to_the_card():
    """No quiet CPU: without CUDA a Runtime with no device argument raises,
    and so does a primitive."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime()
    cls = registry.load_impl_class("tp_columnwise", "pytorch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(64, 64, 64)


def test_runtime_on_cpu_world_of_one():
    rt = Runtime("cpu")
    assert (rt.rank, rt.world_size, rt.platform) == (0, 1, "cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert rt.all_gather_rows(x) is x and rt.reduce_scatter_rows(x) is x
    assert rt.all_ranks(True) and not rt.all_ranks(False)
    rt.barrier()
    with pytest.raises(ValueError, match="device must be one of"):
        Runtime("tpu")


@pytest.mark.parametrize(
    "primitive,name,match",
    [
        ("dp_allreduce", "jax_spmd_hier", "counterpart is 'pytorch_hier'"),
        ("tp_rowwise", "xla_gspmd", "counterpart is 'compiled'"),
        ("tp_columnwise", "jax_spmd", "counterpart is 'pytorch'"),
        ("tp_rowwise", "pallas", "counterpart is 'cuda'"),
        ("tp_columnwise", "nope", "Unknown implementation"),
        ("dp_allreduce", "jax_spmd", "counterpart is 'pytorch'"),
        ("dp_allreduce", "pallas", "counterpart is 'cuda'"),
        ("pp_pipeline", "jax_spmd", "counterpart is 'pytorch'"),
        ("transformer_step", "xla_gspmd", "counterpart is 'compiled'"),
        ("bogus", "pytorch", "Unknown primitive"),
    ],
)
def test_registry_errors(primitive, name, match):
    with pytest.raises(ValueError, match=match):
        registry.load_impl_class(primitive, name)


def test_registry_classes_are_primitives():
    for primitive in registry.ALLOWED_PRIMITIVES:
        for name in registry.implementation_names(primitive):
            cls = registry.load_impl_class(primitive, name)
            assert issubclass(cls, Primitive)
            assert cls.primitive_name == primitive


def test_csv_widens_for_a_member_s_own_columns(tmp_path):
    """A row with columns the file's header lacks (the compiled member's
    ``compile_s`` after a ``pytorch`` row) widens the header; earlier rows
    keep their values, with the new columns empty."""
    path = str(tmp_path / "rows.csv")
    port_benchmark.append_csv(path, {"implementation": "pytorch_0", "valid": True})
    port_benchmark.append_csv(path, {"implementation": "compiled_0", "valid": True,
                                     "compile_s": 1.5, "async_tp_fused": 1})
    port_benchmark.append_csv(path, {"implementation": "cuda_0", "valid": False})
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["implementation", "valid", "compile_s", "async_tp_fused"]
    assert [r["implementation"] for r in rows] == ["pytorch_0", "compiled_0", "cuda_0"]
    assert rows[0]["compile_s"] == "" and rows[1]["compile_s"] == "1.5"
    assert rows[1]["async_tp_fused"] == "1" and rows[2]["valid"] == "False"
