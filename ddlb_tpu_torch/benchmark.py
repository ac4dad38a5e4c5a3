"""Benchmark runner: one implementation per row, a sweep per shape, a CSV.

The port of the JAX package's ``benchmark.py``: warmup, a timing loop with
a selectable backend and per-iteration barrier, the slowest rank's times
(MAX over ranks), TFLOPS = 2mnk/1e9/ms (GB/s for the collectives family,
in the ``unit`` column), soft validation, crash isolation
into an error row, and incremental CSV rows on rank 0. Rows keep the
identity, statistics and environment columns of the JAX package's
``make_result_row`` under the same names. The columns fed by parts not yet
ported (perfmodel, telemetry, faults, worker pool, skew, tuning) are left
out; ROADMAP.md lists them. The runner is in-process: one row after the
other in this process, on this rank's device.
"""

from __future__ import annotations

import csv
import logging
import os
import socket
from typing import Any, Dict, List, Optional

import numpy as np

from ddlb_tpu_torch.primitives.registry import (
    check_primitive,
    load_impl_class,
    throughput_unit,
)
from ddlb_tpu_torch.runtime import Runtime, env_rank
from ddlb_tpu_torch.utils import timing

log = logging.getLogger(__name__)

TIMING_BACKENDS = ("host_clock", "device_loop")
STAT_NAMES = ("mean", "std", "min", "max", "median", "p05", "p95", "mad")


def robust_stats(xs) -> Dict[str, float]:
    """Mean/std(pop)/min/max/median/p05/p95/MAD of a 1-D sample; all NaN
    when any value is not finite (the JAX package's numpy path)."""
    arr = np.asarray(xs, np.float64).ravel()
    if arr.size == 0:
        raise ValueError("robust_stats needs a non-empty sample")
    if not np.all(np.isfinite(arr)):
        return {name: float("nan") for name in STAT_NAMES}
    med = float(np.median(arr))
    return {
        "mean": float(np.mean(arr)),
        "std": float(np.std(arr)),
        "min": float(np.min(arr)),
        "max": float(np.max(arr)),
        "median": med,
        "p05": float(np.percentile(arr, 5)),
        "p95": float(np.percentile(arr, 95)),
        "mad": float(np.median(np.abs(arr - med))),
    }


def _format_options(options: Dict[str, Any]) -> str:
    return ";".join(f"{k}={v}" for k, v in sorted(options.items())) or "-"


def benchmark_worker(config: Dict[str, Any]) -> Dict[str, Any]:
    """Measure one implementation at one shape; returns one result row.

    Any failure (construction, timing) becomes an error row with NaN
    times; a validation crash after a completed timing loop keeps the
    times and records ``valid=False`` with the error. After validation,
    the implementation's ``extra_row_fields()`` join the row; a failure
    there goes into ``error`` and keeps the times.
    """
    primitive = config["primitive"]
    options = dict(config.get("options", {}))
    m, n, k = config["m"], config["n"], config["k"]
    dtype = config.get("dtype", "bfloat16")
    num_iterations = config.get("num_iterations", 50)
    num_warmups = config.get("num_warmups", 5)
    backend = config.get("time_measurement_backend", "host_clock")
    barrier_each = config.get("barrier_at_each_iteration", True)
    device = config.get("device", "cuda")
    if backend not in TIMING_BACKENDS:
        raise ValueError(
            f"Unknown timing backend '{backend}'. Allowed: {TIMING_BACKENDS}"
        )

    runtime: Optional[Runtime] = None
    impl = None
    result = None
    error = ""
    valid = False
    option_repr = _format_options(options)
    times_ms = np.array([float("nan")])
    try:
        runtime = Runtime(device)
        impl_class = load_impl_class(primitive, config["base_implementation"])
        impl = impl_class(m, n, k, dtype=dtype, device=device, **options)
        option_repr = _format_options(impl.options)
        for _ in range(num_warmups):
            result = impl.run()
        runtime.synchronize()
        if backend == "host_clock":
            times_ms = timing.host_clock(
                impl.run, runtime, num_iterations, barrier_each
            )
        else:
            times_ms = timing.device_loop(
                impl.run,
                runtime,
                num_iterations,
                config.get("device_loop_windows", 5),
            )
        # the reported time is the slowest rank's
        times_ms = runtime.max_over_ranks(times_ms)
        valid = True
        if config.get("validate", True):
            try:
                result = impl.run()
                valid = bool(impl.validate(result))
            except Exception as exc:
                error = f"validation crashed: {type(exc).__name__}: {exc}"
                valid = False
            valid = runtime.all_ranks(valid)
            if not valid:
                log.warning("validation failed for %s", config["impl_id"])
    except Exception as exc:  # crash isolation: the failure becomes a row
        error = f"{type(exc).__name__}: {exc}"
        times_ms = np.array([float("nan")])
        valid = False
    extra: Dict[str, Any] = {}
    if impl is not None and np.isfinite(times_ms).any():
        # family-specific measured quantities (the serve engine's stats),
        # after validation as in the JAX runner; a failure here must not
        # discard the completed measurement
        try:
            extra = impl.extra_row_fields()
        except Exception as exc:
            msg = f"extra_row_fields failed: {type(exc).__name__}: {exc}"
            error = f"{error}; {msg}" if error else msg
    row = make_result_row(
        config,
        times_ms=times_ms,
        flop_count=impl.flops() if impl is not None else float("nan"),
        option_repr=option_repr,
        valid=valid,
        error=error,
        world_size=runtime.world_size if runtime else -1,
        num_processes=runtime.num_processes if runtime else -1,
        platform=runtime.platform if runtime else "unknown",
        device_kind=runtime.device_kind if runtime else "",
    )
    row.update(extra)
    del impl, result
    return row


def make_result_row(
    config: Dict[str, Any],
    times_ms: np.ndarray,
    flop_count: float,
    option_repr: str,
    valid: bool,
    error: str,
    world_size: int,
    num_processes: int,
    platform: str,
    device_kind: str = "",
) -> Dict[str, Any]:
    """The one result-row schema, shared by measured and crashed rows."""
    times_ms = np.asarray(times_ms, np.float64)
    stats = robust_stats(times_ms)
    with np.errstate(divide="ignore", invalid="ignore"):
        tflops = flop_count / 1e9 / times_ms
    return {
        "implementation": config["impl_id"],
        "primitive": config["primitive"],
        "base_implementation": config.get(
            "base_implementation", config["impl_id"]
        ),
        "mean time (ms)": stats["mean"],
        "std time (ms)": stats["std"],
        "min time (ms)": stats["min"],
        "max time (ms)": stats["max"],
        "median time (ms)": stats["median"],
        "p95 time (ms)": stats["p95"],
        "m": config["m"],
        "n": config["n"],
        "k": config["k"],
        "dtype": config.get("dtype", "bfloat16"),
        "Throughput (TFLOPS)": float(np.mean(tflops)),
        "Throughput std (TFLOPS)": float(np.std(tflops)),
        # "GB/s" for the collectives family, whose flop count is 1000 *
        # wire bytes (registry.throughput_unit)
        "unit": throughput_unit(config["primitive"]),
        "world_size": world_size,
        "num_processes": num_processes,
        "hostname": socket.gethostname(),
        # "cuda" or "cpu": the device the row was measured on
        "platform": platform,
        # torch.cuda.get_device_name of that device ("cpu" on the host)
        "device_kind": device_kind,
        "time_measurement_backend": config.get(
            "time_measurement_backend", "host_clock"
        ),
        "barrier_at_each_iteration": config.get(
            "barrier_at_each_iteration", True
        ),
        "option": option_repr,
        "valid": valid,
        "error": error,
    }


class PrimitiveBenchmarkRunner:
    """Run one (primitive, shape) across many implementations."""

    def __init__(
        self,
        primitive: str,
        m: int,
        n: int,
        k: int,
        implementations: Dict[str, Dict[str, Any]],
        dtype: str = "bfloat16",
        num_iterations: int = 50,
        num_warmups: int = 5,
        validate: bool = True,
        time_measurement_backend: str = "host_clock",
        barrier_at_each_iteration: bool = True,
        output_csv: Optional[str] = None,
        device: str = "cuda",
        device_loop_windows: int = 5,
    ) -> None:
        check_primitive(primitive)
        self.primitive = primitive
        self.m, self.n, self.k = m, n, k
        self.implementations = implementations
        self.dtype = dtype
        self.num_iterations = num_iterations
        self.num_warmups = num_warmups
        self.validate = validate
        self.time_measurement_backend = time_measurement_backend
        self.barrier_at_each_iteration = barrier_at_each_iteration
        self.output_csv = output_csv
        self.device = device
        self.device_loop_windows = device_loop_windows

    def _worker_config(self, impl_id: str, spec: Dict[str, Any]) -> Dict[str, Any]:
        spec = dict(spec)
        base_impl = spec.pop("implementation", impl_id.rsplit("_", 1)[0])
        return {
            "primitive": self.primitive,
            "impl_id": impl_id,
            "base_implementation": base_impl,
            "options": spec,
            "m": self.m,
            "n": self.n,
            "k": self.k,
            "dtype": self.dtype,
            "num_iterations": self.num_iterations,
            "num_warmups": self.num_warmups,
            "validate": self.validate,
            "time_measurement_backend": self.time_measurement_backend,
            "barrier_at_each_iteration": self.barrier_at_each_iteration,
            "device": self.device,
            "device_loop_windows": self.device_loop_windows,
        }

    def run(self) -> List[Dict[str, Any]]:
        """Benchmark every implementation; returns the rows. Rank 0
        appends each row to ``output_csv`` as soon as it is measured."""
        rows = []
        for impl_id, spec in self.implementations.items():
            row = benchmark_worker(self._worker_config(impl_id, spec))
            rows.append(row)
            if env_rank() == 0 and self.output_csv:
                append_csv(self.output_csv, row)
        return rows


def append_csv(path: str, row: Dict[str, Any]) -> None:
    """Append one row; a new file gets the row's keys as its header, an
    existing one keeps its header (missing columns empty, extras dropped)."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    header = list(row)
    if os.path.exists(path) and os.path.getsize(path) > 0:
        with open(path, newline="") as f:
            header = next(csv.reader(f))
        write_header = False
    else:
        write_header = True
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=header, extrasaction="ignore")
        if write_header:
            writer.writeheader()
        writer.writerow(row)
