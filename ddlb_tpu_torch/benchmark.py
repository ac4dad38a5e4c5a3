"""Benchmark runner: one implementation per row, a sweep per shape, a CSV.

The port of the JAX package's ``benchmark.py``: warmup, an optional
profiler window, a timing loop with a selectable backend and per-iteration
barrier, the slowest rank's times (MAX over ranks), TFLOPS = 2mnk/1e9/ms
(GB/s for the collectives family, in the ``unit`` column), soft
validation, crash isolation into an error row, and incremental CSV rows on
rank 0. Rows keep the identity, statistics and environment columns of the
JAX package's ``make_result_row`` under the same names, with its
telemetry columns (``barrier_wait_s``, ``loop_overhead_s``,
``hbm_high_water_bytes``, ``collective_bytes``, ``hbm_peak_gib``), its
cost-model columns (``PERF_ROW_DEFAULTS``: ``predicted_s``,
``roofline_frac``, ``bound``, ``chip``, the measured-overlap attribution
and the calibrated trio) and its cross-rank skew columns
(``telemetry.clocksync``); ``schema.py`` documents every column. The
columns fed by parts not yet ported (compile-ahead, faults, worker pool,
tuning) are left out; ROADMAP.md lists them. The runner is in-process:
one row after the other in this process, on this rank's device. With
``DDLB_TPU_HISTORY=<dir>`` rank 0 banks every row
(``observatory/store.py``).

With ``DDLB_TPU_TRACE=<dir>`` every row is a ``worker.row`` span holding
its ``worker.setup``, ``worker.warmup``, ``worker.profile``,
``worker.timing`` and ``worker.validate`` phases, and rank 0 merges the
ranks' shards into ``<dir>/trace.json`` at the end of a run. With
``profile_dir`` each row's profiler window is written as a Chrome trace
to ``<profile_dir>/<impl_id>-p<rank>.json``.
"""

from __future__ import annotations

import csv
import os
import socket
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.observatory import attribution, live, store
from ddlb_tpu_torch.perfmodel import cost as perfmodel_cost
from ddlb_tpu_torch.primitives.registry import (
    check_primitive,
    load_impl_class,
    throughput_unit,
)
from ddlb_tpu_torch.runtime import Runtime, env_rank
from ddlb_tpu_torch.telemetry import clocksync
from ddlb_tpu_torch.utils import timing

#: calls the profiler window records (the JAX runner's five)
PROFILE_RUNS = 5

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


#: the cost-model columns every row carries, with these defaults on rows
#: whose member was never built and where no calibration table covers the
#: chip: the predicted lower bound, the achieved share of it, the term
#: that dominates and the spec it was made against; the calibrated trio;
#: the measured-overlap attribution set
PERF_ROW_DEFAULTS: Dict[str, Any] = {
    "predicted_s": float("nan"),
    "roofline_frac": float("nan"),
    "bound": "",
    "chip": "",
    "predicted_cal_s": float("nan"),
    "cal_residual_frac": float("nan"),
    "cal_version": "",
    **attribution.ATTRIBUTION_ROW_DEFAULTS,
}


def _perfmodel_fields(impl, times_ms: np.ndarray,
                      backend: str = "host_clock") -> Dict[str, Any]:
    """The cost-model columns of one row (the JAX runner's, :103-166): the
    member's ``cost_model()`` verdict, ``roofline_frac`` against the
    measured median, the measured-overlap attribution, and the calibrated
    trio where ``DDLB_TPU_CALIB`` names a table with a (chip, ``backend``)
    group. The prediction is shape-only, so an error row with a member
    gets it too. A failing cost model warns and keeps the measurement
    (the defaults stand)."""
    if impl is None:
        return {}
    try:
        est = impl.cost_model()
    except Exception as exc:
        telemetry.warn(f"perfmodel cost estimate failed: {type(exc).__name__}: {exc}")
        return {}
    finite = times_ms[np.isfinite(times_ms)]
    measured_s = float(np.median(finite)) * 1e-3 if finite.size else float("nan")
    fields = {
        "predicted_s": est.predicted_s,
        "roofline_frac": est.roofline_frac(measured_s),
        "bound": est.bound,
        "chip": est.chip,
        **attribution.attribute(
            est,
            getattr(impl, "COST_SCHEDULE", "sequential"),
            measured_s,
            chunks=perfmodel_cost.overlap_chunks(impl),
        ),
    }
    try:
        cal = perfmodel_cost.calibrated_estimate(impl, backend=backend)
    except Exception as exc:
        telemetry.warn(f"calibrated estimate failed: {type(exc).__name__}: {exc}")
        cal = None
    if cal is not None:
        fields["predicted_cal_s"] = cal.predicted_cal_s
        fields["cal_residual_frac"] = cal.residual_frac(measured_s)
        fields["cal_version"] = cal.version
    return fields


def _format_options(options: Dict[str, Any]) -> str:
    return ";".join(f"{k}={v}" for k, v in sorted(options.items())) or "-"


def _mark(stage: str, impl_id: str) -> None:
    """A row's phase mark on the live stream (rank 0; one environment
    lookup when ``DDLB_TPU_LIVE`` is unset)."""
    if env_rank() == 0:
        live.post_event("row_phase", stage=stage, impl=impl_id)


def _post_row_done(row: Dict[str, Any], impl_id: str, primitive: str) -> None:
    """The live stream's ``row_done``: the outcome, the predicted-vs-measured
    fields, the skew summary and the serving SLO summary (the JAX runner's
    fields but the worker pool's, which the port's runner has no column
    for)."""
    live.post_event(
        "row_done", impl=impl_id, primitive=primitive,
        median_ms=row.get("median time (ms)"),
        predicted_s=row.get("predicted_s"),
        roofline_frac=row.get("roofline_frac"),
        measured_overlap_frac=row.get("measured_overlap_frac"),
        error=str(row.get("error") or "")[:200],
        skew_enter_s=row.get("skew_enter_s"),
        straggler_rank=row.get("straggler_rank"),
        straggler_frac=row.get("straggler_frac"),
        slo_ttft_p50_ms=row.get("slo_ttft_p50_ms"),
        slo_ttft_p95_ms=row.get("slo_ttft_p95_ms"),
        slo_ttft_p99_ms=row.get("slo_ttft_p99_ms"),
        slo_goodput_rps=row.get("slo_goodput_rps"),
        slo_attainment=row.get("slo_attainment"),
    )


def benchmark_worker(config: Dict[str, Any]) -> Dict[str, Any]:
    """Measure one implementation at one shape; returns one result row.

    Any failure (construction, timing) becomes an error row with NaN
    times; a validation crash after a completed timing loop keeps the
    times and records ``valid=False`` with the error. After validation,
    the implementation's ``extra_row_fields()`` join the row; a failure
    there goes into ``error`` and keeps the times. The row's telemetry
    (a metrics scope, the phase spans, the skew fold) never fails it: a
    failing ``wire_bytes()`` or skew fold warns and keeps the defaults.
    """
    primitive = config["primitive"]
    impl_id = config["impl_id"]
    options = dict(config.get("options", {}))
    m, n, k = config["m"], config["n"], config["k"]
    dtype = config.get("dtype", "bfloat16")
    num_iterations = config.get("num_iterations", 50)
    num_warmups = config.get("num_warmups", 5)
    backend = config.get("time_measurement_backend", "host_clock")
    barrier_each = config.get("barrier_at_each_iteration", True)
    device = config.get("device", "cuda")
    profile_dir = config.get("profile_dir")
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
    skew: Optional[Dict[str, Any]] = None
    peak_at_entry = None
    # the metrics scope collects what the row's code records (barrier
    # wait, loop slack, wire bytes, allocator peak) into its columns
    with telemetry.metrics_scope() as scope, telemetry.span(
        "worker.row", cat="row", impl=impl_id, primitive=primitive
    ):
        # the skew fold reads exactly this row's collective spans
        clocksync.reset_row()
        try:
            _mark("setup", impl_id)
            with telemetry.span("worker.setup", cat="setup", impl=impl_id):
                runtime = Runtime(device)
                peak_at_entry = _device_peak(runtime)
                impl_class = load_impl_class(primitive, config["base_implementation"])
                impl = impl_class(m, n, k, dtype=dtype, device=device, **options)
            option_repr = _format_options(impl.options)
            _record_wire_bytes(impl, impl_id)
            if getattr(impl, "compiles_on_first_call", False) and num_warmups < 1:
                raise ValueError(
                    f"'{config['base_implementation']}' compiles on its first call: "
                    "num_warmups must be >= 1 to keep the compile out of the timed "
                    "window"
                )
            _mark("warmup", impl_id)
            with telemetry.span("worker.warmup", cat="warmup", impl=impl_id):
                for _ in range(num_warmups):
                    result = impl.run()
                runtime.synchronize()
            if profile_dir:
                _mark("profile", impl_id)
                with telemetry.span("worker.profile", cat="profile", impl=impl_id):
                    profile_window(impl, runtime, profile_dir, impl_id)
                    # re-warm after the profiler's overhead
                    for _ in range(num_warmups):
                        result = impl.run()
                    runtime.synchronize()
            _mark("timing", impl_id)
            with telemetry.span("worker.timing", cat="timing", impl=impl_id,
                                backend=backend):
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
            # while the world is still in lock step: the row's collective
            # stamps across ranks, folded into the skew columns
            skew = clocksync.fold_row_skew(runtime)
            valid = True
            if config.get("validate", True):
                _mark("validate", impl_id)
                with telemetry.span("worker.validate", cat="validate", impl=impl_id):
                    try:
                        result = impl.run()
                        valid = bool(impl.validate(result))
                    except Exception as exc:
                        error = f"validation crashed: {type(exc).__name__}: {exc}"
                        valid = False
                    valid = runtime.all_ranks(valid)
                if not valid:
                    telemetry.warn(f"validation failed for {impl_id}")
        except Exception as exc:  # crash isolation: the failure becomes a row
            error = f"{type(exc).__name__}: {exc}"
            times_ms = np.array([float("nan")])
            valid = False
        # the allocator's peak is process-lifetime and never reset: it
        # lands only when THIS row raised it (the JAX runner's rule)
        peak = _device_peak(runtime)
        peak_raised = peak is not None and (peak_at_entry is None or peak > peak_at_entry)
        if peak_raised:
            telemetry.record_max("hbm_high_water_bytes", peak)
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
        metrics=scope.row_fields(),
        perf=_perfmodel_fields(impl, times_ms, backend=backend),
        skew=skew,
        hbm_peak_gib=round(peak / 2**30, 3) if peak_raised else float("nan"),
    )
    row.update(extra)
    del impl, result
    return row


def _record_wire_bytes(impl, impl_id: str) -> None:
    """The bytes one rank moves per collective op (the family's
    ``wire_bytes()``) into the row's ``collective_bytes``; a family whose
    ``wire_bytes()`` breaks warns and keeps the default."""
    wire = getattr(impl, "wire_bytes", None)
    if not callable(wire):
        return
    try:
        telemetry.record_max("collective_bytes", float(wire()))
    except Exception as exc:
        telemetry.warn(f"wire_bytes() failed for {impl_id}: {type(exc).__name__}: {exc}")


def _device_peak(runtime: Optional[Runtime]) -> Optional[int]:
    """The allocator's peak bytes on the runtime's card since the process
    began (``torch.cuda.max_memory_allocated``), None on the CPU."""
    if runtime is None or runtime.platform != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(runtime.device))


def profile_window(impl, runtime: Runtime, profile_dir: str, impl_id: str) -> str:
    """``PROFILE_RUNS`` calls of ``impl`` and a device sync under
    ``torch.profiler.profile`` (CPU and CUDA activities on the card, CPU
    on the host), exported with ``export_chrome_trace`` to
    ``<profile_dir>/<impl_id>-p<rank>.json``; returns the path."""
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if runtime.platform == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILE_RUNS):
            impl.run()
        runtime.synchronize()
    path = os.path.join(profile_dir, f"{impl_id}-p{runtime.rank}.json")
    prof.export_chrome_trace(path)
    return path


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
    metrics: Optional[Dict[str, Any]] = None,
    skew: Optional[Dict[str, Any]] = None,
    hbm_peak_gib: float = float("nan"),
    perf: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The one result-row schema, shared by measured and crashed rows.

    ``metrics`` is the row's telemetry snapshot, ``perf`` its cost-model
    columns (``_perfmodel_fields``) and ``skew`` its skew fold; only the
    fixed ``telemetry.ROW_METRIC_DEFAULTS``, ``PERF_ROW_DEFAULTS`` and
    ``clocksync.SKEW_ROW_DEFAULTS`` keys land as columns, with their
    defaults where a row never recorded them (error rows included), so
    the CSV header is the same on every path."""
    metric_fields = dict(telemetry.ROW_METRIC_DEFAULTS)
    if metrics:
        metric_fields.update({k: metrics[k] for k in metric_fields if k in metrics})
    perf_fields = dict(PERF_ROW_DEFAULTS)
    if perf:
        perf_fields.update({k: perf[k] for k in perf_fields if k in perf})
    skew_fields = dict(clocksync.SKEW_ROW_DEFAULTS)
    if skew:
        skew_fields.update({k: skew[k] for k in skew_fields if k in skew})
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
        # where the row's overhead went: barrier wait, device_loop slack,
        # allocator high-water, wire bytes
        **metric_fields,
        "hbm_peak_gib": hbm_peak_gib,
        # the cost model: the predicted lower bound, the share of it the
        # row achieved, the dominating term, the measured overlap and the
        # calibrated prediction
        **perf_fields,
        # how long the row's collectives waited on their last arrival,
        # which rank it was, and the clock-alignment uncertainty
        **skew_fields,
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
        profile_dir: Optional[str] = None,
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
        self.profile_dir = profile_dir

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
            "profile_dir": self.profile_dir,
        }

    def run(self) -> List[Dict[str, Any]]:
        """Benchmark every implementation; returns the rows. Rank 0
        appends each row to ``output_csv`` as soon as it is measured,
        banks it with ``DDLB_TPU_HISTORY`` set (``store.bank_row``), posts
        the sweep's and each row's events with ``DDLB_TPU_LIVE`` set
        (``observatory/live.py``) and, when tracing, merges the trace at
        the end (``merge_trace``)."""
        rows = []
        primary = env_rank() == 0
        if primary and self.implementations:
            live.post_event("sweep_start", total=len(self.implementations),
                            primitive=self.primitive)
        for impl_id, spec in self.implementations.items():
            if primary:
                live.post_event("row_start", impl=impl_id, primitive=self.primitive,
                                m=self.m, n=self.n, k=self.k)
            row = benchmark_worker(self._worker_config(impl_id, spec))
            rows.append(row)
            if primary:
                if self.output_csv:
                    with telemetry.span("runner.csv_append", cat="runner", impl=impl_id):
                        append_csv(self.output_csv, row)
                store.bank_row(row)
                _post_row_done(row, impl_id, self.primitive)
        if primary and self.implementations:
            live.post_event("sweep_done", rows=len(rows))
        self.merge_trace()
        return rows

    def merge_trace(self) -> Optional[str]:
        """With ``DDLB_TPU_TRACE`` set: a barrier, so that every rank's
        shard is complete, then rank 0 merges the shards into
        ``trace.json`` and logs its path (returned; None elsewhere and
        when not tracing)."""
        if telemetry.trace.trace_dir() is None:
            return None
        try:
            Runtime(self.device).barrier()
        except Exception as exc:
            telemetry.warn(f"trace merge barrier failed: {type(exc).__name__}: {exc}")
        if env_rank() != 0:
            return None
        merged = telemetry.merge_trace()
        if merged:
            telemetry.log(f"trace merged: {merged}")
        return merged


def append_csv(path: str, row: Dict[str, Any]) -> None:
    """Append one row; a new file gets the row's keys as its header. A row
    with columns the header lacks (a member's own, such as the compiled
    member's ``compile_s``) widens it: the file is rewritten with those
    columns added at the end, empty in the earlier rows."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    rows: List[Dict[str, Any]] = []
    header = list(row)
    if os.path.exists(path) and os.path.getsize(path) > 0:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            header = list(reader.fieldnames)
            new = [key for key in row if key not in header]
            if new:
                rows, header = list(reader), header + new
    write_header = rows or not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "w" if rows else "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=header, extrasaction="ignore")
        if write_header:
            writer.writeheader()
        writer.writerows(rows + [row])
