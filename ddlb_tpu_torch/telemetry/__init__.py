"""Telemetry: span tracing, metrics registry, and rank-tagged logging.

The port of the JAX package's ``telemetry/``, with its exports. Three
cooperating pieces, stdlib only:

- ``span`` / ``instant`` (telemetry.trace): nestable timed regions
  emitted as Chrome ``trace_event`` JSONL, env-gated via
  ``DDLB_TPU_TRACE=<dir>``; per-process shards merged by
  ``merge_trace`` into a Perfetto-loadable ``trace.json``;
- ``record`` / ``record_max`` / ``metrics_scope`` (telemetry.metrics):
  counters and high-water gauges; the runner snapshots a per-row scope
  into every result row (``barrier_wait_s``, ``loop_overhead_s``,
  ``hbm_high_water_bytes``, ``collective_bytes``);
- ``log`` (telemetry.logger): rank-tagged structured diagnostics.

``telemetry.clocksync`` folds the row's collective stamps across ranks
into the skew columns. The JAX package's ``scripts/trace_report.py``
aggregates a trace dir of the port's shards into per-phase breakdowns.
"""

from __future__ import annotations

from ddlb_tpu_torch.telemetry.logger import error, log, warn
from ddlb_tpu_torch.telemetry.metrics import (
    ROW_METRIC_DEFAULTS,
    MetricsScope,
    global_snapshot,
    metrics_scope,
    record,
    record_max,
    reset_global,
)
from ddlb_tpu_torch.telemetry.trace import (
    completed_event,
    current_depth,
    get_tracer,
    instant,
    merge_trace,
    read_events,
    span,
)

__all__ = [
    "ROW_METRIC_DEFAULTS",
    "MetricsScope",
    "completed_event",
    "current_depth",
    "error",
    "get_tracer",
    "global_snapshot",
    "instant",
    "log",
    "merge_trace",
    "metrics_scope",
    "read_events",
    "record",
    "record_max",
    "reset_global",
    "span",
    "warn",
]
