"""Registry of the telemetry span, instant and metric names the port emits.

A copy of the JAX package's ``telemetry/names.py``, restricted to the
names this package passes to ``telemetry.span`` / ``instant`` /
``record`` / ``record_max`` / ``completed_event``. Every one of them is
also a name of the JAX registry, with the same meaning, so the JAX
package's trace reports (``scripts/trace_report.py``, which groups rows by
``worker.row`` and phases by category) read the port's traces as they
read its own. Reports join by NAME: renaming a span here without moving
its emitter, or the other way round, fails the port's name test.

Three dicts, name -> one-line meaning.
"""

from __future__ import annotations

from typing import Dict

#: timed regions (``telemetry.span`` / ``completed_event``)
SPAN_NAMES: Dict[str, str] = {
    "device_loop.window": "one timed device-loop window",
    "overlap.chunk": "chunked-fusion engine: one planned pipeline chunk",
    "overlap.ring_step": "chunked-fusion engine: one planned ring hop",
    "runner.csv_append": "incremental CSV append of one result row",
    "runtime.barrier": "cross-process barrier collective",
    "runtime.mesh_build": "device mesh construction",
    "serve.admit": "serving engine admission of one request batch",
    "serve.drain": "serving_load one open-loop trace drain (measured call)",
    "serve.run": "serving engine full run loop",
    "sim.replay": "simulator discrete-event replay of one schedule program",
    "sim.validate": "simulator validation pass (closed-form or history join)",
    "skew.fold": "cross-rank skew fold: stamp allgather + clock-aligned fold",
    "worker.profile": "benchmark_worker optional profiling phase",
    "worker.row": "benchmark_worker one full row (the report join key)",
    "worker.setup": "benchmark_worker input/mesh setup phase",
    "worker.timing": "benchmark_worker timed measurement loop",
    "worker.validate": "benchmark_worker result validation phase",
    "worker.warmup": "benchmark_worker warmup iterations",
}

#: zero-duration markers (``telemetry.instant``)
INSTANT_NAMES: Dict[str, str] = {
    "clocksync.exchange": (
        "clock-sync anchor: a barrier exit's monotonic stamp next to "
        "the trace event's epoch ts (maps trace shards onto the "
        "aligned world timeline)"
    ),
    "log": "rank-tagged log line mirrored into the trace",
    "serve.drain_shard": (
        "serving cluster drained an excluded shard's in-flight "
        "requests to survivors over KV handoffs"
    ),
    "serve.handoff": (
        "serving cluster KV bundle shipped prefill pool -> decode "
        "pool (or shard -> shard on a drain)"
    ),
    "serve.indict": (
        "serving cluster SLO watch indicted a dominated shard "
        "(dropped from the router's live set)"
    ),
    "serve.exonerate": (
        "an indicted shard passed its probation window and was "
        "re-admitted to the router's live set (cost-weighted)"
    ),
    "serve.preempt": "serving engine preempted a slot (requeued, KV evicted)",
    "serve.probe": (
        "one probation probe window closed on an excluded shard "
        "(healthy=... is the window's verdict)"
    ),
    "serve.reject": "serving cluster admission controller shed a request",
    "serve.resize": (
        "elastic pool transition: a prefill shard promoted into the "
        "decode pool (or a promoted shard demoted back)"
    ),
    "serve.reweigh": (
        "the SLO watch re-resolved a shard's cost weight on a health-"
        "verdict flip (degraded-but-alive attracts less load)"
    ),
    "serve.slo": "serving_load end-of-drain SLO summary (TTFT/goodput)",
    "serve.ticks": "serving engine decode-tick marker",
    "topo.recompose": (
        "a composition=auto member re-resolved to a different "
        "composition mid-sweep (health/fault/degraded inputs moved)"
    ),
}

#: counters / gauges (``telemetry.record`` / ``record_max``)
METRIC_NAMES: Dict[str, str] = {
    "barrier_wait_s": "seconds spent waiting in Runtime.barrier",
    "collective_bytes": "modeled collective wire bytes for the row",
    "hbm_high_water_bytes": "device memory high-water mark",
    "loop_overhead_s": "host-side loop overhead estimate",
    "serve.decode_s": "seconds in serving decode ticks",
    "serve.queue_depth": "serving load driver's peak observed queue depth",
    "serve.ticks": "serving decode ticks executed",
    "sim.events": "discrete events processed by one simulator replay",
}


def all_names() -> Dict[str, str]:
    """Union of every registered name (collisions are fine: a span and
    a metric may legitimately share a name, e.g. ``serve.ticks``)."""
    out: Dict[str, str] = {}
    out.update(METRIC_NAMES)
    out.update(INSTANT_NAMES)
    out.update(SPAN_NAMES)
    return out
