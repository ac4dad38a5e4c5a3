"""Metrics registry: counters and high-water gauges snapshotted into rows.

A copy of the JAX package's ``telemetry/metrics.py``. A row records its
latency but not where its overhead went: barrier wait, dispatch slack,
device-memory pressure, wire bytes. Instrumented code calls
``record``/``record_max`` from wherever the cost is paid
(``Runtime.barrier``, ``utils/timing.device_loop``, the primitive's
``wire_bytes``), and the runner snapshots a per-row scope into the result
row, so the CSV carries the attribution.

Two accumulation tiers:

- a **thread-local scope stack** (``metrics_scope``): the worker wraps
  its measured region in a scope and snapshots it into the row; scopes
  nest, and a background thread's recordings never land in the
  measuring row's scope (thread-local by construction);
- a **process-global registry** that every recording also updates
  (whatever thread it happens on), for sweep-level totals.

Stdlib only.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict

#: the metric keys every result row carries (the CSV header is fixed by
#: the first row written, so the key set must be identical on measured,
#: crashed and timed-out rows — defaults fill what a row never recorded)
ROW_METRIC_DEFAULTS: Dict[str, Any] = {
    "barrier_wait_s": 0.0,        # counter: summed runtime.barrier() wait
    "loop_overhead_s": 0.0,       # gauge: device_loop dispatch/fence slack
    "hbm_high_water_bytes": 0,    # gauge: allocator peak raised by this row
    "collective_bytes": 0.0,      # gauge: wire bytes/op (primitive metadata)
}


class MetricsScope:
    """One accumulation frame: summing counters + max-keeping gauges."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def max(self, name: str, value: float) -> None:
        prev = self.gauges.get(name)
        value = float(value)
        if prev is None or value > prev:
            self.gauges[name] = value

    def snapshot(self) -> Dict[str, float]:
        """Counters and gauges as one flat dict (gauges win name clashes
        — a metric is one kind or the other by convention)."""
        out = dict(self.counters)
        out.update(self.gauges)
        return out

    def row_fields(self) -> Dict[str, Any]:
        """The fixed per-row metric columns (``ROW_METRIC_DEFAULTS``
        filled from this scope), rounded for the CSV."""
        snap = self.snapshot()
        out: Dict[str, Any] = {}
        for key, default in ROW_METRIC_DEFAULTS.items():
            value = snap.get(key, default)
            if isinstance(default, int):
                out[key] = int(value)
            else:
                out[key] = round(float(value), 6)
        return out


_GLOBAL = MetricsScope()
_global_lock = threading.Lock()
_tls = threading.local()


def _scopes() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = []
        _tls.stack = stack
    return stack


def record(name: str, value: float = 1.0) -> None:
    """Add ``value`` to counter ``name`` in every active scope on this
    thread and in the process-global registry."""
    with _global_lock:
        _GLOBAL.add(name, value)
    for scope in _scopes():
        scope.add(name, value)


def record_max(name: str, value: float) -> None:
    """Raise gauge ``name`` to ``value`` if higher (high-water mark)."""
    with _global_lock:
        _GLOBAL.max(name, value)
    for scope in _scopes():
        scope.max(name, value)


@contextmanager
def metrics_scope():
    """Scope whose body's recordings (on THIS thread) it accumulates;
    yields the ``MetricsScope``. Nests: inner recordings also land in
    outer scopes."""
    scope = MetricsScope()
    stack = _scopes()
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.remove(scope)


def global_snapshot() -> Dict[str, float]:
    """Process-lifetime totals across all threads."""
    with _global_lock:
        return _GLOBAL.snapshot()


def reset_global() -> None:
    """Drop the process-global totals (test helper)."""
    with _global_lock:
        _GLOBAL.counters.clear()
        _GLOBAL.gauges.clear()
