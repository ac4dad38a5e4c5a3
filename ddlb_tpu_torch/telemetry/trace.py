"""Span tracer: nestable spans emitted as Chrome ``trace_event`` JSONL.

A copy of the JAX package's ``telemetry/trace.py``: a shard the port
writes loads unchanged in that package's ``read_events`` / ``merge_trace``
and in ``scripts/trace_report.py``.

Design:

- **Env-gated**: tracing is on iff ``DDLB_TPU_TRACE=<dir>`` is set
  (``trace_dir``). Every ``span``/``instant`` call re-resolves the gate,
  so a test can enable/disable tracing mid-process; when disabled the
  fast path is one environment lookup and no allocation.
- **One shard per process**: each process appends JSON lines to its own
  ``trace-<host>-p<rank>-<pid>.jsonl`` (the rank is torchrun's ``RANK``,
  ``runtime.env_rank``), so ranks on a shared filesystem never contend
  on a file. ``merge_trace`` joins shards into a single
  Perfetto/``chrome://tracing``-loadable ``trace.json``.
- **Chrome trace_event schema**: complete spans are ``"ph": "X"`` events
  with ``ts``/``dur`` in microseconds (``ts`` from the epoch clock so
  shards from different processes align on one timeline), ``pid``/
  ``tid`` from the OS, and rank/host/nesting depth in ``args``. Span
  nesting is tracked per thread; Perfetto reconstructs the stack from
  ts/dur containment within a tid.
- **Crash-safe**: every event is one flushed line, so a worker killed
  mid-row loses at most the spans still open.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

#: the environment variable whose value, a directory, turns tracing on
TRACE_ENV = "DDLB_TPU_TRACE"


def trace_dir() -> Optional[str]:
    """The trace directory (``DDLB_TPU_TRACE``), or None when unset or
    blank; read anew on every call."""
    value = os.environ.get(TRACE_ENV, "").strip()
    return value or None


def _rank() -> int:
    # imported here: runtime.py imports this package
    from ddlb_tpu_torch.runtime import env_rank

    return env_rank()


_tls = threading.local()


def _span_stack() -> list:
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = []
        _tls.spans = stack
    return stack


class Tracer:
    """Appends trace events to this process's shard file (thread-safe)."""

    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)
        self.pid = os.getpid()
        self.rank = _rank()
        self.host = socket.gethostname()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory,
            f"trace-{self.host}-p{self.rank}-{self.pid}.jsonl",
        )
        self._lock = threading.Lock()
        #: per-tracer emission counter, stamped onto every event as
        #: ``seq`` — the within-(pid, tid) tie-breaker that makes the
        #: shard merge deterministic for equal-microsecond timestamps
        self._seq = 0
        self._file = open(self.path, "a", encoding="utf-8")
        # Chrome metadata event: name this pid's track by rank@host so a
        # merged multi-process trace stays attributable
        self.emit(
            {
                "ph": "M",
                "name": "process_name",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": f"p{self.rank}@{self.host}"},
            }
        )

    def emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            event.setdefault("seq", self._seq)
            line = json.dumps(event, default=str)
            try:
                self._file.write(line + "\n")
                self._file.flush()
            except (ValueError, OSError):
                # closed handle (tracer swap racing a straggler span) or
                # a full/yanked disk: telemetry must never abort the
                # measurement it observes
                pass

    def close(self) -> None:
        with self._lock:
            try:
                self._file.close()
            except OSError:  # pragma: no cover - best effort
                pass


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()
_tracer_failed: Optional[Tuple[str, int]] = None


def get_tracer() -> Optional[Tracer]:
    """The process's tracer, or None when ``DDLB_TPU_TRACE`` is unset.

    Re-created when the directory or the pid changes (a forked/spawned
    child must write its OWN shard, never the parent's open handle).
    An unwritable trace dir disables tracing with one warning instead of
    raising: telemetry failures must never abort the sweep they observe
    (the runner's crash-isolation contract does not cover span exits).
    """
    directory = trace_dir()
    if not directory:
        return None
    global _tracer, _tracer_failed
    wanted = (os.path.abspath(directory), os.getpid())
    if _tracer_failed == wanted:
        return None
    tracer = _tracer
    if tracer is not None and (tracer.directory, tracer.pid) == wanted:
        return tracer
    with _tracer_lock:
        if _tracer_failed == wanted:
            return None
        tracer = _tracer
        if tracer is None or (tracer.directory, tracer.pid) != wanted:
            if tracer is not None and tracer.pid == os.getpid():
                # superseded (trace dir changed): release its descriptor
                # — but never close a fork-parent's handle from the child
                tracer.close()
            try:
                _tracer = tracer = Tracer(directory)
            except OSError as exc:
                _tracer_failed = wanted
                # plain print: the logger mirrors into this module, and
                # this is the telemetry package's own failure channel
                print(
                    f"[ddlb_tpu_torch] WARNING: {TRACE_ENV}={directory} is "
                    f"not writable ({exc}); tracing disabled for this "
                    f"process",
                    flush=True,
                )
                return None
    return tracer


def _event_base(name: str, cat: Optional[str], attrs: Dict[str, Any],
                tracer: Tracer, depth: int) -> Dict[str, Any]:
    args = {"rank": tracer.rank, "host": tracer.host, "depth": depth}
    args.update(attrs)
    return {
        "name": name,
        "cat": cat or name.split(".", 1)[0],
        "pid": tracer.pid,
        "tid": threading.get_native_id(),
        "args": args,
    }


@contextmanager
def span(name: str, cat: Optional[str] = None, **attrs: Any):
    """Nestable timed region emitted as one complete ("X") trace event.

    ``cat`` is the phase bucket ``trace_report.py`` aggregates by
    (compile / timing / barrier / validate / ...); it defaults to the
    first dotted component of ``name``. A no-op (no file I/O, no event)
    when tracing is disabled.
    """
    tracer = get_tracer()
    if tracer is None:
        yield
        return
    stack = _span_stack()
    depth = len(stack)
    stack.append(name)
    ts_us = time.time_ns() / 1e3
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        dur_us = (time.perf_counter_ns() - t0) / 1e3
        stack.pop()
        event = _event_base(name, cat, attrs, tracer, depth)
        event.update({"ph": "X", "ts": ts_us, "dur": dur_us})
        tracer.emit(event)


def instant(name: str, cat: Optional[str] = None, **attrs: Any) -> None:
    """Zero-duration ("i") marker event; no-op when tracing is disabled."""
    tracer = get_tracer()
    if tracer is None:
        return
    event = _event_base(name, cat, attrs, tracer, len(_span_stack()))
    event.update({"ph": "i", "s": "t", "ts": time.time_ns() / 1e3})
    tracer.emit(event)


def completed_event(
    name: str, duration_s: float, cat: Optional[str] = None, **attrs: Any
) -> None:
    """A span observed only after the fact (duration known, start
    back-dated): for a cost whose duration is known only once it is
    paid, such as a compile a listener reports."""
    tracer = get_tracer()
    if tracer is None:
        return
    dur_us = max(0.0, float(duration_s)) * 1e6
    event = _event_base(name, cat, attrs, tracer, len(_span_stack()))
    event.update({"ph": "X", "ts": time.time_ns() / 1e3 - dur_us,
                  "dur": dur_us})
    tracer.emit(event)


def current_depth() -> int:
    """Open-span nesting depth on this thread (test/introspection hook)."""
    return len(_span_stack())


def read_events(directory: str) -> List[Dict[str, Any]]:
    """Every event in a trace dir: all ``trace-*.jsonl`` shards, or the
    merged ``trace.json`` when no shards exist. Corrupt lines (a process
    killed mid-write) are skipped, matching the crash-safety contract."""
    import glob

    events: List[Dict[str, Any]] = []
    shards = sorted(glob.glob(os.path.join(directory, "trace-*.jsonl")))
    for path in shards:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue
    if not shards:
        merged = os.path.join(directory, "trace.json")
        if os.path.exists(merged):
            try:
                with open(merged, encoding="utf-8") as f:
                    events = list(json.load(f).get("traceEvents", []))
            except ValueError:
                pass
    return events


def _merge_sort_key(event: Dict[str, Any]) -> tuple:
    """Deterministic merge order: metadata events first (they name the
    tracks and carry no ``ts``), then timestamp — tie-broken by
    ``(pid, tid, seq)`` so equal-microsecond spans from different
    processes cannot reorder across merges (ts alone left the order at
    the mercy of shard filenames, which embed pids that change every
    run)."""

    def _num(value, default=0.0):
        try:
            return float(value)
        except (TypeError, ValueError):
            return default

    return (
        0 if event.get("ph") == "M" else 1,
        _num(event.get("ts"), float("-inf")),
        int(_num(event.get("pid"))),
        int(_num(event.get("tid"))),
        int(_num(event.get("seq"))),
    )


def merge_trace(directory: Optional[str] = None) -> Optional[str]:
    """Merge every per-process shard under ``directory`` (default: the
    configured trace dir) into ``trace.json`` — the Chrome trace_event
    JSON object Perfetto / ``chrome://tracing`` loads directly. Returns
    the merged path, or None when tracing is disabled / no events exist.
    """
    directory = directory or trace_dir()
    if not directory:
        return None
    events = read_events(directory)
    if not events:
        return None
    events.sort(key=_merge_sort_key)
    out = os.path.join(directory, "trace.json")
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        f.write("\n")
    os.replace(tmp, out)
    return out
