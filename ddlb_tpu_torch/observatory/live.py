"""The live sweep stream: the event feed behind ``cli/sweep_dash.py``.

The counterpart of the JAX package's ``observatory/live.py``. With
``DDLB_TPU_LIVE`` naming a file, rank 0's instrumented sites append one
flushed JSON line an event (opened in append mode, so processes can share
one stream); unset, ``post_event`` is one environment lookup and
returns. The dashboard is a separate read-only process that tails the
file, so it cannot perturb the timings it shows. A failed write warns
once and never aborts the row.

Event kinds the port posts:

- ``sweep_start`` / ``sweep_done``: the runner's bookends (the row
  count);
- ``row_start`` / ``row_phase`` / ``row_done``: a row's identity at
  dispatch, its phase marks (setup, warmup, timing, validation), and its
  outcome with the predicted-vs-measured fields (``predicted_s``,
  ``roofline_frac``, ``measured_overlap_frac``), the skew summary and the
  serving SLO summary;
- ``serving_tick``: the serving_load drain's queue-depth gauge, at most
  every ``serving_load.base._TICK_POST_INTERVAL_S`` (the cluster members
  add each decode shard's depth).

The fold also knows the JAX package's worker-pool and queue kinds
(``worker_*``, ``queue_parked``), so one dashboard reads either
package's stream; the pool's lease events wait for the pool's port. A
kind the fold does not know is counted (``state["unknown"]``), not
dropped.

``fold`` turns events into the dashboard's state; it lives here so the
tests pin it and the text and HTML renderers read the same state.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.observatory.regress import finite as _finite

#: env naming the stream's file ("" = the stream is off)
LIVE_ENV = "DDLB_TPU_LIVE"

_post_failed: Optional[str] = None


def live_path() -> str:
    """The ``DDLB_TPU_LIVE`` file, stripped ("" when unset)."""
    return os.environ.get(LIVE_ENV, "").strip()


def post_event(kind: str, **fields: Any) -> bool:
    """Append one event line to the live stream; returns whether it was
    written (False when disabled — the overwhelmingly common case — or
    on a write failure, which warns once and never raises)."""
    global _post_failed
    path = live_path()
    if not path:
        return False
    event = {"ts": time.time(), "pid": os.getpid(), "kind": kind}
    event.update(fields)
    try:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(event, default=str) + "\n")
    except OSError as exc:
        if _post_failed != path:
            _post_failed = path
            telemetry.warn(
                f"live stream {path} is not writable ({exc}); "
                f"dashboard events disabled for this process"
            )
        return False
    return True


def read_events(path: str, offset: int = 0) -> tuple:
    """(events, new_offset) from ``path`` starting at byte ``offset`` —
    the dashboard's incremental tail. Corrupt/partial lines are skipped
    (a line mid-append on the final read simply lands next poll)."""
    events: List[Dict[str, Any]] = []
    try:
        # errors="replace": a torn multibyte character mid-append must
        # not crash the tail — it can only sit on the PARTIAL last line
        # (newlines are single-byte), which is deferred below anyway,
        # so consumed complete lines always decoded cleanly
        with open(path, encoding="utf-8", errors="replace") as f:
            f.seek(offset)
            data = f.read()
    except OSError:
        return events, offset
    consumed = 0
    for line in data.splitlines(keepends=True):
        if not line.endswith("\n"):
            break  # partial tail line: re-read it next poll
        consumed += len(line.encode("utf-8"))
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except ValueError:
            continue
        if isinstance(event, dict) and "kind" in event:
            events.append(event)
    return events, offset + consumed


def fold(
    events: List[Dict[str, Any]],
    state: Optional[Dict[str, Any]] = None,
    recent: int = 12,
) -> Dict[str, Any]:
    """Fold events into (or onto) the dashboard render state:

    - ``totals``: rows done / errors / quarantined / parked / retries,
      plus the sweep's announced row count;
    - ``workers``: per child pid — lifecycle state, setup cost, the
      last parent-observed heartbeat age;
    - ``current``: per source pid — the row in flight (identity,
      dispatch time, latest phase mark), cleared by its ``row_done``;
    - ``recent``: the last N completed rows with their
      predicted-vs-measured fields;
    - ``fracs``: every finite ``roofline_frac`` / ``overlap`` pair seen,
      for the rolling predicted-vs-measured summary;
    - ``serving``: the serving panel's state — the rolling queue-depth
      gauge ring (``serving_tick`` events), in-drain progress, and the
      latest serving row's SLO summary (TTFT percentiles, goodput,
      attainment);
    - ``lanes``: the per-rank skew panel — per process id,
      how many completed rows named it the straggler, its accumulated
      arrival-skew seconds, and the latest row's ``straggler_frac``
      (``row_done`` events carry the skew fold's summary);
    - ``unknown``: per-kind counts of events this build did not
      recognize (surfaced by the renderers, never silently dropped).
    """
    if state is None:
        state = {}
    state.setdefault(
        "totals",
        {
            "total": 0, "done": 0, "errors": 0, "quarantined": 0,
            "parked": 0, "retries": 0,
        },
    )
    state.setdefault("workers", {})
    state.setdefault("current", {})
    state.setdefault("recent", [])
    state.setdefault("fracs", [])
    state.setdefault("sweep_done", False)
    state.setdefault("last_ts", 0.0)
    # serving panel state: rolling queue-depth gauge ring +
    # the latest completed serving row's SLO summary. setdefault (not
    # the None-branch literal) so a state folded by an OLDER dashboard
    # build gains the keys instead of KeyError-ing the renderer.
    state.setdefault("serving", {"depths": [], "progress": None, "latest": None})
    # per-rank skew lanes; setdefault for the same
    # older-dashboard-folded-state reason as the serving panel above
    state.setdefault("lanes", {})
    state.setdefault("unknown", {})
    totals = state["totals"]
    for e in events:
        kind = e.get("kind")
        ts = _finite(e.get("ts")) or 0.0
        state["last_ts"] = max(state["last_ts"], ts)
        src = e.get("pid")
        if kind == "sweep_start":
            totals["total"] += int(e.get("total") or 0)
        elif kind == "sweep_done":
            state["sweep_done"] = True
        elif kind == "row_start":
            state["current"][src] = {
                "impl": e.get("impl"),
                "primitive": e.get("primitive"),
                "m": e.get("m"), "n": e.get("n"), "k": e.get("k"),
                "stage": "dispatched",
                "since": ts,
            }
        elif kind == "row_phase":
            # phase marks come from the WORKER — in pooled/subprocess
            # mode a different pid than the runner that posted
            # row_start — so match by pid first, then by impl id
            current = state["current"].get(src)
            if current is None:
                impl = e.get("impl")
                for entry in state["current"].values():
                    if impl is not None and entry.get("impl") == impl:
                        current = entry
                        break
            if current is not None:
                current["stage"] = e.get("stage")
        elif kind == "row_done":
            state["current"].pop(src, None)
            totals["done"] += 1
            if e.get("error"):
                totals["errors"] += 1
            if e.get("quarantined"):
                totals["quarantined"] += 1
            totals["retries"] += int(e.get("retries") or 0)
            frac = _finite(e.get("roofline_frac"))
            overlap = _finite(e.get("measured_overlap_frac"))
            if frac is not None or overlap is not None:
                state["fracs"].append({"roofline": frac, "overlap": overlap})
            if _finite(e.get("slo_ttft_p95_ms")) is not None:
                # a serving_load completion: its SLO summary becomes the
                # panel's headline tiles
                state["serving"]["latest"] = {
                    "impl": e.get("impl"),
                    "ttft_p50_ms": _finite(e.get("slo_ttft_p50_ms")),
                    "ttft_p95_ms": _finite(e.get("slo_ttft_p95_ms")),
                    "ttft_p99_ms": _finite(e.get("slo_ttft_p99_ms")),
                    "goodput_rps": _finite(e.get("slo_goodput_rps")),
                    "attainment": _finite(e.get("slo_attainment")),
                }
            strag = _finite(e.get("straggler_rank"))
            if strag is not None and strag >= 0:
                # per-rank lane bookkeeping: lanes key by the straggler
                # process id (JSON round-trips dict keys as strings, so
                # pin the str form)
                lane = state["lanes"].setdefault(
                    str(int(strag)),
                    {"straggler_rows": 0, "skew_s": 0.0, "last_frac": None},
                )
                lane["straggler_rows"] += 1
                lane["skew_s"] += _finite(e.get("skew_enter_s")) or 0.0
                lane["last_frac"] = _finite(e.get("straggler_frac"))
            state["recent"].append(e)
            del state["recent"][:-recent]
        elif kind == "serving_tick":
            serving = state["serving"]
            depth = _finite(e.get("queue_depth"))
            if depth is not None:
                serving["depths"].append(int(depth))
                del serving["depths"][:-120]
            serving["progress"] = {
                "active": e.get("active"),
                "done": e.get("done"),
                "total": e.get("total"),
            }
            shard_depths = e.get("shard_depths")
            if isinstance(shard_depths, list):
                # cluster members: per-decode-shard queue
                # gauges; -1 marks a drained/excluded shard (rendered
                # as dead, not merely idle)
                serving["shard_depths"] = [
                    int(d) for d in shard_depths
                    if _finite(d) is not None
                ]
        elif kind == "worker_spawn":
            state["workers"][e.get("worker")] = {
                "state": "spawning",
                "reason": e.get("reason"),
                "setup_s": None,
                "beat_age_s": None,
                "since": ts,
            }
        elif kind == "worker_ready":
            worker = state["workers"].setdefault(
                e.get("worker"), {"since": ts}
            )
            worker["state"] = "ready"
            worker["setup_s"] = _finite(e.get("setup_s"))
            worker["platform"] = e.get("platform")
        elif kind == "worker_beat":
            worker = state["workers"].setdefault(
                e.get("worker"), {"state": "busy", "since": ts}
            )
            worker["beat_age_s"] = _finite(e.get("age_s"))
        elif kind == "worker_dead":
            worker = state["workers"].setdefault(
                e.get("worker"), {"since": ts}
            )
            worker["state"] = "dead"
            worker["error"] = str(e.get("error") or "")[:120]
        elif kind == "queue_parked":
            totals["parked"] += 1
        else:
            # forward compat: a kind this build doesn't know is counted
            # and surfaced, never silently dropped (a newer runner may
            # share the stream with an older dashboard)
            state["unknown"][str(kind)] = state["unknown"].get(
                str(kind), 0
            ) + 1
    return state
