"""Measured-overlap attribution: a row's measurement joined to its cost model.

The counterpart of the JAX package's ``observatory/attribution.py``.
``roofline_frac`` says how close a row came to its combined bound; for an
overlap member the question is how much of the hideable communication
time it hid. From the cost model's terms (``compute_s`` / ``comm_s`` /
``hbm_s``, each a lower bound a call):

- ``t_serial  = max(compute + comm, hbm)``: the sequential floor;
- ``t_overlap = max(compute, comm, hbm)``: the perfect-overlap floor; for
  a chunked member (``chunks``), its own ``max(compute, comm) +
  min(compute, comm) / chunks``;
- ``hideable  = t_serial - t_overlap``;
- ``measured_overlap_frac = (t_serial - measured) / hideable`` clamped
  into [0, 1], defined only for ``COST_SCHEDULE == "overlap"`` members
  with a hideable window above float noise (NaN otherwise: a one-rank
  collective, or a schedule that already hides all it could);
- ``phase_compute_s`` / ``phase_comm_s``: the model's phase floors;
  ``phase_idle_s = max(0, measured - t_overlap)``: the time no term
  explains (launch overhead, bubbles, waits).

``rows_from_events`` groups a merged trace's spans by ``worker.row``
span, the grouping of the JAX package's ``scripts/trace_report.py``; it
reads the port's ``trace.json`` as it reads the JAX package's.

Stdlib only and duck-typed: ``attribute`` takes anything with the three
terms as attributes or dict keys.
"""

from __future__ import annotations

from typing import Any, Dict

_NAN = float("nan")

#: relative floor under which a hideable window counts as "nothing to
#: hide": dividing by a denominator this far below the serial floor
#: produces junk fractions (inf at exactly 0 pre-clamp), not signal
_HIDEABLE_RTOL = 1e-9

#: the attribution columns every result row carries (the CSV header is
#: fixed by the first row written, so error rows carry these defaults; NaN
#: marks "no measurement or model here")
ATTRIBUTION_ROW_DEFAULTS: Dict[str, Any] = {
    "measured_overlap_frac": _NAN,
    "phase_compute_s": _NAN,
    "phase_comm_s": _NAN,
    "phase_idle_s": _NAN,
}


def _term(est: Any, name: str) -> float:
    value = getattr(est, name, None)
    if value is None and isinstance(est, dict):
        value = est.get(name)
    try:
        value = float(value)
    except (TypeError, ValueError):
        return 0.0
    return value if value == value and value >= 0.0 else 0.0


def attribute(
    est: Any, schedule: str, measured_s: float, chunks: Any = None
) -> Dict[str, Any]:
    """The attribution columns for one row.

    ``est`` duck-types the cost model's estimate (``compute_s`` /
    ``comm_s`` / ``hbm_s`` attributes or dict keys, seconds a call);
    ``schedule`` is the member's ``COST_SCHEDULE``; ``measured_s`` the
    measured median; ``chunks`` the chunked pipeline's depth when the
    member declares one (``Primitive.overlap_chunks``), which moves
    ``t_overlap`` to the member's own fill-and-drain floor.
    Returns the ``ATTRIBUTION_ROW_DEFAULTS`` key set, with NaN wherever
    the quantity is undefined (no measurement, no hideable window at
    this schedule's granularity, non-overlap schedule for the overlap
    fraction).
    """
    compute = _term(est, "compute_s")
    comm = _term(est, "comm_s")
    hbm = _term(est, "hbm_s")
    out = dict(ATTRIBUTION_ROW_DEFAULTS)
    if compute or comm or hbm:
        out["phase_compute_s"] = compute
        out["phase_comm_s"] = comm
    measured_ok = (
        isinstance(measured_s, (int, float))
        and measured_s == measured_s  # not NaN
        and measured_s > 0.0
    )
    if not measured_ok:
        return out
    t_serial = max(compute + comm, hbm)
    t_overlap = max(compute, comm, hbm)
    if isinstance(chunks, (int, float)) and chunks >= 1:
        t_overlap = max(
            hbm, max(compute, comm) + min(compute, comm) / float(chunks)
        )
    if t_overlap > 0.0:
        out["phase_idle_s"] = max(0.0, float(measured_s) - t_overlap)
    hideable = t_serial - t_overlap
    if schedule == "overlap" and hideable > _HIDEABLE_RTOL * t_serial:
        frac = (t_serial - float(measured_s)) / hideable
        out["measured_overlap_frac"] = min(1.0, max(0.0, frac))
    return out


def rows_from_events(events) -> list:
    """Per-row span groups from a trace-event list: one record a
    ``worker.row`` span, with every complete span contained in it (same
    pid and tid, [ts, ts+dur] within the row's interval) summed by
    category. A process writes many rows into one shard, so rows are
    grouped by their span, not by pid; the tid filter keeps another
    thread's spans out of a row they merely overlap in time.
    """
    import bisect

    spans = [
        e
        for e in events
        if e.get("ph") == "X"
        and isinstance(e.get("ts"), (int, float))
        and isinstance(e.get("dur"), (int, float))
    ]
    # bucket once by (pid, tid), sorted by start time: each row span
    # then scans only its bisected window instead of the whole trace
    buckets: Dict[tuple, list] = {}
    for e in spans:
        buckets.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    starts: Dict[tuple, list] = {}
    for key, bucket in buckets.items():
        bucket.sort(key=lambda e: e["ts"])
        starts[key] = [e["ts"] for e in bucket]
    rows = []
    for row_span in spans:
        if row_span.get("name") != "worker.row":
            continue
        r0 = row_span["ts"]
        r1 = r0 + row_span["dur"]
        args = row_span.get("args") or {}
        phases: Dict[str, float] = {}
        key = (row_span.get("pid"), row_span.get("tid"))
        bucket = buckets[key]
        # µs clock granularity slack, matching the span tests
        lo = bisect.bisect_left(starts[key], r0 - 1.0)
        for e in bucket[lo:]:
            if e["ts"] > r1 + 1.0:
                break  # sorted by start: nothing later can be contained
            if e is row_span:
                continue
            if e["ts"] + e["dur"] > r1 + 1.0:
                continue
            cat = e.get("cat") or "uncategorized"
            phases[cat] = phases.get(cat, 0.0) + e["dur"] / 1e3
        rows.append(
            {
                "impl": args.get("impl", ""),
                "primitive": args.get("primitive", ""),
                "pid": row_span.get("pid"),
                "ts_us": r0,
                "dur_ms": row_span["dur"] / 1e3,
                "phases": phases,
            }
        )
    rows.sort(key=lambda r: r["ts_us"])
    return rows
