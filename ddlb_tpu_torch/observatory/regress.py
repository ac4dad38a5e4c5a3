"""Regression detection: the current run against the per-key history.

The counterpart of the JAX package's ``observatory/regress.py``, with its
thresholds. Given the current run's rows and the bank's earlier records
(``observatory/store.py``), it flags and ranks the rows that got slower.
The statistics are robust: the baseline is the per-key **median** and
the noise scale the per-key **MAD** (median absolute deviation):

- a row regresses when its measured median exceeds the history median by
  more than ``z_tol`` robust deviations AND by more than ``min_excess``
  relatively (the MAD is floored at ``rel_floor`` of the median, so a
  tight history does not turn jitter into a finding);
- a key with NO history falls back to the **perfmodel prior**: the row's
  ``predicted_cal_s`` (when the row was priced from a calibration table)
  or its ``predicted_s`` (the analytical lower bound); a row measuring
  more than ``prior_factor`` times it is a prior-only advisory, ranked
  after every history-backed finding;
- findings rank by robust z (history-backed), then by the ratio to the
  prediction (prior-only), worst first.

The same machinery gates the serving rows' ``SLO_METRICS`` per key
(``detect_slo``, direction-aware: goodput regresses down), the skew
columns (``detect_skew``, with absolute noise floors: they sit near zero
on clean runs), the calibration residual (``detect_calibration``,
baselines fenced by ``cal_version``) and the persistent-straggler verdict
(``detect_health``). ``detect_all`` merges every gate into one ranked
list. The port's rows carry every column these read (``schema.py``).

Read by ``cli/observatory_report.py``, ``cli/calib_report.py`` and
``chip_smoke.py``'s observatory phase. Stdlib only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ddlb_tpu_torch.observatory.store import row_key

#: detector defaults (every one overridable by the callers' knobs)
Z_TOL = 3.5          # robust deviations above the history median
MIN_EXCESS = 0.10    # AND at least 10% slower than the median
REL_FLOOR = 0.05     # MAD floor, as a fraction of the median
PRIOR_FACTOR = 5.0   # prior-only: measured > 5x the analytical bound

MEASURE_COLUMN = "median time (ms)"

#: serving SLO metrics gated per key NEXT TO the default time metric
#:: direction "high" = bigger is worse (latency
#: percentiles), "low" = smaller is worse (goodput). Rows that don't
#: carry a metric (every non-serving family) contribute nothing —
#: the gate extends the detector, it never re-scopes it.
SLO_METRICS = (
    ("slo_ttft_p50_ms", "high"),
    ("slo_ttft_p95_ms", "high"),
    ("slo_ttft_p99_ms", "high"),
    ("slo_tpot_p95_ms", "high"),
    ("slo_goodput_rps", "low"),
)

#: absolute ``(noise_floor, min_excess)`` per SLO metric, same role as
#: the skew/calibration floors: on a CPU drill the latency
#: percentiles live in single-digit milliseconds with near-zero MAD
#: across a two-row baseline, so the relative machinery alone z-scores
#: sub-millisecond host jitter into a finding. A latency percentile
#: must worsen by a real millisecond (goodput by a quarter rps) before
#: it counts; against production-scale baselines (tens to thousands of
#: ms) the floors are invisible. Keyed separately so ``SLO_METRICS``
#: keeps its public ``(metric, direction)`` shape.
SLO_ABS_DEFAULT = (0.5, 1.0)
SLO_ABS = {
    "slo_goodput_rps": (0.05, 0.25),
}

#: minimum baseline depth before the SLO gate may judge a row: the
#: per-topology fencing keeps SLO populations small, and a MAD
#: estimated from one or two samples is no spread estimate at all
#: (n=1 gives identically-zero MAD, so any host wobble z-scores to a
#: finding). The time gate keeps its prior fallback and the skew/cal
#: gates their absolute floors; only the SLO gate is fenced finely
#: enough to need a depth requirement.
SLO_MIN_HISTORY = 3

#: cross-rank skew metrics gated per key: ``(metric,
#: direction, abs_floor, abs_excess)``. The skew columns live near
#: zero on clean runs (scheduler jitter), so the relative machinery
#: alone would flag 3x-of-nothing noise — each metric therefore
#: carries an ABSOLUTE noise floor on the MAD scale and an absolute
#: minimum excess a finding must clear:
#: ``straggler_frac`` must grow by 0.20 of the row's collective time,
#: ``skew_enter_s`` by 100 ms of real waiting, before either counts.
SKEW_METRICS = (
    ("straggler_frac", "high", 0.02, 0.20),
    ("skew_enter_s", "high", 0.005, 0.10),
)

#: calibration-drift metric gated per key: same
#: ``(metric, direction, abs_floor, abs_excess)`` shape as the skew
#: set. ``cal_residual_frac`` sits near zero on a freshly-fitted model,
#: so the MAD scale is floored at 0.02 and a finding must clear an
#: absolute +0.10 residual excess — a run 10% slower than the fitted
#: model beyond baseline noise. Direction-aware: only drift toward
#: SLOWER gates ("high"); a run faster than the model is a refit hint,
#: not an alarm (the report shows it, the gate stays quiet).
CAL_METRICS = (
    ("cal_residual_frac", "high", 0.02, 0.10),
)


def median(values: List[float]) -> float:
    """Plain median (stdlib-only tier; statistics.median allocates the
    same sort)."""
    ordered = sorted(values)
    n = len(ordered)
    if not n:
        return float("nan")
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def mad(values: List[float], center: Optional[float] = None) -> float:
    """Median absolute deviation around ``center`` (default: the
    median) — the robust noise scale."""
    if not values:
        return float("nan")
    c = median(values) if center is None else center
    return median([abs(v - c) for v in values])


def finite(value: Any) -> Optional[float]:
    """``value`` as a finite float, else None — the one
    coerce-anything-measured helper the observatory shares (records are
    a mix of JSON numbers, CSV strings, and NaN error rows)."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def baselines(
    records: List[Dict[str, Any]],
    metric: str = MEASURE_COLUMN,
    exclude_run: Optional[str] = None,
) -> Dict[str, Dict[str, Any]]:
    """Per-key robust baseline over history records: ``{key: {median,
    mad, n, runs}}`` for every key with at least one finite ``metric``
    sample. ``exclude_run`` drops the current run's own records so a
    run never baselines against itself."""
    samples: Dict[str, List[float]] = {}
    runs: Dict[str, set] = {}
    for record in records:
        if record.get("kind", "row") != "row":
            continue
        if exclude_run and record.get("run_id") == exclude_run:
            continue
        row = record.get("row") or {}
        value = finite(row.get(metric))
        if value is None:
            continue
        key = record.get("key") or row_key(row)
        samples.setdefault(key, []).append(value)
        runs.setdefault(key, set()).add(record.get("run_id"))
    out: Dict[str, Dict[str, Any]] = {}
    for key, values in samples.items():
        m = median(values)
        out[key] = {
            "median": m,
            "mad": mad(values, m),
            "n": len(values),
            "runs": len(runs[key]),
        }
    return out


def detect(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    metric: str = MEASURE_COLUMN,
    exclude_run: Optional[str] = None,
    z_tol: float = Z_TOL,
    min_excess: float = MIN_EXCESS,
    rel_floor: float = REL_FLOOR,
    prior_factor: float = PRIOR_FACTOR,
) -> List[Dict[str, Any]]:
    """Regression findings for ``current_rows`` against ``history``,
    ranked worst first (history-backed findings by robust z, then
    prior-only advisories by measured/predicted ratio).

    Each finding carries the evidence a report needs: the key's
    identity columns, measured vs baseline, the robust z, the slowdown
    ratio, and ``source`` (``history`` | ``perfmodel_prior``).

    Baselines are fenced per ``tuning_version``, exactly as
    ``detect_calibration`` fences per ``cal_version``: a row measured
    under a tuning table only baselines against history measured under
    the SAME table fingerprint — a re-tune that changes the applied
    knobs starts a fresh baseline instead of reading as a step change.
    Untuned rows (version "") compare against untuned history, which on
    a pre-tuner bank is ALL of it — behavior unchanged.
    """

    def _tuning_version(row: Dict[str, Any]) -> str:
        return str(row.get("tuning_version") or "")

    versions = {_tuning_version(row) for row in current_rows}
    base_by_version = {
        version: baselines(
            [
                rec
                for rec in history
                if _tuning_version(rec.get("row") or {}) == version
            ],
            metric=metric,
            exclude_run=exclude_run,
        )
        for version in versions
    }
    findings: List[Dict[str, Any]] = []
    for row in current_rows:
        measured = finite(row.get(metric))
        if measured is None:
            continue  # error rows have no measurement to regress
        key = row_key(row)
        stats = base_by_version[_tuning_version(row)].get(key)
        if stats is not None:
            finding = _history_finding(
                row, key, metric, measured, stats, "high",
                z_tol, min_excess, rel_floor,
            )
            if finding is not None:
                findings.append(finding)
            continue
        # perfmodel prior: no history for this key. The calibrated
        # prediction is the preferred baseline when the row
        # was priced against a table — it tracks absolute makespans, so
        # PRIOR_FACTOR over it is a far tighter net than over the raw
        # bound; rows stamped uncalibrated (NaN) fall back to the
        # analytical lower bound, behavior unchanged.
        prior = "calibrated"
        predicted_s = finite(row.get("predicted_cal_s"))
        if predicted_s is None or predicted_s <= 0.0:
            prior = "analytical"
            predicted_s = finite(row.get("predicted_s"))
        if predicted_s is None or predicted_s <= 0.0:
            continue
        predicted_ms = predicted_s * 1e3
        ratio = measured / predicted_ms
        if ratio > prior_factor:
            findings.append(
                {
                    **_ident(row),
                    "key": key,
                    "metric": metric,
                    "source": "perfmodel_prior",
                    "prior": prior,
                    "measured_ms": measured,
                    "baseline_ms": predicted_ms,
                    "ratio": ratio,
                    "z": float("nan"),
                }
            )
    return _rank(findings)


def _ident(row: Dict[str, Any]) -> Dict[str, Any]:
    """The identity columns every finding carries — ONE definition, so
    the time gate and the SLO gate cannot drift apart on field shape."""
    return {
        "implementation": row.get("implementation"),
        "base_implementation": row.get("base_implementation"),
        "primitive": row.get("primitive"),
        "option": row.get("option"),
        "m": row.get("m"),
        "n": row.get("n"),
        "k": row.get("k"),
        "chip": row.get("chip"),
    }


def _history_finding(
    row: Dict[str, Any],
    key: str,
    metric: str,
    measured: float,
    stats: Dict[str, Any],
    direction: str,
    z_tol: float,
    min_excess: float,
    rel_floor: float,
    abs_floor: float = 0.0,
    abs_excess: float = 0.0,
) -> Optional[Dict[str, Any]]:
    """The history-backed gate core shared by ``detect``,
    ``detect_slo`` and ``detect_skew``: median+MAD z against the key's
    baseline, with ``direction`` deciding which way is worse ("high" =
    bigger is worse; "low" = smaller is worse, ``ratio`` oriented so >1
    always reads "this much worse"). ``abs_floor`` floors the noise
    scale and ``abs_excess`` demands an absolute worsening — both 0 for
    the time/SLO gates, nonzero for near-zero-baseline metrics (the
    skew columns) where relative machinery alone flags 3x-of-nothing.
    None when the row is within tolerance."""
    baseline = stats["median"]
    if baseline <= 0.0 and abs_floor <= 0.0:
        return None
    scale = max(stats["mad"], rel_floor * baseline, abs_floor)
    # ratio degrades to the robust scale as denominator when the true
    # denominator is 0 (a zero-skew clean baseline, a zeroed goodput):
    # still "this much worse", but FINITE — these findings land in
    # ``--json`` documents, and bare Infinity is not valid JSON
    if direction == "low":
        z = (baseline - measured) / scale if scale > 0 else float("inf")
        ratio = baseline / (measured if measured > 0 else scale)
        excess = baseline - measured
    else:
        z = (measured - baseline) / scale if scale > 0 else float("inf")
        ratio = measured / (baseline if baseline > 0.0 else scale)
        excess = measured - baseline
    if not (z > z_tol and ratio > 1.0 + min_excess and excess >= abs_excess):
        return None
    return {
        **_ident(row),
        "key": key,
        "metric": metric,
        "source": "history",
        "measured_ms": measured,
        "baseline_ms": baseline,
        "mad_ms": stats["mad"],
        "history_n": stats["n"],
        "history_runs": stats["runs"],
        "ratio": ratio,
        "z": z,
    }


def _rank(findings: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Health indictments first (a persistent-hardware verdict outranks
    any single-key regression — it predicts EVERY future run), then
    history-backed findings by robust z (worst first), then prior-only
    advisories by measured/predicted ratio — the one ranking rule
    shared by the time gate, the SLO gate, the health gate and their
    union."""
    health = [f for f in findings if f["source"] == "health"]
    history_backed = [f for f in findings if f["source"] == "history"]
    prior_only = [
        f for f in findings if f["source"] not in ("history", "health")
    ]
    health.sort(key=lambda f: -f.get("caused_s", 0.0))
    history_backed.sort(key=lambda f: -f["z"])
    prior_only.sort(key=lambda f: -f["ratio"])
    return health + history_backed + prior_only


def _detect_metrics(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    specs,
    exclude_run: Optional[str],
    z_tol: float,
    min_excess: float,
    rel_floor: float,
    decorate=None,
    min_history: int = 1,
) -> List[Dict[str, Any]]:
    """The one per-metric history gate the SLO and skew detectors
    share: every ``(metric, direction, abs_floor, abs_excess)`` spec
    gated per key against its own baseline (rows that don't carry a
    metric contribute nothing), ``decorate(finding, row)`` adding any
    metric-family extras, ``min_history`` withholding judgment until
    the baseline is deep enough to carry a spread estimate. Factored
    so the three gates ``detect_all`` merges can never drift apart on
    the gating loop itself."""
    findings: List[Dict[str, Any]] = []
    for metric, direction, abs_floor, abs_excess in specs:
        base = baselines(history, metric=metric, exclude_run=exclude_run)
        for row in current_rows:
            measured = finite(row.get(metric))
            if measured is None:
                continue
            key = row_key(row)
            stats = base.get(key)
            if stats is None or stats["n"] < min_history:
                continue
            finding = _history_finding(
                row, key, metric, measured, stats, direction,
                z_tol, min_excess, rel_floor,
                abs_floor=abs_floor, abs_excess=abs_excess,
            )
            if finding is not None:
                if decorate is not None:
                    decorate(finding, row)
                findings.append(finding)
    return _rank(findings)


def detect_slo(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    metrics=SLO_METRICS,
    exclude_run: Optional[str] = None,
    z_tol: float = Z_TOL,
    min_excess: float = MIN_EXCESS,
    rel_floor: float = REL_FLOOR,
    min_history: int = SLO_MIN_HISTORY,
) -> List[Dict[str, Any]]:
    """SLO-metric regression findings: every metric in
    ``metrics`` gated per key against its own per-key history baseline,
    with per-metric direction — a TTFT percentile regresses UP, goodput
    regresses DOWN. History-backed only (the perfmodel predicts a
    drain's time, not its percentile distribution, so there is no prior
    to fall back to); rows that don't carry a metric — every
    non-serving family — simply contribute nothing.

    Finding shape matches ``detect`` (``metric`` names the column;
    ``ratio`` is always worse/better oriented so >1 reads "this much
    worse" for both directions).

    SLO distributions are only comparable under the SAME cluster
    composition: a routed dp=2 row's TTFT tail, a
    disaggregated row's (handoff in the path), and a degraded row's
    (one shard drained mid-drill) are different populations, so
    history is fenced per ``serve_topology`` group — each current
    row gates only against records carrying ITS stamp. Unstamped
    history (rows banked before the cluster existed) folds into the
    legacy ``"single"`` bucket, so pre-cluster baselines keep gating
    single-engine rows instead of being orphaned by the new column.
    Each finding carries its ``serve_topology``. Elastic rows fence for free through the same mechanism: a run whose pools
    resized stamps an ``:elastic=R`` suffix (after any ``:degraded=K``),
    so transition-bearing latency distributions never pool with — or
    set the bar for — static baselines of the same nominal shape.

    Two robustness rails for the near-zero CPU regime:
    per-metric ABSOLUTE floors (``SLO_ABS``) so sub-millisecond host
    jitter never z-scores into a finding off a tiny baseline, and
    ``min_history`` (default ``SLO_MIN_HISTORY``) so the gate withholds
    judgment until the fenced per-key baseline actually carries a
    spread estimate — one banked row has identically-zero MAD, and a
    z against zero spread is not evidence.
    """
    specs = [
        (metric, direction, *SLO_ABS.get(metric, SLO_ABS_DEFAULT))
        for metric, direction in metrics
    ]

    def _topology(row: Dict[str, Any]) -> str:
        return str(row.get("serve_topology") or "") or "single"

    def _stamp_topology(finding, row):
        finding["serve_topology"] = _topology(row)

    findings: List[Dict[str, Any]] = []
    for topo in sorted({_topology(row) for row in current_rows}):
        rows = [row for row in current_rows if _topology(row) == topo]
        fenced = [
            rec
            for rec in history
            if _topology(rec.get("row") or {}) == topo
        ]
        findings.extend(
            _detect_metrics(
                rows,
                fenced,
                specs,
                exclude_run,
                z_tol,
                min_excess,
                rel_floor,
                decorate=_stamp_topology,
                min_history=min_history,
            )
        )
    return _rank(findings)


def detect_skew(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    metrics=SKEW_METRICS,
    exclude_run: Optional[str] = None,
    z_tol: float = Z_TOL,
    min_excess: float = MIN_EXCESS,
    rel_floor: float = REL_FLOOR,
) -> List[Dict[str, Any]]:
    """Cross-rank skew regression findings: every metric in
    ``metrics`` gated per key against its own history baseline — a row
    whose collectives suddenly wait much longer on a last arrival is a
    straggler regression even when its measured time barely moves (the
    timing MAX-reduce hides exactly this). History-backed only, with
    the per-metric absolute floors described at ``SKEW_METRICS`` so
    clean-run scheduler jitter can never alarm.

    Finding shape matches ``detect``; each finding additionally carries
    the row's ``straggler_rank`` and ``clock_unc_s`` so a report can
    name the culprit without re-reading the row. A ``skew_enter_s``
    excess inside the row's own clock-alignment uncertainty bound is
    dropped — differences below the bound are noise by definition (the
    fold carries it for exactly this) — and a row whose fold made NO
    alignment claim at all (``clock_unc_s`` NaN: too few exchanges to
    fit, raw possibly-cross-host stamps) never alarms on that metric.
    ``straggler_frac`` is unitless and keeps only its absolute floor.
    """

    def _name_straggler(finding, row):
        finding["straggler_rank"] = row.get("straggler_rank")
        if "clock_unc_s" in row:
            # None = the fold declined to align (NaN sentinel); rows
            # without the column at all (older schema) carry no key
            # and are not unc-gated
            finding["clock_unc_s"] = finite(row.get("clock_unc_s"))

    findings = _detect_metrics(
        current_rows,
        history,
        metrics,
        exclude_run,
        z_tol,
        min_excess,
        rel_floor,
        decorate=_name_straggler,
    )
    kept = []
    for finding in findings:
        if finding["metric"] == "skew_enter_s" and "clock_unc_s" in finding:
            unc = finding["clock_unc_s"]
            if unc is None:
                continue  # no alignment claim -> no skew-seconds claim
            if finding["measured_ms"] - finding["baseline_ms"] <= unc:
                continue  # inside the bound: noise by definition
        kept.append(finding)
    return kept


def detect_calibration(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    metrics=CAL_METRICS,
    exclude_run: Optional[str] = None,
    z_tol: float = Z_TOL,
    min_excess: float = MIN_EXCESS,
    rel_floor: float = REL_FLOOR,
) -> List[Dict[str, Any]]:
    """Calibration-drift findings: ``cal_residual_frac``
    gated per key against its own history baseline — a run whose
    measured medians drift off the fitted latency/overhead model is a
    model-validity alarm even when no single key regresses against raw
    history (a uniform +overhead shift moves EVERY residual but may
    stay inside each key's time-metric noise).

    Residual baselines are only comparable under the SAME fitted
    constants, so history is fenced to records stamped with one of the
    current rows' ``cal_version`` values — after a refit the gate
    starts a fresh baseline instead of alarming against residuals of a
    model that no longer exists. Rows without a finite residual (every
    uncalibrated row) contribute nothing; with no calibrated rows at
    all this is a no-op, keeping ``detect_all`` unchanged for
    uncalibrated worlds. Each finding carries ``cal_version``.
    """
    versions = {
        str(row.get("cal_version") or "")
        for row in current_rows
        if finite(row.get("cal_residual_frac")) is not None
    }
    versions.discard("")
    if not versions:
        return []
    fenced = [
        rec
        for rec in history
        if str((rec.get("row") or {}).get("cal_version") or "") in versions
    ]

    def _stamp_version(finding, row):
        finding["cal_version"] = row.get("cal_version")

    return _detect_metrics(
        current_rows,
        fenced,
        metrics,
        exclude_run,
        z_tol,
        min_excess,
        rel_floor,
        decorate=_stamp_version,
    )


def detect_health(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    exclude_run: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Persistent-straggler indictment finding: the health
    verdict (``observatory.health``) folded over the banked
    observations PLUS the current run's rows. At most one finding —
    ``metric="persistent_straggler"``, ``source="health"`` — and only
    when the CURRENT run contributes at least one qualifying
    observation naming the indicted rank: a bank whose old rows already
    indicted a since-replaced component must not re-flag every clean
    run after it forever."""
    from ddlb_tpu_torch.observatory import health

    hist_obs = health.observations_from_history(
        [
            r for r in history
            if not (exclude_run and r.get("run_id") == exclude_run)
        ]
    )
    cur_obs = health.observations_from_rows(current_rows)
    # the world size names the indicted rank's neighbor-link candidates
    # (link_candidates): the rows themselves carry it
    world = max(
        (
            int(w)
            for w in (
                finite(row.get("num_processes")) for row in current_rows
            )
            if w is not None and w > 1
        ),
        default=None,
    )
    verdict = health.verdict_from_observations(
        hist_obs + cur_obs, world=world
    )
    if verdict["status"] != health.PERSISTENT:
        return []
    rank = verdict["rank"]
    corroborating = [
        row
        for row, obs in zip(current_rows, cur_obs)
        if health.qualifying_rank(
            obs.get("rank"), obs.get("skew_s"), obs.get("unc_s"),
            health.MIN_SKEW_S,
        ) == rank
    ]
    if not corroborating:
        return []
    stats = verdict["per_rank"][rank]
    return [
        {
            **_ident(corroborating[0]),
            "key": "world",
            "metric": "persistent_straggler",
            "source": "health",
            "straggler_rank": rank,
            # report-compatible numeric fields: the caused skew is the
            # measured quantity, the healthy baseline is zero, and the
            # corroboration count stands in for the ratio column
            "measured_ms": stats["caused_s"] * 1e3,
            "baseline_ms": 0.0,
            "ratio": float(stats["count"]),
            "z": float("nan"),
            "caused_s": stats["caused_s"],
            "share": verdict["share"],
            "observations": stats["count"],
            "runs": stats["runs"],
            "links": verdict["links"],
            "reason": verdict["reason"],
        }
    ]


def detect_all(
    current_rows: List[Dict[str, Any]],
    history: List[Dict[str, Any]],
    exclude_run: Optional[str] = None,
    z_tol: float = Z_TOL,
    min_excess: float = MIN_EXCESS,
    rel_floor: float = REL_FLOOR,
    prior_factor: float = PRIOR_FACTOR,
) -> List[Dict[str, Any]]:
    """The full gate: the default time metric (``detect``, perfmodel
    prior included) PLUS every SLO metric (``detect_slo``) PLUS the
    cross-rank skew metrics (``detect_skew``) PLUS the calibration
    drift gate (``detect_calibration``) PLUS the persistent-straggler
    health verdict (``detect_health``), re-ranked as one list so a
    serving SLO blow-up, a straggler regression, a model-drift alarm or
    a hardware indictment competes with — and can outrank — a
    kernel-time regression in the same report."""
    return _rank(
        detect_health(
            current_rows,
            history,
            exclude_run=exclude_run,
        )
        + detect(
            current_rows,
            history,
            exclude_run=exclude_run,
            z_tol=z_tol,
            min_excess=min_excess,
            rel_floor=rel_floor,
            prior_factor=prior_factor,
        )
        + detect_slo(
            current_rows,
            history,
            exclude_run=exclude_run,
            z_tol=z_tol,
            min_excess=min_excess,
            rel_floor=rel_floor,
        )
        + detect_skew(
            current_rows,
            history,
            exclude_run=exclude_run,
            z_tol=z_tol,
            min_excess=min_excess,
            rel_floor=rel_floor,
        )
        + detect_calibration(
            current_rows,
            history,
            exclude_run=exclude_run,
            z_tol=z_tol,
            min_excess=min_excess,
            rel_floor=rel_floor,
        )
    )
