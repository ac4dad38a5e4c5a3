"""Regression report: the current run against the run-history bank.

The port's counterpart of the JAX package's ``scripts/observatory_report.py``
(the same exit codes and ``--json`` document). It reads the bank
``DDLB_TPU_HISTORY`` (or ``--history DIR``) names, picks the CURRENT run
(the latest banked ``run_id``, ``--run ID``, or a sweep CSV with
``--current``) and runs ``observatory.regress.detect_all`` on it:

- **history-backed findings**: the measured median against the key's
  history median, scaled by the MAD (floored at 5% of the median), ranked
  by robust z;
- **prior-only advisories**: a key with no history is held to the
  perfmodel prior, and a row measuring more than ``--prior-factor`` (5x)
  its prediction is flagged, after every history-backed finding;
- the SLO, skew, calibration and health gates, in the same ranked list.

Exit code: 0 clean, 1 when regressions were found, 2 usage.

    python -m ddlb_tpu_torch.cli.observatory_report [--history DIR]
        [--current CSV | --run RUN_ID] [--json] [--top N]
        [--z-tol F] [--min-excess F] [--prior-factor F]
"""

from __future__ import annotations

import csv
import json
import os
import sys

from ddlb_tpu_torch.observatory import regress, store

#: identity columns that must compare as ints between a CSV (strings)
#: and banked rows (numbers) — key equality depends on it
_INT_COLUMNS = ("m", "n", "k", "world_size")


def _coerce(row):
    """Normalize one CSV row so its history key matches banked rows."""
    out = dict(row)
    for col in _INT_COLUMNS:
        try:
            out[col] = int(float(out[col]))
        except (KeyError, TypeError, ValueError):
            pass
    return out


def load_current(records, args):
    """(current_rows, run_label, exclude_run) per the CLI selection."""
    if args.get("current"):
        path = args["current"]
        with open(path, newline="", encoding="utf-8") as f:
            rows = [_coerce(r) for r in csv.DictReader(f)]
        return rows, f"CSV {path}", None
    run_ids = [r.get("run_id") for r in records if r.get("kind") == "row"]
    run = args.get("run") or (run_ids[-1] if run_ids else None)
    if run is None:
        return [], "(no runs banked)", None
    rows = [
        r["row"]
        for r in records
        if r.get("run_id") == run and r.get("kind") == "row"
    ]
    return rows, f"run {run}", run


def _drop_self_banked(records, current_rows):
    """Drop history records that are the CURRENT rows' own banked
    copies: a sweep run with DDLB_TPU_HISTORY set banks every row it
    writes to its CSV, so ``--current CSV`` would otherwise baseline
    against itself (identical key AND identical measured median — an
    exact self-match, so independent runs are never dropped)."""
    own = set()
    for row in current_rows:
        value = regress.finite(row.get(regress.MEASURE_COLUMN))
        if value is not None:
            own.add((regress.row_key(row), round(value, 9)))
    if not own:
        return records
    kept = []
    for record in records:
        row = record.get("row") or {}
        value = regress.finite(row.get(regress.MEASURE_COLUMN))
        key = record.get("key") or regress.row_key(row)
        if value is not None and (key, round(value, 9)) in own:
            continue
        kept.append(record)
    return kept


def build_report(history_dir, args):
    records = store.load_history(history_dir)
    current, label, exclude = load_current(records, args)
    banked_total = len(records)
    if args.get("current"):
        records = _drop_self_banked(records, current)
    self_excluded = banked_total - len(records)
    # the full gate: median time + every serving SLO percentile/goodput
    # column, one ranked list (regress.detect_all)
    findings = regress.detect_all(
        current,
        records,
        exclude_run=exclude,
        z_tol=float(args.get("z_tol", regress.Z_TOL)),
        min_excess=float(args.get("min_excess", regress.MIN_EXCESS)),
        prior_factor=float(args.get("prior_factor", regress.PRIOR_FACTOR)),
    )
    runs = {r.get("run_id") for r in records if r.get("kind") == "row"}
    return {
        "history_dir": os.path.abspath(history_dir) if history_dir else "",
        "history_records": banked_total,
        "history_baseline_records": len(records),
        "self_excluded": self_excluded,
        "history_runs": len(runs),
        "current": label,
        "current_rows": len(current),
        "measured_rows": sum(
            1
            for r in current
            if regress.finite(r.get(regress.MEASURE_COLUMN)) is not None
        ),
        "findings": findings,
    }


def print_report(report, top_n):
    print(
        f"observatory report — history {report['history_dir'] or '(unset)'}"
    )
    print(
        f"  {report['history_records']} banked rows across "
        f"{report['history_runs']} run(s); current = {report['current']} "
        f"({report['measured_rows']}/{report['current_rows']} rows "
        f"measured)"
    )
    if report.get("self_excluded"):
        print(
            f"  {report['self_excluded']} banked copy(ies) of the "
            f"current CSV's own rows excluded from the baseline"
        )
    findings = report["findings"]
    if not findings:
        print("  no regressions detected")
        return
    print(f"\n{len(findings)} regression(s), worst first:")
    print(
        f"  {'#':>2} {'impl':<18} {'shape':<13} "
        f"{'metric':<16} {'measured':>10} "
        f"{'baseline':>10} {'ratio':>6} {'z':>7}  source"
    )
    for i, f in enumerate(findings[:top_n], 1):
        shape = f"{f.get('m')}x{f.get('n')}x{f.get('k')}"
        z = f.get("z")
        z_txt = f"{z:7.1f}" if isinstance(z, float) and z == z else "      -"
        metric = str(f.get("metric") or regress.MEASURE_COLUMN)
        metric = metric.replace("median time (ms)", "median_ms")
        print(
            f"  {i:>2} {str(f.get('implementation'))[:18]:<18} "
            f"{shape:<13} {metric[:16]:<16} {f['measured_ms']:>9.3f}  "
            f"{f['baseline_ms']:>9.3f} {f['ratio']:>5.2f}x "
            f"{z_txt}  {f['source']}"
        )
    if len(findings) > top_n:
        print(f"  ... and {len(findings) - top_n} more (--top)")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]

    def _opt(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"observatory_report: {flag} needs a value")
            value = argv[i + 1]
            del argv[i: i + 2]
            return value
        return default

    args = {
        "current": _opt("--current"),
        "run": _opt("--run"),
        "z_tol": _opt("--z-tol", regress.Z_TOL),
        "min_excess": _opt("--min-excess", regress.MIN_EXCESS),
        "prior_factor": _opt("--prior-factor", regress.PRIOR_FACTOR),
    }
    top_n = int(_opt("--top", "20"))
    history_dir = _opt("--history") or os.environ.get(
        "DDLB_TPU_HISTORY", ""
    ).strip()
    if argv:
        print(f"observatory_report: unknown argument(s): {argv}")
        return 2
    if not history_dir:
        print(
            "observatory_report: no history bank — pass --history DIR or "
            "set DDLB_TPU_HISTORY (runs bank automatically when it is set)"
        )
        return 2
    report = build_report(history_dir, args)
    if as_json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print_report(report, top_n)
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
