"""Calibration report: the fit's quality, the residuals, the drift gate.

The port's counterpart of the JAX package's ``scripts/calib_report.py``
(the same exit codes and ``--json`` document). It reads the bank
(``DDLB_TPU_HISTORY`` or ``--history DIR``) and the calibration table
(``DDLB_TPU_CALIB`` or ``--calib PATH``) and reports:

- **fit quality** a ``(chip, backend)`` group: the fitted constants
  (dispatch a row, overhead a step, latency a hop a link class), the
  rows and keys behind the fit, and the residual MAD;
- **residuals a key** over banked rows stamped with a finite
  ``cal_residual_frac``, worst first (``--top``);
- **prediction error before and after**: the median relative error of
  the analytical bound and of the calibrated prediction over every
  fit-eligible banked row (``calib.predict_row``);
- **the drift gate**: ``regress.detect_calibration`` on the latest run
  (or ``--run ID``) against its same-``cal_version`` history.

``--fit`` refits the table from the bank and writes it to ``--calib``
first. Exit code: 0 clean, 1 when drift findings fired, 2 usage.

    python -m ddlb_tpu_torch.cli.calib_report [--history DIR] [--calib PATH]
        [--fit] [--run ID] [--json] [--top N]
"""

from __future__ import annotations

import json
import math
import os
import sys

from ddlb_tpu_torch.observatory import calibrate, regress, store
from ddlb_tpu_torch.perfmodel import calib


def _finite(value):
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if math.isfinite(value) else None


def _median(values):
    values = sorted(values)
    if not values:
        return float("nan")
    mid = len(values) // 2
    if len(values) % 2:
        return values[mid]
    return 0.5 * (values[mid - 1] + values[mid])


def residual_distributions(records):
    """Per-key stats over banked rows stamped with a finite residual."""
    per_key = {}
    for record in records:
        if record.get("kind") != "row":
            continue
        row = record.get("row") or {}
        frac = _finite(row.get("cal_residual_frac"))
        if frac is None:
            continue
        key = record.get("key") or store.row_key(row)
        per_key.setdefault(key, {"row": row, "fracs": []})["fracs"].append(
            frac
        )
    stats = []
    for key, bucket in per_key.items():
        fracs = bucket["fracs"]
        med = _median(fracs)
        stats.append(
            {
                "key": key,
                "implementation": bucket["row"].get("implementation"),
                "primitive": bucket["row"].get("primitive"),
                "m": bucket["row"].get("m"),
                "n": bucket["row"].get("n"),
                "k": bucket["row"].get("k"),
                "rows": len(fracs),
                "median_frac": med,
                "worst_frac": max(fracs, key=abs),
            }
        )
    stats.sort(key=lambda s: -abs(s["median_frac"]))
    return stats


def before_after(records, table):
    """Median relative prediction error, analytical vs calibrated,
    over every fit-eligible banked row (stamped or not)."""
    before, after = [], []
    for record in records:
        if record.get("kind") != "row":
            continue
        row = record.get("row") or {}
        features = calib.row_features(row)
        if features is None:
            continue
        group = table.group(
            str(row.get("chip") or ""),
            str(row.get("time_measurement_backend") or "") or None,
        )
        if group is None:
            continue
        measured = float(features["measured_s"])
        predicted_cal = calib.predict_row(row, group)
        if predicted_cal is None or measured <= 0.0:
            continue
        before.append(
            abs(measured - float(features["predicted_s"])) / measured
        )
        after.append(abs(measured - predicted_cal) / measured)
    return {
        "rows": len(before),
        "median_rel_err_analytical": _median(before),
        "median_rel_err_calibrated": _median(after),
    }


def latest_run(records, run=None):
    """(current_rows, run_label, exclude_run) — latest banked run."""
    run_ids = [r.get("run_id") for r in records if r.get("kind") == "row"]
    run = run or (run_ids[-1] if run_ids else None)
    if run is None:
        return [], "(no runs banked)", None
    rows = [
        r["row"]
        for r in records
        if r.get("run_id") == run and r.get("kind") == "row"
    ]
    return rows, f"run {run}", run


def build_report(history_dir, calib_path, args):
    records = store.load_history(history_dir)
    table = None
    fitted = False
    if args.get("fit"):
        table = calibrate.calibrate_history(directory=history_dir)
        if table is not None and calib_path:
            calibrate.write_table(table, calib_path)
            fitted = True
    if table is None and calib_path:
        table = calib.load_table(calib_path)
    current, label, exclude = latest_run(records, args.get("run"))
    findings = (
        regress.detect_calibration(current, records, exclude_run=exclude)
        if current
        else []
    )
    report = {
        "history_dir": os.path.abspath(history_dir) if history_dir else "",
        "history_records": len(records),
        "calib_path": os.path.abspath(calib_path) if calib_path else "",
        "fitted": fitted,
        "table": table.to_json() if table is not None else None,
        "residuals": residual_distributions(records),
        "before_after": before_after(records, table) if table else None,
        "current": label,
        "current_rows": len(current),
        "drift_findings": findings,
    }
    return report


def print_report(report, top_n):
    print(f"calibration report — history {report['history_dir'] or '(unset)'}")
    table = report["table"]
    if table is None:
        print(
            "  no calibration table — pass --calib PATH (or set "
            "DDLB_TPU_CALIB), or refit from the bank with --fit"
        )
    else:
        print(
            f"  table {table['version']}"
            + (" (refit this run)" if report["fitted"] else "")
            + (f" @ {report['calib_path']}" if report["calib_path"] else "")
        )
        for key in sorted(table["groups"]):
            g = table["groups"][key]
            hops = ", ".join(
                f"{cls}={g['hop_s'][cls] * 1e6:.2f}us"
                for cls in sorted(g["hop_s"])
            )
            print(
                f"    {key:<24} dispatch={g['dispatch_s'] * 1e6:.2f}us "
                f"step={g['step_s'] * 1e6:.2f}us hop[{hops}] "
                f"({g['rows']} rows / {g['keys']} keys, "
                f"residual MAD {g['residual_mad_s'] * 1e6:.2f}us)"
            )
    ba = report.get("before_after")
    if ba and ba["rows"]:
        print(
            f"  prediction error over {ba['rows']} banked row(s): "
            f"analytical {ba['median_rel_err_analytical'] * 100:.1f}% -> "
            f"calibrated {ba['median_rel_err_calibrated'] * 100:.1f}% "
            f"(median relative)"
        )
    residuals = report["residuals"]
    if residuals:
        print(
            f"\n  stamped residuals, {len(residuals)} key(s), "
            f"worst |median| first:"
        )
        for s in residuals[:top_n]:
            shape = f"{s.get('m')}x{s.get('n')}x{s.get('k')}"
            print(
                f"    {str(s['implementation'])[:22]:<22} {shape:<13} "
                f"median {s['median_frac'] * 100:+6.1f}%  "
                f"worst {s['worst_frac'] * 100:+6.1f}%  ({s['rows']} rows)"
            )
        if len(residuals) > top_n:
            print(f"    ... and {len(residuals) - top_n} more (--top)")
    else:
        print("  no stamped residuals banked yet (runs need DDLB_TPU_CALIB)")
    findings = report["drift_findings"]
    print(f"\n  drift gate — current = {report['current']}:")
    if not findings:
        print("    no calibration drift detected")
        return
    print(f"    {len(findings)} drift finding(s), worst first:")
    for i, f in enumerate(findings[:top_n], 1):
        shape = f"{f.get('m')}x{f.get('n')}x{f.get('k')}"
        print(
            f"    {i:>2} {str(f.get('implementation'))[:22]:<22} "
            f"{shape:<13} residual {f['measured_ms']:+.3f} vs baseline "
            f"{f['baseline_ms']:+.3f} (z={f.get('z', float('nan')):.1f}, "
            f"table {f.get('cal_version')})"
        )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    fit = "--fit" in argv
    argv = [a for a in argv if a != "--fit"]

    def _opt(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"calib_report: {flag} needs a value")
            value = argv[i + 1]
            del argv[i: i + 2]
            return value
        return default

    args = {"run": _opt("--run"), "fit": fit}
    top_n = int(_opt("--top", "10"))
    history_dir = _opt("--history") or os.environ.get(
        "DDLB_TPU_HISTORY", ""
    ).strip()
    calib_path = _opt("--calib") or os.environ.get(
        "DDLB_TPU_CALIB", ""
    ).strip()
    if argv:
        print(f"calib_report: unknown argument(s): {argv}")
        return 2
    if not history_dir:
        print(
            "calib_report: no history bank — pass --history DIR or set "
            "DDLB_TPU_HISTORY (runs bank automatically when it is set)"
        )
        return 2
    report = build_report(history_dir, calib_path, args)
    if as_json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print_report(report, top_n)
    return 1 if report["drift_findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
