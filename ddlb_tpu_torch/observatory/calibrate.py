"""Fit the calibration table from the banked run history.

The counterpart of the JAX package's ``observatory/calibrate.py``. The
bank (``store.py``) holds rows with both the analytical bound
(``predicted_s``) and the measured median. This module streams it a
``(chip, time_measurement_backend)`` group at a time (rows
``calib.row_features`` refuses are dropped), runs the robust fitter, and
writes the versioned table ``DDLB_TPU_CALIB`` can name. ``calib`` is the
model (features, fitter, table); this is the glue (bank streaming,
stamping, writing).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ddlb_tpu_torch.observatory import store
from ddlb_tpu_torch.perfmodel import calib


def collect_samples(
    directory: Optional[str] = None,
    records: Optional[Iterable[Dict[str, Any]]] = None,
    *,
    chip: Optional[str] = None,
    family: Optional[str] = None,
) -> Dict[Tuple[str, str], List[Dict[str, Any]]]:
    """Fit samples grouped per (chip, backend), streamed from the bank.

    ``records`` replaces the bank read (a list of banked records);
    otherwise ``store.iter_history`` streams ``kind="row"`` records under
    the optional chip/family filters. Rows ``calib.row_features`` refuses
    (errors, serving families, unmeasured) are dropped.
    """
    if records is None:
        records = store.iter_history(directory, kind="row", chip=chip, family=family)
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for record in records:
        row = record.get("row") if isinstance(record, dict) else None
        if not isinstance(row, dict):
            continue
        features = calib.row_features(row)
        if features is None:
            continue
        row_chip = str(row.get("chip") or "")
        if not row_chip:
            continue
        backend = str(row.get("time_measurement_backend") or "")
        groups.setdefault((row_chip, backend), []).append(features)
    return groups


def collect_kv_samples(
    directory: Optional[str] = None,
    records: Optional[Iterable[Dict[str, Any]]] = None,
    *,
    chip: Optional[str] = None,
    family: Optional[str] = None,
) -> Dict[Tuple[str, str], List[Dict[str, Any]]]:
    """KV-handoff fit samples grouped per (chip, backend): the serving
    rows the residual fit excludes (``calib.kv_row_features``)."""
    if records is None:
        records = store.iter_history(
            directory, kind="row", chip=chip, family=family
        )
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for record in records:
        row = record.get("row") if isinstance(record, dict) else None
        if not isinstance(row, dict):
            continue
        features = calib.kv_row_features(row)
        if features is None:
            continue
        row_chip = str(row.get("chip") or "")
        if not row_chip:
            continue
        backend = str(row.get("time_measurement_backend") or "")
        groups.setdefault((row_chip, backend), []).append(features)
    return groups


def calibrate_history(
    directory: Optional[str] = None,
    records: Optional[Iterable[Dict[str, Any]]] = None,
    *,
    chip: Optional[str] = None,
    family: Optional[str] = None,
    min_rows: int = calib.MIN_ROWS,
) -> Optional[calib.CalibrationTable]:
    """Fit every (chip, backend) group the bank can support.

    Groups too thin to trust are skipped (the fitter returns None below
    ``min_rows``); the table carries only groups that fit. None when
    nothing fit: an empty table must not pass for a calibrated one.

    The KV-handoff constants ride the same table: serving rows with a
    handoff ledger fit ``kv_setup_s``/``kv_per_byte_s`` a group and join
    that group's residual fit, or stand alone as a group whose residual
    constants are zero. ``records``, when given, feeds both fits.
    """
    if records is not None:
        records = list(records)
    groups = collect_samples(directory, records, chip=chip, family=family)
    fitted: Dict[Tuple[str, str], calib.GroupCalibration] = {}
    for (group_chip, backend), samples in sorted(groups.items()):
        fit = calib.fit_group(
            samples, chip=group_chip, backend=backend, min_rows=min_rows
        )
        if fit is not None:
            fitted[(group_chip, backend)] = fit
    kv_groups = collect_kv_samples(
        directory, records, chip=chip, family=family
    )
    for (group_chip, backend), samples in sorted(kv_groups.items()):
        kv = calib.fit_kv_group(samples, min_rows=min_rows)
        if kv is None:
            continue
        setup_s, per_byte_s, kv_rows = kv
        base = fitted.get((group_chip, backend)) or calib.GroupCalibration(
            chip=group_chip, backend=backend, dispatch_s=0.0, step_s=0.0
        )
        fitted[(group_chip, backend)] = dataclasses.replace(
            base,
            kv_setup_s=setup_s,
            kv_per_byte_s=per_byte_s,
            kv_rows=kv_rows,
        )
    if not fitted:
        return None
    return calib.make_table(
        fitted, git_rev=store.git_rev(), banked_at=time.time()
    )


def write_table(table: calib.CalibrationTable, path: str) -> str:
    """Write a fitted table where ``DDLB_TPU_CALIB`` can name it."""
    calib.save_table(table, path)
    return path
