"""Run-history store: an append-only JSONL bank of result rows across runs.

The counterpart of the JAX package's ``observatory/store.py``. With
``DDLB_TPU_HISTORY`` naming a directory, the sweep runner banks every row
rank 0 writes (``PrimitiveBenchmarkRunner.run``) into
``<dir>/history.jsonl``, one JSON line a row:

- ``key``: the cross-run identity (chip, family, base implementation,
  option string, shape, dtype, world size, timing backend), from the
  row's own columns;
- ``run_id``: one process's rows (``DDLB_TPU_RUN_ID`` names it, for
  processes that must share one);
- ``git_rev``: the checkout's revision ("" where it has no git state);
- ``banked_at``: epoch seconds; ``kind``: ``row``;
- ``row``: the result row, untouched.

The calibration fitter (``observatory/calibrate.py``), the regression
detector (``observatory/regress.py``), the simulator's gates
(``simulator/validate.py``) and the report CLIs read the bank. One
flushed line a row, so a killed run loses at most the row in flight; best
effort: an unwritable directory warns once and banking stops, never the
sweep.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Callable, Collection, Dict, Iterator, List, Optional, Union

from ddlb_tpu_torch import telemetry

#: env naming the bank's directory ("" = banking off)
HISTORY_ENV = "DDLB_TPU_HISTORY"
HISTORY_FILENAME = "history.jsonl"
#: env overriding the run id ("" = one made a process)
RUN_ID_ENV = "DDLB_TPU_RUN_ID"

#: the row columns that form the cross-run identity: what changes what
#: is measured is in, the measurement's outcome is out
KEY_COLUMNS = (
    "chip",
    "primitive",
    "base_implementation",
    "option",
    "m",
    "n",
    "k",
    "dtype",
    "world_size",
    "time_measurement_backend",
)

_run_id: Optional[str] = None
_git_rev: Optional[str] = None
_bank_failed: Optional[str] = None


def history_dir() -> str:
    """The ``DDLB_TPU_HISTORY`` directory, stripped ("" when unset)."""
    return os.environ.get(HISTORY_ENV, "").strip()


def run_id() -> str:
    """This process's run id: ``DDLB_TPU_RUN_ID`` when set (processes that
    must bank under one id, a run the regression detector then excludes
    from its own baseline), else a timestamp and pid made once."""
    global _run_id
    override = os.environ.get(RUN_ID_ENV, "").strip()
    if override:
        return override
    if _run_id is None:
        _run_id = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) + f"-p{os.getpid()}"
    return _run_id


def git_rev() -> str:
    """The checkout's short revision, read once a process; "" when the
    checkout has no readable git state."""
    global _git_rev
    if _git_rev is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        try:
            out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=repo,
                                 capture_output=True, text=True, timeout=10)
            _git_rev = out.stdout.strip() if out.returncode == 0 else ""
        except (OSError, subprocess.TimeoutExpired):
            _git_rev = ""
    return _git_rev


def row_key(row: Dict[str, Any]) -> str:
    """A row's cross-run identity: ``KEY_COLUMNS`` as a sorted JSON string
    (a missing column keys as None)."""
    return json.dumps({col: row.get(col) for col in KEY_COLUMNS},
                      sort_keys=True, default=str)


def history_path(directory: Optional[str] = None) -> Optional[str]:
    """The bank's file, or None when banking is off."""
    directory = directory or history_dir()
    if not directory:
        return None
    return os.path.join(directory, HISTORY_FILENAME)


def bank_row(row: Dict[str, Any], directory: Optional[str] = None) -> bool:
    """Append one result row to the bank; returns whether it was banked
    (False when banking is off or the write failed)."""
    global _bank_failed
    path = history_path(directory)
    if path is None or not isinstance(row, dict):
        return False
    record = {
        "key": row_key(row),
        "run_id": run_id(),
        "git_rev": git_rev(),
        "banked_at": time.time(),
        "kind": "row",
        "row": row,
    }
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=str) + "\n")
    except OSError as exc:
        if _bank_failed != path:  # one warning a path, not a row
            _bank_failed = path
            telemetry.warn(f"history bank {path} is not writable ({exc}); "
                           f"run history disabled for this process")
        return False
    return True


def _records(path: str) -> Iterator[Dict[str, Any]]:
    """Every well-formed record of the file, oldest first; a torn or
    corrupt line (a process killed mid-write) is skipped."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if isinstance(record, dict) and isinstance(record.get("row"), dict):
                yield record


def load_history(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every record in the bank, oldest first; empty when banking is off
    or the file is absent."""
    path = history_path(directory)
    if path is None or not os.path.exists(path):
        return []
    return list(_records(path))


def _matches(value: Any, want: Union[None, str, Collection[str]]) -> bool:
    if want is None:
        return True
    if isinstance(want, str):
        return value == want
    return value in want


def iter_history(
    directory: Optional[str] = None,
    *,
    kind: Optional[str] = "row",
    chip: Union[None, str, Collection[str]] = None,
    family: Union[None, str, Collection[str]] = None,
    impl: Union[None, str, Collection[str]] = None,
    predicate: Optional[Callable[[Dict[str, Any]], bool]] = None,
) -> Iterator[Dict[str, Any]]:
    """Stream banked records oldest first under filters: ``kind`` (None:
    every kind), ``chip`` / ``family`` / ``impl`` (one string or a
    collection, against the row's ``chip`` / ``primitive`` /
    ``base_implementation``), and ``predicate(record)``. Corrupt lines are
    skipped and unknown columns ride along, as in ``load_history``."""
    path = history_path(directory)
    if path is None or not os.path.exists(path):
        return
    for record in _records(path):
        if kind is not None and record.get("kind", "row") != kind:
            continue
        row = record["row"]
        if not (_matches(row.get("chip"), chip)
                and _matches(row.get("primitive"), family)
                and _matches(row.get("base_implementation"), impl)):
            continue
        if predicate is not None and not predicate(record):
            continue
        yield record
