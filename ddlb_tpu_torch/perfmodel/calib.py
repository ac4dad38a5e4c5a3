"""Calibration constants fitted from banked run history.

The counterpart of the JAX package's ``perfmodel/calib.py``, stdlib only
and deterministic. The analytical model (``cost.py``) is a pure
bandwidth/FLOP lower bound; a collective is better modelled as bandwidth
plus a per-hop latency plus software overhead, and those two extra terms
are what the banked history's (predicted, measured) pairs can fit. Per
``(chip, time_measurement_backend)`` group an iteratively reweighted
least-absolute-deviation fit (robust to a shared host's slow rows) gives:

- ``dispatch_s``  -- fixed overhead a row (dispatch, sync, timer);
- ``step_s``      -- software overhead a schedule step (every compute and
  every wire step);
- ``hop_s[link]`` -- latency a hop of each link class (``ici`` / ``dcn``).

The residual model of a banked row is linear in the constants::

    measured_s - predicted_s = dispatch_s + step_s * steps
                               + sum_c hop_s[c] * hops[c]

with the step/hop census of ``schedule_census``, which
``cost.calibrated_estimate`` shares, so the fitted constants price a live
member and a banked row alike. A second fit, of the serving rows'
handoff ledger, gives ``kv_setup_s`` and ``kv_per_byte_s``
(``kv_row_features``, ``fit_kv_group``). A tiny ridge makes collinear
designs (wire-only groups, where steps equal hops) solve to one answer;
predictions only use ``step_s + hop_s`` summed, so that split never
matters.

Tables persist as versioned JSON with fit metadata (rows, keys, residual
MAD, git revision, time banked). ``DDLB_TPU_CALIB`` names the table the
runner stamps rows from; with no table every consumer returns None or adds
zero, and rows keep their defaults.

``family_op`` reads ``FAMILY_COLLECTIVES``, a copy of the JAX package's
``simulator/frontends.FAMILY_COLLECTIVES`` (the port has no simulator).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from ddlb_tpu_torch.perfmodel.cost import canonical_op, ring_step_count

#: env naming the calibration table the runner stamps rows from
CALIB_ENV = "DDLB_TPU_CALIB"

#: link classes the fitter distinguishes; a transport or scope maps onto
#: them through scope_link_class (dcn -> dcn, everything else is an ici
#: hop inside a node)
LINK_CLASSES: Tuple[str, ...] = ("ici", "dcn")

#: table format version (the file layout, not the fit identity — that
#: is the sha-fingerprinted ``version`` string).
TABLE_FORMAT = 1

#: minimum rows per (chip, backend) group before a fit is trusted.
MIN_ROWS = 8

#: families whose measured time is not a schedule replay (arrival
#: horizons, open-loop drains) — their residuals would poison the fit.
FIT_FAMILY_EXCLUDE: Tuple[str, ...] = ("serving_load",)

#: families whose rows carry the KV-handoff ledger the kv fit consumes
#: (serving rows are the only place handoffs happen)
KV_FIT_FAMILIES: Tuple[str, ...] = ("serving_load",)


#: the collective each family's wire rides (the JAX package's
#: ``simulator/frontends.FAMILY_COLLECTIVES``)
FAMILY_COLLECTIVES: Dict[str, str] = {
    "tp_columnwise": "all_gather",
    "tp_rowwise": "reduce_scatter",
    "dp_allreduce": "all_reduce",
    "ep_alltoall": "all_to_all",
    "cp_ring_attention": "ppermute",
    "pp_pipeline": "ppermute",
    "collectives": "all_reduce",
}


def scope_link_class(scope: str) -> str:
    """A transport or wire scope -> its fit link class."""
    return "dcn" if str(scope) == "dcn" else "ici"


def family_op(family: str, options: Optional[Mapping[str, object]] = None) -> str:
    """The ring collective a family's members run (census vocabulary):
    the ``op`` option of the collectives family, ``FAMILY_COLLECTIVES``
    for the others, ppermute for a family with no collective (its census
    has no wire step, so the choice is inert)."""
    if family == "collectives":
        op = str((options or {}).get("op", "all_reduce"))
    else:
        op = FAMILY_COLLECTIVES.get(str(family), "ppermute")
    return canonical_op(op)


def schedule_census(
    op: str,
    d: int,
    *,
    has_compute: bool,
    has_wire: bool,
    chunks: Optional[int] = None,
    link_class: str = "ici",
) -> Dict[str, object]:
    """Step/hop counts of a member's schedule: ``max(1,
    ring_step_count(op, d))`` wire steps when the wire term is non-zero
    (else 0), one compute step when the compute term is non-zero, both
    repeated a chunk by a chunked pipeline; one hop a wire step. The
    fitter (from a banked row's columns) and ``cost.calibrated_estimate``
    (from a live member) both read it, so the two agree by construction.
    """
    d = max(1, int(d))
    repeat = max(1, int(chunks)) if chunks else 1
    count = max(1, ring_step_count(canonical_op(op), d)) if has_wire else 0
    wire_steps = count * repeat
    compute_steps = repeat if has_compute else 0
    hops = {cls: 0 for cls in LINK_CLASSES}
    if wire_steps:
        hops[link_class if link_class in hops else "ici"] = wire_steps
    return {
        "wire_steps": wire_steps,
        "compute_steps": compute_steps,
        "steps": wire_steps + compute_steps,
        "hops": hops,
    }


# ---------------------------------------------------------------------------
# row features: banked history row -> fit sample
# ---------------------------------------------------------------------------


def _fnum(value: object) -> Optional[float]:
    try:
        out = float(value)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return None
    return out if out == out and out not in (float("inf"), float("-inf")) else None


def _truthy(value: object) -> bool:
    return str(value).strip().lower() in ("1", "true", "yes", "on")


def _parse_options(option: object) -> Dict[str, object]:
    """The ``;``-joined ``k=v`` option string -> a dict, with booleans,
    integers and floats inferred."""
    out: Dict[str, object] = {}
    for part in str(option or "").split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, raw = part.partition("=")
        raw = raw.strip()
        value: object = raw
        low = raw.lower()
        if low in ("true", "false"):
            value = low == "true"
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = raw
        out[key.strip()] = value
    return out


def row_features(row: Mapping[str, object]) -> Optional[Dict[str, object]]:
    """Fit sample from one banked history row; None when ineligible.

    Eligible rows are clean measurements on full worlds: no error, not
    quarantined, not world-degraded (limp-mode constants are a
    different machine), finite positive measured median, finite
    analytical prediction, and a family whose measured time is a
    schedule replay. The step/hop census is derived from columns every
    measured row already carries (the attribution phases say whether
    compute/wire terms exist; the option string carries transport and
    chunking).
    """
    if str(row.get("error") or "").strip():
        return None
    if _truthy(row.get("quarantined")) or _truthy(row.get("world_degraded")):
        return None
    family = str(row.get("primitive") or "")
    if not family or family in FIT_FAMILY_EXCLUDE:
        return None
    measured_ms = _fnum(row.get("median time (ms)"))
    predicted = _fnum(row.get("predicted_s"))
    if measured_ms is None or measured_ms <= 0.0:
        return None
    if predicted is None or predicted < 0.0:
        return None
    d_raw = _fnum(row.get("world_size"))
    if d_raw is None or d_raw < 1:
        return None
    d = int(d_raw)
    options = _parse_options(row.get("option"))
    transport = str(options.get("transport", "ici"))
    link_class = scope_link_class(transport)
    has_compute = (_fnum(row.get("phase_compute_s")) or 0.0) > 0.0
    has_wire = (_fnum(row.get("phase_comm_s")) or 0.0) > 0.0
    chunks: Optional[int] = None
    if str(options.get("algorithm", "")) == "chunked":
        chunk_count = _fnum(options.get("chunk_count"))
        if chunk_count and chunk_count >= 1:
            chunks = int(chunk_count)
    try:
        census = schedule_census(
            family_op(family, options),
            d,
            has_compute=has_compute,
            has_wire=has_wire,
            chunks=chunks,
            link_class=link_class,
        )
    except (KeyError, ValueError):
        return None
    measured = measured_ms * 1e-3
    return {
        "measured_s": measured,
        "predicted_s": predicted,
        "residual_s": measured - predicted,
        "steps": census["steps"],
        "hops": census["hops"],
        "key": "|".join(
            str(row.get(col, ""))
            for col in ("primitive", "base_implementation", "option",
                        "m", "n", "k", "dtype", "world_size")
        ),
    }


def kv_row_features(row: Mapping[str, object]) -> Optional[Dict[str, object]]:
    """KV-handoff fit sample from one banked serving row; None when
    ineligible. The residual fit excludes serving rows (their time is an
    arrival horizon); this fit reads clean serving-cluster rows with a
    non-zero handoff ledger and models their cumulative handoff time
    (``serve_handoff_ms``) as::

        handoff_s = kv_setup_s * handoffs + kv_per_byte_s * bytes

    The port's handoff is priced, not performed
    (``serve/handoff.py``): ``serve_handoff_ms`` is the closed form's own
    price, on the card as on the CPU, so fitting it recovers the closed
    form. A fit that means something waits for a handoff that moves its
    bytes and is timed."""
    if str(row.get("error") or "").strip():
        return None
    if _truthy(row.get("quarantined")) or _truthy(row.get("world_degraded")):
        return None
    if str(row.get("primitive") or "") not in KV_FIT_FAMILIES:
        return None
    handoffs = _fnum(row.get("serve_handoffs"))
    nbytes = _fnum(row.get("serve_handoff_bytes"))
    total_ms = _fnum(row.get("serve_handoff_ms"))
    if not handoffs or handoffs <= 0.0:
        return None
    if nbytes is None or nbytes < 0.0:
        return None
    if total_ms is None or total_ms <= 0.0:
        return None
    return {
        "handoffs": float(handoffs),
        "bytes": float(nbytes),
        "handoff_s": total_ms * 1e-3,
        "key": "|".join(
            str(row.get(col, ""))
            for col in ("primitive", "base_implementation", "option",
                        "m", "n", "k", "dtype", "world_size")
        ),
    }


# ---------------------------------------------------------------------------
# the fitted table
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GroupCalibration:
    """Fitted constants + fit metadata for one (chip, backend) group."""

    chip: str
    backend: str
    dispatch_s: float
    step_s: float
    hop_s: Dict[str, float] = field(default_factory=dict)
    rows: int = 0
    keys: int = 0
    residual_mad_s: float = 0.0
    residual_mad_frac: float = 0.0
    iterations: int = 0
    converged: bool = True
    #: KV-handoff constants, fitted from serving rows' handoff ledger;
    #: kv_rows == 0 means unfitted (the closed form prices handoffs)
    kv_setup_s: float = 0.0
    kv_per_byte_s: float = 0.0
    kv_rows: int = 0

    def compute_overhead_s(self) -> float:
        """Additive overhead a compute step."""
        return self.step_s

    def kv_handoff_s(self, payload_bytes: float) -> Optional[float]:
        """Calibrated seconds one KV-bundle handoff of ``payload_bytes``
        costs (setup + per-byte wire); None when this group never fitted
        the kv constants — the caller falls back to the census closed
        form (``cost.kv_handoff_seconds``)."""
        if self.kv_rows <= 0:
            return None
        return self.kv_setup_s + self.kv_per_byte_s * max(
            0.0, float(payload_bytes)
        )

    def wire_overhead_s(self, link_class: str = "ici") -> float:
        """Additive overhead a wire step of ``link_class`` (step
        software overhead + one hop of link latency)."""
        return self.step_s + float(self.hop_s.get(link_class, self.hop_s.get("ici", 0.0)))

    def to_json(self) -> Dict[str, object]:
        return {
            "chip": self.chip,
            "backend": self.backend,
            "dispatch_s": self.dispatch_s,
            "step_s": self.step_s,
            "hop_s": dict(self.hop_s),
            "rows": self.rows,
            "keys": self.keys,
            "residual_mad_s": self.residual_mad_s,
            "residual_mad_frac": self.residual_mad_frac,
            "iterations": self.iterations,
            "converged": self.converged,
            "kv_setup_s": self.kv_setup_s,
            "kv_per_byte_s": self.kv_per_byte_s,
            "kv_rows": self.kv_rows,
        }

    @classmethod
    def from_json(cls, data: Mapping[str, object]) -> "GroupCalibration":
        return cls(
            chip=str(data.get("chip", "")),
            backend=str(data.get("backend", "")),
            dispatch_s=float(data.get("dispatch_s", 0.0)),  # type: ignore[arg-type]
            step_s=float(data.get("step_s", 0.0)),  # type: ignore[arg-type]
            hop_s={str(k): float(v) for k, v in dict(data.get("hop_s") or {}).items()},  # type: ignore[arg-type]
            rows=int(data.get("rows", 0)),  # type: ignore[arg-type]
            keys=int(data.get("keys", 0)),  # type: ignore[arg-type]
            residual_mad_s=float(data.get("residual_mad_s", 0.0)),  # type: ignore[arg-type]
            residual_mad_frac=float(data.get("residual_mad_frac", 0.0)),  # type: ignore[arg-type]
            iterations=int(data.get("iterations", 0)),  # type: ignore[arg-type]
            converged=bool(data.get("converged", True)),
            kv_setup_s=float(data.get("kv_setup_s", 0.0)),  # type: ignore[arg-type]
            kv_per_byte_s=float(data.get("kv_per_byte_s", 0.0)),  # type: ignore[arg-type]
            kv_rows=int(data.get("kv_rows", 0)),  # type: ignore[arg-type]
        )


@dataclass(frozen=True)
class CalibrationTable:
    """Versioned set of per-(chip, backend) fitted constants."""

    version: str
    git_rev: str = ""
    banked_at: float = 0.0
    groups: Dict[Tuple[str, str], GroupCalibration] = field(default_factory=dict)

    def group(
        self, chip: str, backend: Optional[str] = None
    ) -> Optional[GroupCalibration]:
        """Deterministic group lookup: exact (chip, backend) first,
        then the chip's host_clock fit, then the chip's first group in
        sorted backend order. None when the chip was never fitted."""
        chip = str(chip or "")
        if backend:
            exact = self.groups.get((chip, str(backend)))
            if exact is not None:
                return exact
        fallback = self.groups.get((chip, "host_clock"))
        if fallback is not None:
            return fallback
        for key in sorted(self.groups):
            if key[0] == chip:
                return self.groups[key]
        return None

    def to_json(self) -> Dict[str, object]:
        return {
            "format": TABLE_FORMAT,
            "version": self.version,
            "git_rev": self.git_rev,
            "banked_at": self.banked_at,
            "groups": {
                f"{chip}|{backend}": group.to_json()
                for (chip, backend), group in sorted(self.groups.items())
            },
        }

    @classmethod
    def from_json(cls, data: Mapping[str, object]) -> "CalibrationTable":
        groups: Dict[Tuple[str, str], GroupCalibration] = {}
        for raw in dict(data.get("groups") or {}).values():
            group = GroupCalibration.from_json(raw)
            groups[(group.chip, group.backend)] = group
        return cls(
            version=str(data.get("version", "")),
            git_rev=str(data.get("git_rev", "")),
            banked_at=float(data.get("banked_at", 0.0)),  # type: ignore[arg-type]
            groups=groups,
        )


def table_version(groups: Mapping[Tuple[str, str], GroupCalibration]) -> str:
    """Content fingerprint of the fitted constants: two tables with the
    same constants share a version; a refit that moves one changes it
    (the JAX package's fingerprint, so both fitters' tables compare)."""
    canonical = json.dumps(
        {
            f"{chip}|{backend}": {
                "dispatch_s": round(group.dispatch_s, 12),
                "step_s": round(group.step_s, 12),
                "hop_s": {k: round(v, 12) for k, v in sorted(group.hop_s.items())},
                "rows": group.rows,
                # kv constants enter the fingerprint only once fitted, so
                # a table without them keeps the version it had before
                **(
                    {
                        "kv_setup_s": round(group.kv_setup_s, 15),
                        "kv_per_byte_s": round(group.kv_per_byte_s, 18),
                        "kv_rows": group.kv_rows,
                    }
                    if group.kv_rows > 0
                    else {}
                ),
            }
            for (chip, backend), group in sorted(groups.items())
        },
        sort_keys=True,
    )
    return "v1-" + hashlib.sha256(canonical.encode()).hexdigest()[:10]


def make_table(
    groups: Mapping[Tuple[str, str], GroupCalibration],
    *,
    git_rev: str = "",
    banked_at: float = 0.0,
) -> CalibrationTable:
    return CalibrationTable(
        version=table_version(groups),
        git_rev=git_rev,
        banked_at=banked_at,
        groups=dict(groups),
    )


def save_table(table: CalibrationTable, path: str) -> None:
    """Atomic write (tmp + rename) so readers never see a torn table."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as handle:
        json.dump(table.to_json(), handle, indent=2, sort_keys=True)
        handle.write("\n")
    os.replace(tmp, path)


def load_table(path: str) -> Optional[CalibrationTable]:
    """Load a table from ``path``; None when missing/corrupt (warned
    once — a broken table must not take the sweep down)."""
    try:
        with open(path, encoding="utf-8") as handle:
            data = json.load(handle)
        if not isinstance(data, dict) or not data.get("groups"):
            raise ValueError("not a calibration table")
        return CalibrationTable.from_json(data)
    except (OSError, ValueError) as exc:
        _warn_once(path, f"calibration table unreadable at {path}: {exc}")
        return None


_WARNED_PATHS: set = set()


def _warn_once(path: str, message: str) -> None:
    if path in _WARNED_PATHS:
        return
    _WARNED_PATHS.add(path)
    from ddlb_tpu_torch.telemetry import warn

    warn(message)


_TABLE_CACHE: Dict[str, object] = {}


def get_table() -> Optional[CalibrationTable]:
    """The table ``DDLB_TPU_CALIB`` names, cached by (path, mtime): one
    env read a row when unset, one ``stat`` when set."""
    path = os.environ.get(CALIB_ENV, "").strip()
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        _warn_once(path, f"DDLB_TPU_CALIB points at a missing file: {path}")
        return None
    if _TABLE_CACHE.get("path") == path and _TABLE_CACHE.get("mtime") == mtime:
        return _TABLE_CACHE.get("table")  # type: ignore[return-value]
    table = load_table(path)
    _TABLE_CACHE.update(path=path, mtime=mtime, table=table)
    return table


# ---------------------------------------------------------------------------
# the IRLS-LAD fitter
# ---------------------------------------------------------------------------


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    if n == 0:
        return 0.0
    mid = n // 2
    return ordered[mid] if n % 2 else 0.5 * (ordered[mid - 1] + ordered[mid])


def _solve(matrix: List[List[float]], rhs: List[float]) -> Optional[List[float]]:
    """Gaussian elimination with partial pivoting; None when singular
    beyond what the ridge already regularized."""
    n = len(rhs)
    a = [row[:] + [rhs[i]] for i, row in enumerate(matrix)]
    for col in range(n):
        pivot = max(range(col, n), key=lambda r: abs(a[r][col]))
        if abs(a[pivot][col]) < 1e-300:
            return None
        a[col], a[pivot] = a[pivot], a[col]
        for row in range(col + 1, n):
            factor = a[row][col] / a[col][col]
            if factor:
                for j in range(col, n + 1):
                    a[row][j] -= factor * a[col][j]
    out = [0.0] * n
    for row in range(n - 1, -1, -1):
        acc = a[row][n] - sum(a[row][j] * out[j] for j in range(row + 1, n))
        out[row] = acc / a[row][row]
    return out


def _wls(
    design: Sequence[Sequence[float]],
    target: Sequence[float],
    weights: Sequence[float],
) -> Optional[List[float]]:
    """Weighted least squares via the normal equations with a tiny
    relative ridge — deterministic even on collinear designs."""
    p = len(design[0])
    ata = [[0.0] * p for _ in range(p)]
    atb = [0.0] * p
    for row, y, w in zip(design, target, weights):
        for j in range(p):
            wx = w * row[j]
            atb[j] += wx * y
            for l in range(j, p):
                ata[j][l] += wx * row[l]
    for j in range(p):
        for l in range(j):
            ata[j][l] = ata[l][j]
    ridge = 1e-9 * max(max(ata[j][j] for j in range(p)), 1e-30)
    for j in range(p):
        ata[j][j] += ridge
    return _solve(ata, atb)


def fit_group(
    samples: Iterable[Mapping[str, object]],
    *,
    chip: str = "",
    backend: str = "",
    min_rows: int = MIN_ROWS,
    max_iter: int = 50,
) -> Optional[GroupCalibration]:
    """IRLS least-absolute-deviation fit of one group's constants.

    Design columns: intercept (dispatch), total step count, per-class
    hop counts (classes absent from every sample are dropped). LAD via
    iteratively-reweighted least squares — weights ``1/max(|r|, eps)``
    -- is robust to the handful of grossly slow rows a shared host
    banks. Fully deterministic: fixed starting point (unweighted LSQ),
    fixed iteration cap, no randomness.

    Non-negativity is enforced by ACTIVE SET, not a naive end clamp:
    steps and hops are near-collinear (one hop per wire step), so the
    unconstrained optimum can split into a huge +step_s canceled by a
    negative hop_s — clamping the negative half without refitting
    would leave the positive half grossly overshooting. Instead the
    most negative constant is pinned to zero and the remaining columns
    refit, until every constant is >= 0 (a calibrated prediction only
    adds to the bound). None when the group is too thin to trust.
    """
    rows = [s for s in samples if _fnum(s.get("residual_s")) is not None]
    classes = sorted(
        {
            cls
            for s in rows
            for cls, hops in dict(s.get("hops") or {}).items()
            if hops
        }
    )
    width = 2 + len(classes)
    if len(rows) < max(min_rows, 2 * width):
        return None
    full = [
        [1.0, float(s.get("steps") or 0.0)]
        + [float(dict(s.get("hops") or {}).get(cls, 0.0)) for cls in classes]
        for s in rows
    ]
    target = [float(s["residual_s"]) for s in rows]
    eps = max(1e-12, 1e-6 * _median([abs(y) for y in target]))

    def _irls(design):
        theta = _wls(design, target, [1.0] * len(rows))
        if theta is None:
            return None
        iterations = 0
        converged = False
        for iterations in range(1, max_iter + 1):
            resid = [
                y - sum(x * t for x, t in zip(row, theta))
                for row, y in zip(design, target)
            ]
            weights = [1.0 / max(abs(r), eps) for r in resid]
            update = _wls(design, target, weights)
            if update is None:
                break
            delta = max(abs(a - b) for a, b in zip(update, theta))
            theta = update
            if delta <= 1e-12 + 1e-9 * max(abs(t) for t in theta):
                converged = True
                break
        return theta, iterations, converged

    active = list(range(width))
    theta = [0.0] * width
    iterations = 0
    converged = True
    while active:
        fitted = _irls([[row[j] for j in active] for row in full])
        if fitted is None:
            return None
        partial, iterations, converged = fitted
        if min(partial) >= 0.0:
            theta = [0.0] * width
            for j, value in zip(active, partial):
                theta[j] = value
            break
        worst = min(zip(active, partial), key=lambda jt: jt[1])[0]
        active.remove(worst)
    resid = [
        y - sum(x * t for x, t in zip(row, theta))
        for row, y in zip(full, target)
    ]
    center = _median(resid)
    mad_s = _median([abs(r - center) for r in resid])
    mad_frac = _median(
        [
            abs(r) / float(s["measured_s"])
            for r, s in zip(resid, rows)
            if _fnum(s.get("measured_s")) and float(s["measured_s"]) > 0.0
        ]
    )
    hop_s = {cls: theta[2 + i] for i, cls in enumerate(classes)}
    for cls in LINK_CLASSES:
        hop_s.setdefault(cls, 0.0)
    return GroupCalibration(
        chip=str(chip),
        backend=str(backend),
        dispatch_s=theta[0],
        step_s=theta[1],
        hop_s=hop_s,
        rows=len(rows),
        keys=len({str(s.get("key", "")) for s in rows}),
        residual_mad_s=mad_s,
        residual_mad_frac=mad_frac,
        iterations=iterations,
        converged=converged,
    )


def fit_kv_group(
    samples: Iterable[Mapping[str, object]],
    *,
    min_rows: int = MIN_ROWS,
    max_iter: int = 50,
) -> Optional[Tuple[float, float, int]]:
    """IRLS-LAD fit of the two KV-handoff constants from one group's
    serving-row samples (``kv_row_features`` shape). Returns
    ``(kv_setup_s, kv_per_byte_s, rows)`` or None below ``min_rows``.

    Design columns: handoff count, handoff bytes — NO intercept (a row
    with zero handoffs has zero handoff time by construction, and
    ``kv_row_features`` never emits one). Non-negativity by the same
    active-set rule as the residual fit: count and bytes are collinear
    when every bundle weighs the same (one trace, one model shape), so
    a naive clamp of a negative half would leave the positive half
    overshooting — pin it to zero and refit instead."""
    rows = [
        s for s in samples
        if _fnum(s.get("handoff_s")) is not None
        and float(s["handoff_s"]) > 0.0
    ]
    if len(rows) < max(min_rows, 4):
        return None
    full = [
        [float(s.get("handoffs") or 0.0), float(s.get("bytes") or 0.0)]
        for s in rows
    ]
    # column normalization: handoff counts (~1e1) and byte totals
    # (~1e7) sit orders of magnitude apart, and _wls's relative ridge
    # keys off the LARGEST diagonal — unscaled, it would crush the
    # count column's coefficient to zero on any realistic trace
    scales = [
        max((abs(row[j]) for row in full), default=0.0) or 1.0
        for j in range(2)
    ]
    full = [[row[j] / scales[j] for j in range(2)] for row in full]
    target = [float(s["handoff_s"]) for s in rows]
    eps = max(1e-15, 1e-6 * _median([abs(y) for y in target]))

    def _irls(design):
        theta = _wls(design, target, [1.0] * len(rows))
        if theta is None:
            return None
        for _ in range(max_iter):
            resid = [
                y - sum(x * t for x, t in zip(row, theta))
                for row, y in zip(design, target)
            ]
            weights = [1.0 / max(abs(r), eps) for r in resid]
            update = _wls(design, target, weights)
            if update is None:
                break
            delta = max(abs(a - b) for a, b in zip(update, theta))
            theta = update
            if delta <= 1e-15 + 1e-9 * max(abs(t) for t in theta):
                break
        return theta

    active = [0, 1]
    theta = [0.0, 0.0]
    while active:
        partial = _irls([[row[j] for j in active] for row in full])
        if partial is None:
            return None
        if min(partial) >= 0.0:
            theta = [0.0, 0.0]
            for j, value in zip(active, partial):
                theta[j] = value
            break
        worst = min(zip(active, partial), key=lambda jt: jt[1])[0]
        active.remove(worst)
    return theta[0] / scales[0], theta[1] / scales[1], len(rows)


def predict_row(
    row: Mapping[str, object], group: GroupCalibration
) -> Optional[float]:
    """Calibrated prediction for a banked row from its own columns (the
    linear residual model the fitter optimizes); None when the row is
    not eligible for the fit."""
    features = row_features(row)
    if features is None:
        return None
    overhead = group.dispatch_s + group.step_s * float(features["steps"])  # type: ignore[arg-type]
    for cls, hops in dict(features["hops"]).items():  # type: ignore[arg-type]
        overhead += float(group.hop_s.get(cls, 0.0)) * float(hops)
    return float(features["predicted_s"]) + overhead  # type: ignore[arg-type]
