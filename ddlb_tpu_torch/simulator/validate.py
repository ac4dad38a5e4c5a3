"""Simulator validation: the closed forms, the banked history, the fit.

The counterpart of the JAX package's ``simulator/validate.py``, three
gates that keep the simulator honest before a 4096-card ranking is
trusted:

1. **Closed-form agreement** (``closed_form_check``): on a degenerate
   flat one-node world, the replayed makespan of every family's
   representative member, and of the chunked variants at several pipeline
   depths, equals ``perfmodel.cost.estimate().predicted_s`` to float
   precision (``CLOSED_FORM_RTOL``). The engine's arbitration is thereby
   the cost model's combination rule, with the censuses shared.
2. **History join** (``history_check``): banked rows
   (``observatory.store``) are replayed through the closed-form
   front-end on a flat world of each row's chip and world size. A key's
   replay must (a) agree with the row's banked ``predicted_s`` within
   ``HISTORY_RTOL`` and (b) stay a lower bound on the measured median up
   to ``LOWER_BOUND_SLACK``. Families whose banked prediction depends on
   measurement-time state (the serving floor, the model families) join
   through (b) only.
3. **Calibration** (``calibration_check``): with a fitted table
   (``perfmodel.calib``) the calibrated replay of every reproducible key
   lands *within* ``CALIBRATION_RTOL`` of its measured median,
   two-sided.

``build_stub`` makes an uninitialised member (the port's registry; no
operand, no device) carrying what the censuses read. The member-twin gate
(``member_twin_check``, which replays traced members) waits for the
SPMD interpreter of ``analysis/`` and is not ported.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.observatory.regress import finite, median
from ddlb_tpu_torch.perfmodel.cost import estimate
from ddlb_tpu_torch.perfmodel.topology import Topology, flat_topology
from ddlb_tpu_torch.runtime import node_assignment
from ddlb_tpu_torch.simulator.engine import replay
from ddlb_tpu_torch.simulator.frontends import ProgramBuildError, program_from_impl

#: gate 1's bar: the engine and the cost model run the same float
#: arithmetic in another order, nothing more
CLOSED_FORM_RTOL = 1e-9

#: gate 2a: the replay against the row's banked prediction. Not zero:
#: banked rows may predate a formula fix (the bank keeps history)
HISTORY_RTOL = 0.05

#: gate 2b: the replay stays a lower bound on the measured median, with
#: slack for measurement noise
LOWER_BOUND_SLACK = 0.02

#: gate 3: the calibrated replay against the measured median, two-sided
CALIBRATION_RTOL = 0.05

#: families whose banked ``predicted_s`` is reproducible from the shape
#: alone: the gate-2a and gate-3 join set
REPRODUCIBLE_FAMILIES = (
    "tp_columnwise",
    "tp_rowwise",
    "dp_allreduce",
    "ep_alltoall",
    "cp_ring_attention",
    "pp_pipeline",
    "collectives",
)

#: gate 1's shapes: small, every member's divisibility met at d ranks
#: (the JAX package's ``analysis/spmd/families.FAMILY_SHAPES``)
FAMILY_SHAPES: Dict[str, Dict[str, int]] = {
    "tp_columnwise": {"m": 256, "n": 128, "k": 64, "d": 4},
    "tp_rowwise": {"m": 256, "n": 128, "k": 64, "d": 4},
    "dp_allreduce": {"m": 128, "n": 64, "k": 64, "d": 4},
    "ep_alltoall": {"m": 256, "n": 64, "k": 64, "d": 4},
    "cp_ring_attention": {"m": 128, "n": 64, "k": 16, "d": 4},
    "pp_pipeline": {"m": 128, "n": 64, "k": 64, "d": 4},
    "collectives": {"m": 256, "n": 1, "k": 64, "d": 4},
    "transformer_step": {"m": 64, "n": 64, "k": 64, "d": 4},
    "transformer_decode": {"m": 64, "n": 64, "k": 64, "d": 4},
    "serving_load": {"m": 16, "n": 32, "k": 64, "d": 4},
}

#: the representative member and its overrides a family, for gate 1
#: (the JAX package's, with the port's member names)
REPRESENTATIVES: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "tp_columnwise": ("pytorch", {}),
    "tp_rowwise": ("pytorch", {}),
    "dp_allreduce": ("pytorch", {}),
    "ep_alltoall": ("pytorch", {}),
    "cp_ring_attention": ("ring", {}),
    "pp_pipeline": ("pytorch", {}),
    "transformer_step": ("compute_only", {}),
    "transformer_decode": ("spmd", {}),
    "serving_load": ("static", {}),
    "collectives": ("pytorch", {}),
}

#: the chunked-engine depths gate 1 also replays for every family with
#: an ``overlap`` member: the pipeline's fill/drain law, not just its floor
CHUNKED_VARIANTS = (1, 2, 4)


class _RuntimeProbe:
    """The runtime attributes the shape-only censuses read: the world's
    size and its nodes (``DDLB_TPU_SIM_SLICES`` splits it as
    ``Runtime`` does; one node otherwise)."""

    def __init__(self, num_devices: int, sim_slices: int = 0) -> None:
        if not sim_slices:
            value = os.environ.get("DDLB_TPU_SIM_SLICES", "").strip()
            sim_slices = int(value) if value else 0
        self.num_devices = self.world_size = int(num_devices)
        self.slice_ids = node_assignment(self.world_size, self.world_size, sim_slices)
        self.num_slices = len(set(self.slice_ids))
        self.platform = "cpu"
        self.num_processes = 1


def build_stub(family: str, member: str, m: int, n: int, k: int, d: int,
               dtype: str = "bfloat16", **options: Any):
    """An uninitialised member carrying only what the cost model and the
    closed-form front-end read: no operand, no device, no compile."""
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    cls = load_impl_class(family, member)
    impl = object.__new__(cls)
    impl.m, impl.n, impl.k = int(m), int(n), int(k)
    impl.dtype = dtype
    # the runner's seed: the serving censuses read the seeded workload
    impl.seed = 42
    impl.num_partitions = int(d)
    impl.runtime = _RuntimeProbe(d)
    defaults, _allowed = cls.option_schema()
    impl.options = {**defaults, **options}
    if family == "serving_load":
        # the one family whose censuses read the seeded host-built trace
        from ddlb_tpu_torch.workload import generate_trace

        impl._trace = generate_trace(impl.workload_spec())
    return impl


def _agreement(impl, topology: Topology) -> Dict[str, Any]:
    est = estimate(impl, topology.chip)
    got = replay(program_from_impl(impl, topology), topology).makespan_s
    want = est.predicted_s
    rel = abs(got - want) / want if want > 0.0 else abs(got - want)
    return {
        "family": impl.primitive_name,
        "member": type(impl).__name__,
        "options": dict(impl.options),
        "predicted_cost_s": want,
        "predicted_sim_s": got,
        "rel_err": rel,
        "ok": rel <= CLOSED_FORM_RTOL,
    }


def closed_form_check(chip: str = "h100-sxm", families: Optional[Sequence[str]] = None,
                      shapes: Optional[Dict[str, Dict[str, int]]] = None
                      ) -> List[Dict[str, Any]]:
    """Gate 1 (module docstring): one record a checked configuration; a
    record's ``ok=False`` is a simulator bug."""
    from ddlb_tpu_torch.primitives.registry import implementation_names

    shapes = shapes or FAMILY_SHAPES
    out: List[Dict[str, Any]] = []
    with telemetry.span("sim.validate", cat="sim", mode="closed-form"):
        for family, (member, overrides) in REPRESENTATIVES.items():
            if families is not None and family not in families:
                continue
            shp = shapes[family]
            topo = flat_topology(shp["d"], chip)
            impl = build_stub(family, member, shp["m"], shp["n"], shp["k"], shp["d"],
                              **overrides)
            out.append(_agreement(impl, topo))
            if "overlap" in implementation_names(family):
                for chunks in CHUNKED_VARIANTS:
                    impl = build_stub(family, "overlap", shp["m"], shp["n"], shp["k"],
                                      shp["d"], algorithm="chunked", chunk_count=chunks)
                    out.append(_agreement(impl, topo))
    return out


# -- the history join ---------------------------------------------------------------


def _infer_scalar(text: str) -> Any:
    """'true'/'false' -> bool, then int, then float, else the string."""
    low = str(text).strip().lower()
    if low == "true":
        return True
    if low == "false":
        return False
    for kind in (int, float):
        try:
            return kind(text)
        except (TypeError, ValueError):
            pass
    return str(text).strip()


def parse_option_string(option: str) -> Dict[str, Any]:
    """``'algorithm=chunked;chunk_count=2'`` -> a dict, scalars inferred."""
    out: Dict[str, Any] = {}
    for part in str(option or "").split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, value = part.partition("=")
        out[key.strip()] = _infer_scalar(value)
    return out


def _groups(records, skip_degraded: bool = False) -> Dict[str, List[Dict[str, Any]]]:
    """Error-free banked rows by history key."""
    from ddlb_tpu_torch.observatory.store import row_key

    groups: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("kind") != "row":
            continue
        row = rec["row"]
        if str(row.get("error", "") or "").strip():
            continue
        if skip_degraded and str(row.get("world_degraded", "")).strip().lower() in (
                "1", "true", "yes", "on"):
            continue
        groups.setdefault(row_key(row), []).append(row)
    return groups


def _measured(rows: List[Dict[str, Any]]) -> Optional[float]:
    """A key's measured median in seconds; None when its rows lack a
    median or the shape a stub needs."""
    row = rows[0]
    measured_s = median([v / 1e3 for v in (finite(r.get("median time (ms)")) for r in rows)
                         if v is not None and v > 0.0])
    world = finite(row.get("world_size"))
    if not math.isfinite(measured_s) or not world or world < 1 or not all(
            finite(row.get(dim)) for dim in ("m", "n", "k")):
        return None
    return measured_s


def _replay_row(row: Dict[str, Any], calibration=None) -> float:
    """The closed-form replay of a banked row on a flat world of its chip
    and size (``calibration``: a fitted group's constants on top)."""
    world = int(float(row["world_size"]))
    topo = flat_topology(world, str(row.get("chip") or "cpu"))
    impl = build_stub(row.get("primitive"), row.get("base_implementation"),
                      int(float(row["m"])), int(float(row["n"])), int(float(row["k"])), world,
                      dtype=str(row.get("dtype") or "bfloat16"),
                      **parse_option_string(row.get("option", "")))
    return replay(program_from_impl(impl, topo), topo, calibration=calibration).makespan_s


def history_check(directory: Optional[str] = None,
                  records: Optional[List[Dict[str, Any]]] = None,
                  rtol: float = HISTORY_RTOL,
                  lower_bound_slack: float = LOWER_BOUND_SLACK) -> Dict[str, Any]:
    """Gate 2 (module docstring): a summary with the violations; ``ok``
    is the verdict, and an empty bank is not a pass. A row that cannot be
    rebuilt (an unknown member, a missing column) counts as skipped."""
    from ddlb_tpu_torch.observatory.store import load_history

    if records is None:
        records = load_history(directory)
    checked = 0
    skipped: List[str] = []
    violations: List[Dict[str, Any]] = []
    with telemetry.span("sim.validate", cat="sim", mode="history"):
        for key, rows in sorted(_groups(records).items()):
            row = rows[0]
            family, member = row.get("primitive"), row.get("base_implementation")
            measured_s = _measured(rows)
            if measured_s is None:
                skipped.append(f"{family}/{member}: row lacks shape/median")
                continue
            try:
                sim_s = _replay_row(row)
            except (ProgramBuildError, ValueError, KeyError, TypeError) as exc:
                skipped.append(f"{family}/{member}: {exc}")
                continue
            checked += 1
            banked = finite(row.get("predicted_s"))
            if family not in REPRODUCIBLE_FAMILIES:
                banked = None
            if banked and banked > 0.0:
                rel = abs(sim_s - banked) / banked
                if rel > rtol:
                    violations.append({"key": key, "kind": "banked-prediction",
                                       "sim_s": sim_s, "banked_predicted_s": banked,
                                       "rel_err": rel})
            if sim_s > measured_s * (1.0 + lower_bound_slack):
                violations.append({"key": key, "kind": "lower-bound", "sim_s": sim_s,
                                   "measured_median_s": measured_s})
    return {
        "checked": checked,
        "skipped": len(skipped),
        "skipped_reasons": skipped,
        "violations": violations,
        "rtol": rtol,
        "lower_bound_slack": lower_bound_slack,
        "ok": checked > 0 and not violations,
    }


def calibration_check(directory: Optional[str] = None,
                      records: Optional[List[Dict[str, Any]]] = None,
                      table=None, rtol: float = CALIBRATION_RTOL) -> Dict[str, Any]:
    """Gate 3 (module docstring). Joins the reproducible keys; a key whose
    (chip, backend) has no fitted group is skipped, as are degraded-world
    rows. ``table`` defaults to ``DDLB_TPU_CALIB``'s; with no table the
    gate reports ``ok: False`` with its reason: an uncalibrated world is
    not a passing absolute check."""
    from ddlb_tpu_torch.observatory.store import load_history
    from ddlb_tpu_torch.perfmodel import calib

    if table is None:
        table = calib.get_table()
    summary: Dict[str, Any] = {
        "checked": 0,
        "skipped": 0,
        "skipped_reasons": [],
        "violations": [],
        "rtol": rtol,
        "table_version": getattr(table, "version", ""),
        "ok": False,
    }
    if table is None:
        summary["skipped_reasons"].append("no calibration table")
        summary["skipped"] = 1
        return summary
    if records is None:
        records = load_history(directory)
    checked = 0
    skipped: List[str] = []
    violations: List[Dict[str, Any]] = []
    with telemetry.span("sim.validate", cat="sim", mode="calibration"):
        for key, rows in sorted(_groups(records, skip_degraded=True).items()):
            row = rows[0]
            family, member = row.get("primitive"), row.get("base_implementation")
            if family not in REPRODUCIBLE_FAMILIES:
                skipped.append(f"{family}/{member}: family not reproducible")
                continue
            measured_s = _measured(rows)
            if measured_s is None:
                skipped.append(f"{family}/{member}: row lacks shape/median")
                continue
            chip = str(row.get("chip") or "cpu")
            group = table.group(chip, str(row.get("time_measurement_backend") or "") or None)
            if group is None:
                skipped.append(f"{family}/{member}: no fit for chip {chip}")
                continue
            try:
                sim_cal_s = _replay_row(row, calibration=group)
            except (ProgramBuildError, ValueError, KeyError, TypeError) as exc:
                skipped.append(f"{family}/{member}: {exc}")
                continue
            checked += 1
            rel = abs(sim_cal_s - measured_s) / measured_s
            if rel > rtol:
                violations.append({"key": key, "kind": "calibrated-absolute",
                                   "sim_cal_s": sim_cal_s,
                                   "measured_median_s": measured_s, "rel_err": rel})
    summary.update(checked=checked, skipped=len(skipped), skipped_reasons=skipped,
                   violations=violations, ok=checked > 0 and not violations)
    return summary
