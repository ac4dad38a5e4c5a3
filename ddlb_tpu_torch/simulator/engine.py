"""Discrete-event engine: replay one schedule program on one topology.

The counterpart of the JAX package's ``simulator/engine.py``. An
event-heap simulation over the representative device's resources
(``program.py`` says why one device is enough): a task is released when
its chain dependency finishes, each resource runs one task at a time, and
a free resource takes the *lowest program index* among its released tasks
(deterministic in-order issue a channel). No randomness and no wall
clock: identical inputs replay to identical timelines.

The replay emits a ``sim.replay`` span and counts its events into the
``sim.events`` metric (``telemetry/names.py``).

``ReplayResult``: the makespan, the per-task timeline, busy seconds and
payload a resource, the overlap fraction (hidden / hideable; NaN when
the schedule has no hideable window, the convention of the
``measured_overlap_frac`` column), and the per-link utilization with
``flat`` bytes attributed to the classes their hops cross.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.perfmodel.calib import scope_link_class
from ddlb_tpu_torch.perfmodel.topology import Topology
from ddlb_tpu_torch.simulator.program import ComputeStep, HbmStep, ScheduleProgram


@dataclass(frozen=True)
class TimelineEntry:
    """One executed task: where it ran and when."""

    index: int
    stage: int
    label: str
    resource: str
    start_s: float
    finish_s: float


@dataclass
class ReplayResult:
    """Everything one replay predicts."""

    program: str
    topology: str
    makespan_s: float
    timeline: List[TimelineEntry]
    busy_s: Dict[str, float]
    payload: Dict[str, float]  # resource -> FLOPs (mxu) or bytes
    events: int
    meta: dict = field(default_factory=dict)

    @property
    def compute_busy_s(self) -> float:
        return self.busy_s.get("mxu", 0.0)

    @property
    def comm_busy_s(self) -> float:
        return sum(
            s for r, s in self.busy_s.items() if r not in ("mxu", "hbm")
        )

    @property
    def overlap_frac(self) -> float:
        """Hidden / hideable over the compute and wire tracks; NaN when
        the schedule has no hideable window (either track empty) —
        mirrors the ``measured_overlap_frac`` schema convention."""
        compute, comm = self.compute_busy_s, self.comm_busy_s
        hideable = min(compute, comm)
        if hideable <= 0.0:
            return float("nan")
        hidden = compute + comm - self.makespan_s
        return max(0.0, min(1.0, hidden / hideable))

    def link_utilization(self, topology: Topology) -> Dict[str, Dict[str, float]]:
        """Per link class: busy fraction of the makespan and bytes one
        chip moved over it, with ``flat`` ring steps' bytes additionally
        attributed to the physical classes their hops cross."""
        out: Dict[str, Dict[str, float]] = {}
        span = self.makespan_s or float("nan")
        flat_split = topology.flat_hop_fractions()
        for res in topology.comm_resources():
            bytes_res = self.payload.get(res, 0.0)
            if res != "flat":
                bytes_res += self.payload.get("flat", 0.0) * flat_split.get(
                    res, 0.0
                )
            out[res] = {
                "busy_frac": self.busy_s.get(res, 0.0) / span,
                "bytes": bytes_res,
            }
        return out


def _duration(step, topology: Topology, calibration=None) -> float:
    """One task's duration; ``calibration`` (a fitted
    ``calib.GroupCalibration``, duck-typed) prices the additive
    latency/overhead terms on top of the bandwidth/FLOP floor: every
    ComputeStep pays one step of software overhead, every WireStep one
    step plus one hop of its link class (``flat``/``ici*`` scopes are
    ici hops, ``dcn`` is a dcn hop). HbmStep is untouched — the HBM
    term is a byte census, not a dispatched schedule step. None adds
    exactly zero, preserving gate 1's float-precision agreement with
    the uncalibrated closed form by construction."""
    if isinstance(step, ComputeStep):
        base = step.flops / topology.resource_rate("mxu", step.dtype)
        if calibration is not None:
            base += calibration.compute_overhead_s()
        return base
    if isinstance(step, HbmStep):
        return step.nbytes / topology.resource_rate("hbm")
    rate = topology.resource_rate(step.resource)
    if rate <= 0.0:
        # a downed link (Degradation overlay): the step never completes —
        # an unroutable program honestly replays to an infinite makespan
        # instead of crashing, so degraded rankings can SHOW the outage
        return math.inf if step.nbytes > 0.0 else 0.0
    base = step.nbytes / rate
    if calibration is not None:
        base += calibration.wire_overhead_s(scope_link_class(step.resource))
    return base


def replay(
    program: ScheduleProgram, topology: Topology, calibration=None
) -> ReplayResult:
    """Replay ``program`` on ``topology``; see module docstring.

    ``calibration`` (optional fitted constants for the world's chip +
    timing backend) turns the lower-bound replay into an absolute
    prediction: per-step terms via ``_duration`` plus the fixed
    ``dispatch_s`` once on the makespan — the quantities validation
    gate 3 holds against banked measured medians.
    """
    with telemetry.span(
        "sim.replay", cat="sim", program=program.name, topo=topology.name
    ):
        return _replay(program, topology, calibration)


def _replay(
    program: ScheduleProgram, topology: Topology, calibration=None
) -> ReplayResult:
    flat: List[Tuple[int, object, Optional[int]]] = [
        (si, step, dep) for si, _ji, step, dep in program.tasks()
    ]
    n = len(flat)
    durations = [
        _duration(step, topology, calibration) for _si, step, _dep in flat
    ]
    children: Dict[int, List[int]] = {}
    indegree = [0] * n
    for idx, (_si, _step, dep) in enumerate(flat):
        if dep is not None:
            children.setdefault(dep, []).append(idx)
            indegree[idx] = 1

    #: released-but-not-started tasks per resource, lowest index first
    queues: Dict[str, List[int]] = {}
    idle: Dict[str, bool] = {}
    busy_s: Dict[str, float] = {}
    payload: Dict[str, float] = {}
    finish = [0.0] * n
    start = [0.0] * n
    done = [False] * n
    timeline: List[TimelineEntry] = []

    events: List[Tuple[float, int, int]] = []  # (time, seq, task)
    seq = 0

    def release(idx: int) -> None:
        res = flat[idx][1].resource
        heapq.heappush(queues.setdefault(res, []), idx)
        idle.setdefault(res, True)

    def start_task(res: str, now: float) -> None:
        nonlocal seq
        if not idle.get(res, True) or not queues.get(res):
            return
        idx = heapq.heappop(queues[res])
        idle[res] = False
        start[idx] = now
        finish[idx] = now + durations[idx]
        seq += 1
        heapq.heappush(events, (finish[idx], seq, idx))

    for idx in range(n):
        if indegree[idx] == 0:
            release(idx)
    for res in list(queues):
        start_task(res, 0.0)

    processed = 0
    while events:
        now, _s, idx = heapq.heappop(events)
        processed += 1
        done[idx] = True
        si, step, _dep = flat[idx]
        res = step.resource
        idle[res] = True
        busy_s[res] = busy_s.get(res, 0.0) + durations[idx]
        qty = step.flops if isinstance(step, ComputeStep) else step.nbytes
        payload[res] = payload.get(res, 0.0) + qty
        timeline.append(
            TimelineEntry(
                index=idx,
                stage=si,
                label=getattr(step, "tag", "") or type(step).__name__,
                resource=res,
                start_s=start[idx],
                finish_s=finish[idx],
            )
        )
        for child in children.get(idx, ()):
            release(child)
        # the freed resource first, then any resource a release touched
        start_task(res, now)
        for other in list(queues):
            start_task(other, now)

    telemetry.record("sim.events", processed)
    makespan = max((e.finish_s for e in timeline), default=0.0)
    meta = dict(program.meta)
    if calibration is not None:
        makespan += calibration.dispatch_s
        meta["calibration"] = {
            "chip": calibration.chip,
            "backend": calibration.backend,
        }
    if not all(done):  # pragma: no cover - would mean a malformed IR
        stuck = [i for i, d in enumerate(done) if not d]
        raise RuntimeError(
            f"replay of {program.name} deadlocked with tasks {stuck[:8]} "
            f"unexecuted — the schedule IR produced an unsatisfiable "
            f"dependency"
        )
    return ReplayResult(
        program=program.name,
        topology=topology.name,
        makespan_s=makespan,
        timeline=timeline,
        busy_s=busy_s,
        payload=payload,
        events=processed,
        meta=meta,
    )


def summarize(result: ReplayResult, topology: Topology) -> Dict[str, object]:
    """Plain-data summary (the ``--json`` report row): makespan, busy
    fractions, overlap, per-link breakdown."""
    ovl = result.overlap_frac
    return {
        "program": result.program,
        "topology": result.topology,
        "chips": topology.num_chips,
        "makespan_s": result.makespan_s,
        "compute_busy_s": result.compute_busy_s,
        "comm_busy_s": result.comm_busy_s,
        "hbm_busy_s": result.busy_s.get("hbm", 0.0),
        "overlap_frac": None if math.isnan(ovl) else ovl,
        "events": result.events,
        "links": result.link_utilization(topology),
        "meta": result.meta,
    }
