"""The static performance simulator (discrete-event replay).

The counterpart of the JAX package's ``simulator/``. It replays a
*schedule program* (an ordered, dependency-structured list of compute,
wire and memory steps; ``program``) on a synthetic world
(``perfmodel.topology.Topology``) and predicts a timeline, an overlap
fraction and a per-link utilization without a card (``engine``). Two
front-ends build programs (``frontends``): the perfmodel's closed forms
over a member (the validation front-end), and synthetic compositions
(flat ring, hierarchical phases, striped) ranked on worlds of many nodes
before they exist as members. ``validate`` holds the three gates: the
closed forms, the banked history, the fitted calibration.

``python -m ddlb_tpu_torch.cli.sim_report`` is the ranking and
validation CLI.
"""

from ddlb_tpu_torch.simulator.engine import ReplayResult, replay
from ddlb_tpu_torch.simulator.program import (
    ComputeStep,
    HbmStep,
    ScheduleProgram,
    Stage,
    WireStep,
)

__all__ = [
    "ComputeStep",
    "HbmStep",
    "ReplayResult",
    "ScheduleProgram",
    "Stage",
    "WireStep",
    "replay",
]
