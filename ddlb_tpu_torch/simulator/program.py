"""Schedule IR: the program the discrete-event engine replays.

The counterpart of the JAX package's ``simulator/program.py``. A
``ScheduleProgram`` is an ordered list of ``Stage``s; a stage is an
ordered list of steps. The dependency rules encode the two schedules the
members run:

- *within* a stage, steps form a chain (step ``i+1`` starts after step
  ``i`` finishes): a stage is one chunk's or one tick's serial recipe;
- *across* stages there is **no** data dependency when the program is
  ``overlap=True`` (the chunked double-buffered pipeline: chunk ``j+1``'s
  ring hops do not wait for chunk ``j``'s GEMM, so only resource
  contention orders them), and a full barrier when ``overlap=False``
  (the sequential members: every stage waits for the one before).

Steps are SPMD-symmetric: every device runs the same step at the same
time, so the engine simulates one representative device's resources
(``mxu``, ``hbm``, one ring channel a mesh dimension ``ici<i>``, ``dcn``
and the world-spanning ``flat`` channel) and the result holds for all of
them, which is what makes a 4096-card replay cost microseconds. The
names are the contract with the engine and the report and keep the JAX
vocabulary: on the card ``mxu`` means the tensor cores, ``hbm`` the
device memory, ``ici`` NVLink inside a node and ``dcn`` the network
between nodes.

Quantities are *per device*: a ``WireStep``'s ``nbytes`` is what one
device sends in that synchronous step (the convention of
``wire_bytes()``); a ``ComputeStep``'s ``flops`` is one device's share.
``Topology.resource_rate`` prices durations at replay time, so one
program ranks worlds of different devices. Stdlib only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class ComputeStep:
    """One device's tensor-core work (``mxu``) for one chunk or tick, in FLOPs."""

    flops: float
    dtype: str = "bfloat16"
    tag: str = "compute"

    @property
    def resource(self) -> str:
        return "mxu"


@dataclass(frozen=True)
class WireStep:
    """One synchronous collective step: each device sends ``nbytes`` over
    the ``scope`` link class (``ici<dim>``, ``dcn``, or ``flat`` — the
    world-spanning ring gated by its slowest link). ``op`` names the
    originating collective for the report; ``tag`` labels the phase
    (``rs-intra``, ``ar-inter``, ...)."""

    nbytes: float
    scope: str = "ici0"
    op: str = "ppermute"
    tag: str = "comm"

    @property
    def resource(self) -> str:
        return self.scope


@dataclass(frozen=True)
class HbmStep:
    """One device's memory traffic (bytes moved once) — the memory-bound
    families' census. Independent of the compute/wire chain by default
    (the ``max(·, hbm)`` roofline race), see ``Stage.hbm_parallel``."""

    nbytes: float
    tag: str = "hbm"

    @property
    def resource(self) -> str:
        return "hbm"


Step = Union[ComputeStep, WireStep, HbmStep]


@dataclass
class Stage:
    """One chunk's / one tick's serial recipe: steps chain in order.

    ``hbm_parallel`` lifts the stage's ``HbmStep``s out of the chain
    onto their own dependency-free track — the roofline-race form the
    cost model prices as ``max(compute + comm, hbm)``; leave it False
    to model an HBM phase that genuinely serializes (none of today's
    families do)."""

    steps: List[Step] = field(default_factory=list)
    label: str = ""
    hbm_parallel: bool = True


@dataclass
class ScheduleProgram:
    """A named, ordered list of stages plus the overlap contract."""

    name: str
    stages: List[Stage] = field(default_factory=list)
    #: True: stages are independent (double-buffered pipeline — resource
    #: contention alone orders them); False: stage j+1 waits on stage j
    overlap: bool = False
    #: metadata for reports (family, member, option string, ...)
    meta: dict = field(default_factory=dict)

    def num_steps(self) -> int:
        return sum(len(s.steps) for s in self.stages)

    def total(self, kind: type) -> float:
        """Summed per-chip quantity of one step kind (FLOPs for
        ``ComputeStep``, bytes otherwise) — the census the validation
        mode compares against ``wire_bytes()``/``flops()``."""
        out = 0.0
        for stage in self.stages:
            for step in stage.steps:
                if isinstance(step, kind):
                    out += step.flops if kind is ComputeStep else step.nbytes
        return out

    def tasks(self) -> Iterator[Tuple[int, int, Step, Optional[int]]]:
        """Flatten into ``(stage_idx, step_idx, step, dep)`` where
        ``dep`` is the flat index of the task this one chains after
        (None = no data dependency). This is the engine's input; the
        flat index is ``sum(len(stages[:i])) + j`` in program order."""
        flat = 0
        prev_stage_last: Optional[int] = None
        for si, stage in enumerate(self.stages):
            prev_in_chain: Optional[int] = (
                None if self.overlap else prev_stage_last
            )
            last_flat: Optional[int] = prev_stage_last
            for ji, step in enumerate(stage.steps):
                if isinstance(step, HbmStep) and stage.hbm_parallel:
                    # its own track: races the chain, never in it
                    dep = None if self.overlap else prev_stage_last
                    yield si, ji, step, dep
                else:
                    yield si, ji, step, prev_in_chain
                    prev_in_chain = flat
                    last_flat = flat
                flat += 1
            prev_stage_last = last_flat


def sequential(name: str, steps: Sequence[Step], **meta) -> ScheduleProgram:
    """One-stage serial program (the ``COST_SCHEDULE='sequential'``
    shape: everything chains)."""
    return ScheduleProgram(
        name, [Stage(list(steps), label="serial")], overlap=False, meta=meta
    )


def pipelined(
    name: str, stages: Sequence[Stage], **meta
) -> ScheduleProgram:
    """Double-buffered pipeline (the chunked-fusion engine's shape:
    stages independent, resources arbitrate)."""
    return ScheduleProgram(name, list(stages), overlap=True, meta=meta)
