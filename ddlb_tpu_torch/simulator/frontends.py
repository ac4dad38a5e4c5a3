"""Program builders: closed-form members and synthetic compositions.

The counterpart of the JAX package's ``simulator/frontends.py``, two of
its three front-ends:

1. **Closed-form** (``program_from_impl``): a member's cost terms
   (``perfmodel.cost``) lowered into ring-granularity steps. The
   validation front-end: on a degenerate flat topology the replayed
   makespan equals ``cost.estimate().predicted_s`` to float precision,
   because the engine's arbitration of the sequential, ideal-overlap and
   chunked shapes is the cost model's combination rule.
2. **Synthetic** (``flat_ring_program``, ``hierarchical_program``,
   ``striped_program``): algorithms written against the IR (a flat
   world-spanning ring, the two-level RS-intra / AR-inter / AG-intra
   phases, and one stripe a mesh dimension), so compositions are ranked
   a topology before they exist as members.

The traced front-end (the JAX package's ``program_from_schedule`` and
``program_from_member``, which replay a member's literal collective
trace) needs the SPMD interpreter of ``analysis/`` and is not ported.

**The transport of a closed-form row.** The port's cost model prices a
``transport=dcn`` row on one node at the link inside the node
(``cost.comm_transport``, "the one departure"). The front-end resolves
the transport there too, so such a row replays with its ``wire_bytes()``
on ``ici0`` and to the port's own ``estimate``; across nodes
(``DDLB_TPU_SIM_SLICES``) it rides ``dcn`` as in the JAX package.

Placement (stated once): the per-chunk GEMM leads the wire for the
reduce-side families (``compute_first``) and trails it for the
gather-side ones (``comm_first``); the closed-form path groups
ep_alltoall's dispatch/combine pair so the replay lands on the cost
model's two-phase fill/drain law.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ddlb_tpu_torch.perfmodel.calib import FAMILY_COLLECTIVES
from ddlb_tpu_torch.perfmodel.cost import (
    FAMILY_COST_MODELS,
    canonical_op,
    comm_transport,
    hierarchical_phases,
    overlap_chunks,
    ring_step_count,
    ring_wire_bytes,
)
from ddlb_tpu_torch.perfmodel.topology import Topology
from ddlb_tpu_torch.simulator.program import (
    ComputeStep,
    HbmStep,
    ScheduleProgram,
    Stage,
    WireStep,
    pipelined,
    sequential,
)

#: where the per-chunk GEMM sits relative to its wire (module docstring)
FAMILY_PLACEMENT: Dict[str, str] = {
    "tp_columnwise": "comm_first",
    "tp_rowwise": "compute_first",
    "dp_allreduce": "compute_first",
    "ep_alltoall": "sandwich",
}


class ProgramBuildError(ValueError):
    """A front-end could not lower its input into the IR (an unknown
    family or algorithm)."""


# -- synthetic compositions -----------------------------------------------------


def _ring_steps(op: str, nbytes: float, d: int, scope: str, tag: str) -> List[WireStep]:
    """One collective as its synchronous ring steps: the bandwidth-optimal
    step count, the closed-form total spread evenly over them."""
    total = ring_wire_bytes(op, nbytes, d)
    count = ring_step_count(op, d)
    if count <= 0 or total <= 0.0:
        return []
    return [WireStep(total / count, scope=scope, op=canonical_op(op), tag=tag)
            for _ in range(count)]


def flat_ring_program(op: str, nbytes: float, topology: Topology,
                      name: str = "") -> ScheduleProgram:
    """The baseline: one ring over every device. Across nodes each step
    is gated by the ring's slowest link (the ``flat`` channel), which is
    why it loses to the hierarchical composition where ``dcn`` binds."""
    n = topology.num_chips
    scope = "flat" if topology.pods > 1 else "ici0"
    steps = _ring_steps(op, nbytes, n, scope, "flat-ring")
    return sequential(name or f"flat/{canonical_op(op)}", steps, algo="flat",
                      op=canonical_op(op), payload_bytes=nbytes)


def hierarchical_program(op: str, nbytes: float, topology: Topology,
                         name: str = "") -> ScheduleProgram:
    """The two-level composition (``cost.hierarchical_phases``): the intra
    phases ride one ring family inside the node, the inter phase each
    device's ``dcn`` share; phases chain. Under a degradation with a
    downed axis the intra phases take the first surviving one; a downed
    ``dcn`` has no alternative and the program replays unroutable."""
    alive = topology.alive_ici_axes()
    intra_scope = f"ici{alive[0]}" if alive else "ici0"
    steps: List[WireStep] = []
    for ph in hierarchical_phases(op, nbytes, topology.chips_per_pod, topology.pods):
        scope = intra_scope if ph["scope"] == "intra" else "dcn"
        steps.extend(_ring_steps(ph["op"], ph["nbytes"], ph["axis"], scope, ph["tag"]))
    return sequential(name or f"hier/{canonical_op(op)}", steps, algo="hierarchical",
                      op=canonical_op(op), payload_bytes=nbytes, intra_scope=intra_scope)


def striped_program(op: str, nbytes: float, topology: Topology,
                    name: str = "") -> ScheduleProgram:
    """Multi-path striping: the payload splits into one stripe a surviving
    mesh dimension, each running the hierarchical composition on its own
    channel; the stripes contend for the ``dcn`` share. One dimension is
    ``hierarchical_program`` exactly, as on every switched node
    (``h100-sxm``), which has one."""
    alive = list(topology.alive_ici_axes()) or [0]
    stripes = len(alive)
    stages: List[Stage] = []
    for s, axis in enumerate(alive):
        steps: List[WireStep] = []
        for ph in hierarchical_phases(op, nbytes / stripes, topology.chips_per_pod,
                                      topology.pods):
            scope = f"ici{axis}" if ph["scope"] == "intra" else "dcn"
            steps.extend(_ring_steps(ph["op"], ph["nbytes"], ph["axis"], scope,
                                     f"{ph['tag']}#s{s}"))
        stages.append(Stage(steps, label=f"stripe{s}"))
    return pipelined(name or f"striped/{canonical_op(op)}", stages, algo="striped",
                     op=canonical_op(op), payload_bytes=nbytes, stripes=stripes,
                     stripe_axes=alive)


SYNTHETIC_ALGOS = ("flat", "hierarchical", "striped")


def synthetic_program(algo: str, op: str, nbytes: float,
                      topology: Topology) -> ScheduleProgram:
    """One of the ranked compositions by name."""
    if algo == "flat":
        return flat_ring_program(op, nbytes, topology)
    if algo == "hierarchical":
        return hierarchical_program(op, nbytes, topology)
    if algo == "striped":
        return striped_program(op, nbytes, topology)
    raise ProgramBuildError(f"Unknown synthetic algorithm {algo!r}; known: {SYNTHETIC_ALGOS}")


# -- the closed-form front-end ----------------------------------------------------


def _impl_cost_dtype(impl) -> str:
    hook = getattr(impl, "cost_dtype", None)
    if callable(hook):
        try:
            return hook()
        except Exception:
            return impl.dtype
    return impl.dtype


def program_from_impl(impl, topology: Topology,
                      transport: Optional[str] = None) -> ScheduleProgram:
    """Lower one member's cost terms into a program.

    The censuses come through the family's cost model (one source with
    the perfmodel); the schedule from the IR: sequential members chain,
    ideal-overlap members race, chunked members pipeline
    ``overlap_chunks()`` two-phase stages. On a degenerate flat topology
    the replayed makespan equals ``cost.estimate(impl).predicted_s`` to
    float precision (``validate.closed_form_check``)."""
    family = getattr(impl, "primitive_name", None)
    if family not in FAMILY_COST_MODELS:
        raise ProgramBuildError(f"No cost model for primitive family {family!r}")
    spec = topology.chip
    compute_s, comm_s, hbm_s = FAMILY_COST_MODELS[family](impl, spec)
    schedule = getattr(impl, "COST_SCHEDULE", "sequential")
    if schedule == "compute_only":
        comm_s = 0.0
    transport = comm_transport(impl, transport)
    scope = "dcn" if transport == "dcn" else "ici0"
    dtype = _impl_cost_dtype(impl)
    # the terms inverted into engine quantities by the same spec, so the
    # rates cancel exactly
    flops = compute_s * spec.peak_flops(dtype)
    wire = comm_s * spec.transport_bw(transport)
    hbm = hbm_s * spec.hbm_bw
    d = max(1, int(impl.num_partitions))
    op = FAMILY_COLLECTIVES.get(family, "ppermute")
    if family == "collectives":
        op = impl.options.get("op", "all_reduce")
    count = max(1, ring_step_count(op, d)) if wire > 0.0 else 0

    label = f"{family}/{getattr(impl, 'implementation_name', type(impl).__name__)}"
    meta = {"family": family, "schedule": schedule, "transport": transport,
            "frontend": "closed-form"}

    def wire_steps(total: float, tag: str) -> List[WireStep]:
        if total <= 0.0 or count == 0:
            return []
        return [WireStep(total / count, scope=scope, op=canonical_op(op), tag=tag)
                for _ in range(count)]

    compute = [ComputeStep(flops, dtype=dtype, tag="gemm")] if flops > 0.0 else []
    hbm_steps = [HbmStep(hbm, tag="hbm")] if hbm > 0.0 else []

    chunks = overlap_chunks(impl) if schedule == "overlap" else None
    if schedule == "overlap" and chunks is None:
        # ideal overlap: independent tracks, the engine takes the max
        stages = [Stage(wire_steps(wire, "ring"), label="comm")]
        if compute:
            stages.insert(0, Stage(compute, label="compute"))
        if hbm_steps:
            stages.append(Stage(hbm_steps, label="hbm"))
        return pipelined(label, [s for s in stages if s.steps], **meta)
    placement = FAMILY_PLACEMENT.get(family, "comm_first")
    if schedule == "overlap":
        # the chunked engine's two-phase pipeline: a chunk holds 1/chunks
        # of each census, the GEMM placed by the family table
        stages = []
        for j in range(chunks):
            csteps = ([ComputeStep(flops / chunks, dtype=dtype, tag=f"gemm#{j}")]
                      if flops > 0.0 else [])
            wsteps = wire_steps(wire / chunks, f"ring#{j}")
            if placement == "compute_first":
                stages.append(Stage(csteps + wsteps, label=f"chunk{j}"))
            else:
                stages.append(Stage(wsteps + csteps, label=f"chunk{j}"))
        if hbm_steps:
            stages.append(Stage(hbm_steps, label="hbm"))
        return pipelined(label, stages, chunks=chunks, **meta)
    # sequential (and compute_only, its comm zeroed): one chain, the
    # memory census racing it on its own track (Stage.hbm_parallel)
    wsteps = wire_steps(wire, "ring")
    chain: List[Any] = compute + wsteps if placement == "compute_first" else wsteps + compute
    return sequential(label, chain + hbm_steps, **meta)
