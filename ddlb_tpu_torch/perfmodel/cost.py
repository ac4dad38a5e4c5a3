"""Cost models: the closed forms of the JAX package's ``perfmodel/cost.py``.

- **The row's roofline** (:376-593). ``estimate(impl)`` prices one
  configured member in seconds a measured call from three terms:
  ``compute_s``, the family's FLOP census (``impl.flops()``) over the
  ranks sharing it, at the peak of the member's cost dtype
  (``Primitive.cost_dtype``); ``comm_s``, its per-rank wire census
  (``impl.wire_bytes()``) over the rate of the link its transport crosses;
  ``hbm_s``, a memory census over the memory rate where a family is
  bandwidth-bound by design (the model's decode, the serving floor, the
  collectives' copy). The member's ``COST_SCHEDULE`` combines them:
  ``sequential`` ``max(compute + comm, hbm)``, ``overlap`` ``max(compute,
  comm, hbm)`` (a chunked pipeline pays ``min(compute, comm) / chunks`` of
  fill and drain), ``compute_only`` ``max(compute, hbm)``; ``bound`` names
  the largest term. The prediction is a lower bound (data-sheet peaks,
  bandwidth-optimal rings, no latency), so ``roofline_frac`` is
  ``predicted / measured`` clamped into (0, 1]. The functions duck-type
  the member, so stand-ins with the same attributes price alike.

  **The port's one departure from the JAX comm term** (``comm_transport``): a
  ``transport=dcn`` row is priced at the ``dcn`` rate only where the
  world spans more than one node (``Runtime.slice_ids``). On one node its
  bytes cross the link inside the node (NVLink on the card), so it is
  priced at that link's rate; priced at a NIC's rate it would predict
  more time than the card takes. Under ``DDLB_TPU_SIM_SLICES=2`` both
  packages price ``dcn`` alike.
- **The calibrated prediction** (:596-696): ``calibrated_estimate`` adds
  a fitted table's per-step, per-hop and per-row constants
  (``perfmodel/calib.py``) through the same combination laws.
- **The KV handoff's price** (:173-220), which the serving cluster
  reads: ``kv_bundle_bytes`` weighs a bundle with the decode census's
  per-row convention; ``kv_handoff_seconds`` floors the time to move it,
  ``bytes * (2 / hbm_bw + 1 / link_bw)``, or takes a fitted group's
  ``kv_setup_s + kv_per_byte_s * bytes``.
- **The ring and composition wire census** (:74-139, :236-372), which
  the members' ``wire_bytes()`` read: ``wire_itemsize``,
  ``ring_wire_bytes``, ``degraded_bw`` (the simulator's link multiplier,
  :142), ``hierarchical_phases``,
  ``hierarchical_wire_bytes``, ``torus_factors``, ``striped_wire_bytes``.
  The link classes keep the JAX names: ``ici`` is the link inside a node,
  ``dcn`` the link between nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ddlb_tpu_torch.perfmodel.specs import ChipSpec, detect_spec


def kv_bundle_bytes(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    layers: int,
    kv_cache: str,
    tokens: int,
) -> float:
    """Bytes of K/V cache a ``tokens``-row bundle carries: K and V x
    layers x kv heads x head_dim a row, at the cache dtype's width."""
    head_dim = d_model // max(1, n_heads)
    kvh = n_kv_heads or n_heads
    itemsize = 1.0 if kv_cache == "int8" else 2.0
    return 2.0 * layers * kvh * head_dim * itemsize * float(tokens)


def kv_handoff_seconds(payload_bytes: float, spec: ChipSpec, calib=None) -> float:
    """Latency floor of moving one KV bundle between two engines:
    ``bytes * (2 / hbm_bw + 1 / link_bw)``; 0 for an empty bundle.

    ``calib``, a fitted ``calib.GroupCalibration``, replaces the floor by
    its KV-handoff constants (``kv_setup_s + kv_per_byte_s * bytes``) when
    it fitted them (``kv_rows > 0``); otherwise the closed form stands."""
    if payload_bytes <= 0.0:
        return 0.0
    if calib is not None:
        fitted = calib.kv_handoff_s(payload_bytes)
        if fitted is not None:
            return fitted
    return float(payload_bytes) * (2.0 / spec.hbm_bw + 1.0 / spec.link_bw)


#: wire/HBM itemsize per operand dtype name; float64 counts 4, as the JAX
#: package's arrays are float32 unless x64 is on
_ITEMSIZE = {
    "float32": 4,
    "float64": 4,
    "float16": 2,
    "bfloat16": 2,
    "int32": 4,
    "int64": 8,
    "int8": 1,
}


def wire_itemsize(dtype: str) -> int:
    """Bytes per element as the JAX package counts them on the wire."""
    try:
        return _ITEMSIZE[dtype]
    except KeyError:
        raise ValueError(f"Unknown dtype {dtype!r}. Known: {sorted(_ITEMSIZE)}") from None


#: the family/option spellings of an op -> the census vocabulary
_OP_ALIASES = {"all_reduce": "psum", "pmean": "psum", "reduce_scatter": "psum_scatter"}


def canonical_op(op: str) -> str:
    """``all_reduce``/``reduce_scatter`` spellings -> ``psum``/``psum_scatter``."""
    return _OP_ALIASES.get(op, op)


def ring_step_count(op: str, d: int) -> int:
    """Steps of the bandwidth-optimal ring over ``d`` members: ``d - 1``
    (all-gather, reduce-scatter, all-to-all), ``2(d - 1)`` for the
    all-reduce, one for a ppermute."""
    if d <= 1:
        return 0
    op = canonical_op(op)
    if op == "psum":
        return 2 * (d - 1)
    if op == "ppermute":
        return 1
    if op in ("all_gather", "psum_scatter", "all_to_all"):
        return d - 1
    raise ValueError(f"Unknown collective op {op!r}")


def ring_wire_bytes(op: str, nbytes: float, d: int) -> float:
    """Per-device bytes of the flat ring, given the LOCAL payload
    ``nbytes`` and ``d`` members: all-gather ``S(d-1)``, reduce-scatter and
    all-to-all ``(S/d)(d-1)``, all-reduce ``2(S/d)(d-1)``, ppermute ``S``."""
    if d <= 1:
        return 0.0
    op = canonical_op(op)
    if op == "all_gather":
        return nbytes * (d - 1)
    if op == "psum_scatter":
        return nbytes * (d - 1) / d
    if op == "psum":
        return 2.0 * nbytes * (d - 1) / d
    if op == "all_to_all":
        return nbytes * (d - 1) / d
    if op == "ppermute":
        return float(nbytes)
    raise ValueError(f"Unknown collective op {op!r}")


def degraded_bw(bw: float, factor: float) -> float:
    """Surviving bandwidth of a degraded link, ``bw * factor`` with
    ``factor`` in [0, 1] (0: the link is down). The one place the
    multiplier lives: the ``Degradation`` overlay of ``topology.py`` and
    the degraded replay price through it."""
    if not (0.0 <= factor <= 1.0):
        raise ValueError(f"degradation factor must be in [0, 1], got {factor}")
    return bw * factor


def hierarchical_phases(op: str, nbytes: float, intra: int,
                        inter: int) -> Tuple[Dict[str, object], ...]:
    """The two-level decomposition of one collective over ``intra`` cards a
    node and ``inter`` nodes, as phases ``{tag, op, scope, axis, nbytes}``
    in order (``scope`` ``intra`` rides the link inside a node, ``inter``
    the link between nodes; ``nbytes`` is the phase's LOCAL payload):

    - all-reduce: RS-intra, AR-inter on the 1/intra shard, AG-intra;
    - all-gather: AG-inter of the local shard, AG-intra of the gathered block;
    - reduce-scatter: RS-intra, RS-inter on the 1/intra shard;
    - all-to-all: the inter exchange, then the intra one.

    Axes of size 1 drop their phases, so one node prices the flat ring."""
    op = canonical_op(op)
    phases = []

    def phase(tag, phase_op, scope, axis, payload):
        if axis > 1:
            phases.append({"tag": tag, "op": phase_op, "scope": scope,
                           "axis": int(axis), "nbytes": float(payload)})

    if op == "psum":
        phase("rs-intra", "psum_scatter", "intra", intra, nbytes)
        phase("ar-inter", "psum", "inter", inter, nbytes / intra)
        phase("ag-intra", "all_gather", "intra", intra, nbytes / intra)
    elif op == "all_gather":
        phase("ag-inter", "all_gather", "inter", inter, nbytes)
        phase("ag-intra", "all_gather", "intra", intra, nbytes * inter)
    elif op == "psum_scatter":
        phase("rs-intra", "psum_scatter", "intra", intra, nbytes)
        phase("rs-inter", "psum_scatter", "inter", inter, nbytes / intra)
    elif op == "all_to_all":
        phase("a2a-inter", "all_to_all", "inter", inter, nbytes)
        phase("a2a-intra", "all_to_all", "intra", intra, nbytes)
    else:
        raise ValueError(f"No hierarchical composition for collective op {op!r}")
    return tuple(phases)


def hierarchical_wire_bytes(op: str, nbytes: float, intra: int,
                            inter: int) -> Dict[str, float]:
    """Per-device bytes of the two-level decomposition by link class,
    ``{"ici": inside a node, "dcn": between nodes}``."""
    out = {"ici": 0.0, "dcn": 0.0}
    for ph in hierarchical_phases(op, nbytes, intra, inter):
        cls = "ici" if ph["scope"] == "intra" else "dcn"
        out[cls] += ring_wire_bytes(ph["op"], ph["nbytes"], ph["axis"])
    return out


def torus_factors(n: int) -> Tuple[int, int]:
    """The squarest 2-D factorization ``(sx, sy)`` of ``n`` cards: ``sx``
    the largest divisor of ``n`` at most ``sqrt(n)``, ``sy = n // sx``."""
    n = int(n)
    if n < 1:
        raise ValueError(f"slice size must be >= 1, got {n}")
    sx, f = 1, 1
    while f * f <= n:
        if n % f == 0:
            sx = f
        f += 1
    return sx, n // sx


def striped_wire_bytes(op: str, nbytes: float, inter: int,
                       ici_axes: Tuple[int, ...]) -> Dict[str, float]:
    """Per-device bytes of the striped composition: one stripe per axis of
    ``ici_axes`` with more than one card, each the two-level decomposition.
    The reductions and gathers keep the two-level totals; the all-to-all
    redistributes per axis, paying ``sum((a-1)/a)`` of the payload inside
    the node. Returns ``{"ici", "dcn", "stripes", "ici_per_stripe"}``."""
    op = canonical_op(op)
    axes = [int(a) for a in ici_axes if int(a) > 1] or [1]
    intra = 1
    for a in axes:
        intra *= a
    if op == "all_to_all":
        ici = sum([nbytes * (a - 1) / a for a in axes])
        dcn = ring_wire_bytes("all_to_all", nbytes, inter)
    else:
        cls = hierarchical_wire_bytes(op, nbytes, intra, inter)
        ici, dcn = cls["ici"], cls["dcn"]
    stripes = max(1, len(axes))
    return {"ici": ici, "dcn": dcn, "stripes": float(stripes),
            "ici_per_stripe": ici / stripes}


# -- the row's roofline -------------------------------------------------------


@dataclass(frozen=True)
class CostEstimate:
    """The model's verdict for one configured member."""

    compute_s: float
    comm_s: float
    hbm_s: float
    predicted_s: float
    bound: str  # "compute" | "comm" | "hbm"
    chip: str

    def roofline_frac(self, measured_s: float) -> float:
        """``predicted / measured`` clamped into (0, 1]; NaN when the
        measurement is absent or the model predicts nothing (a one-rank
        collective)."""
        if not (
            isinstance(measured_s, (int, float))
            and measured_s == measured_s  # not NaN
            and measured_s > 0.0
            and self.predicted_s > 0.0
        ):
            return float("nan")
        return min(1.0, self.predicted_s / measured_s)


def _compute_term(impl, spec: ChipSpec) -> float:
    """``flops()`` over the ranks over the peak of the member's cost dtype
    (the ``quantized`` members' ``int8`` though their operands are bf16)."""
    d = max(1, int(impl.num_partitions))
    cost_dtype = getattr(impl, "cost_dtype", None)
    dtype = cost_dtype() if callable(cost_dtype) else impl.dtype
    return float(impl.flops()) / d / spec.peak_flops(dtype)


def _spans_nodes(impl) -> bool:
    """Whether the member's world spans more than one node
    (``Runtime.slice_ids``); False for a stand-in with no runtime."""
    runtime = getattr(impl, "runtime", None)
    return len(set(getattr(runtime, "slice_ids", ()) or ())) > 1


def comm_transport(impl, transport: Optional[str] = None) -> str:
    """The link a member's wire crosses: ``transport`` (default: the
    member's ``transport`` option), but ``ici`` for a ``dcn`` row whose
    world is one node (the module docstring's one departure from the JAX
    comm term). The simulator's closed-form front-end resolves it here
    too."""
    if transport is None:
        transport = impl.options.get("transport", "ici")
    if transport == "dcn" and not _spans_nodes(impl):
        return "ici"
    return transport


def _comm_term(impl, spec: ChipSpec) -> float:
    """``wire_bytes()`` over the rate of the link the bytes cross
    (``comm_transport``)."""
    wire = getattr(impl, "wire_bytes", None)
    if not callable(wire):
        return 0.0
    return float(wire()) / spec.transport_bw(comm_transport(impl))


def overlap_chunks(impl) -> Optional[int]:
    """The member's finite pipeline depth when it declares one
    (``Primitive.overlap_chunks``: the chunked engine's ``chunk_count``);
    None for ideal-overlap members and stand-ins without the hook."""
    hook = getattr(impl, "overlap_chunks", None)
    if not callable(hook):
        return None
    try:
        chunks = hook()
    except Exception:
        return None
    if isinstance(chunks, (int, float)) and chunks >= 1:
        return int(chunks)
    return None


Terms = Tuple[float, float, float]  # (compute_s, comm_s, hbm_s)


def _gemm_collective_cost(impl, spec: ChipSpec) -> Terms:
    """tp_columnwise, tp_rowwise, dp_allreduce, ep_alltoall: a rank's GEMM
    share and the family's ring collective."""
    return _compute_term(impl, spec), _comm_term(impl, spec), 0.0


def _attention_cost(impl, spec: ChipSpec) -> Terms:
    """cp_ring_attention: the causal/windowed FLOP census and the KV ring
    (or Ulysses' all-to-all) exchange."""
    return _compute_term(impl, spec), _comm_term(impl, spec), 0.0


def _pipeline_cost(impl, spec: ChipSpec) -> Terms:
    """pp_pipeline: one stage's GEMM stream a rank and the hop traffic;
    the microbatch bubble is what the schedules measure against this
    floor, so it is not in it."""
    return _compute_term(impl, spec), _comm_term(impl, spec), 0.0


def _model_step_cost(impl, spec: ChipSpec) -> Terms:
    """transformer_step: the model-FLOPs census over the mesh (the MFU
    denominator as a time)."""
    return _compute_term(impl, spec), 0.0, 0.0


def _decode_cost(impl, spec: ChipSpec) -> Terms:
    """transformer_decode: the compute census raced with a rank's share of
    the weight and KV-cache traffic (``impl.hbm_bytes()``) over the memory
    rate."""
    compute = _compute_term(impl, spec)
    hbm = 0.0
    census = getattr(impl, "hbm_bytes", None)
    if callable(census):
        d = max(1, int(impl.num_partitions))
        hbm = float(census()) / d / spec.hbm_bw
    return compute, 0.0, hbm


def _serving_cost(impl, spec: ChipSpec) -> Terms:
    """serving_load: the decode census, plus for the disaggregated member
    every handoff the trace will make (``impl.handoff_bytes()``) at
    ``kv_handoff_seconds``; the family's ``cost_model()`` floors the
    prediction at the trace's arrival horizon."""
    compute, comm, hbm = _decode_cost(impl, spec)
    census = getattr(impl, "handoff_bytes", None)
    if callable(census):
        comm += kv_handoff_seconds(float(census()), spec)
    return compute, comm, hbm


def _collective_cost(impl, spec: ChipSpec) -> Terms:
    """collectives: the wire for the ring members; the ``compute_only``
    member's copy reads and writes its payload (``hbm_bytes()``) once
    each, ``2 * bytes / hbm_bw``."""
    if getattr(impl, "COST_SCHEDULE", "sequential") == "compute_only":
        census = getattr(impl, "hbm_bytes", None)
        payload = float(census()) if callable(census) else 0.0
        return 0.0, 0.0, 2.0 * payload / spec.hbm_bw
    return 0.0, _comm_term(impl, spec), 0.0


#: family -> cost function; covers ``registry.ALLOWED_PRIMITIVES`` exactly
FAMILY_COST_MODELS: Dict[str, Callable[[object, ChipSpec], Terms]] = {
    "tp_columnwise": _gemm_collective_cost,
    "tp_rowwise": _gemm_collective_cost,
    "dp_allreduce": _gemm_collective_cost,
    "ep_alltoall": _gemm_collective_cost,
    "cp_ring_attention": _attention_cost,
    "pp_pipeline": _pipeline_cost,
    "transformer_step": _model_step_cost,
    "transformer_decode": _decode_cost,
    "serving_load": _serving_cost,
    "collectives": _collective_cost,
}


def _combine(schedule: str, compute: float, comm: float, hbm: float,
             chunks: Optional[int]) -> float:
    """The schedule's law over the three terms."""
    if schedule == "compute_only":
        return max(compute, hbm)
    if schedule == "overlap":
        if chunks is not None:
            # a c-deep pipeline hides all but 1/c of the shorter phase
            return max(hbm, max(compute, comm) + min(compute, comm) / chunks)
        return max(compute, comm, hbm)
    return max(compute + comm, hbm)


def estimate(impl, spec: Optional[ChipSpec] = None) -> CostEstimate:
    """The cost model's verdict for one configured member, against
    ``spec`` (default: the member's ``runtime.chip_spec``; a stand-in
    without a runtime takes ``specs.detect_spec()``). Raises
    ``ValueError`` for a family with no model."""
    family = getattr(impl, "primitive_name", None)
    if family not in FAMILY_COST_MODELS:
        raise ValueError(
            f"No cost model for primitive family {family!r}. "
            f"Registered: {sorted(FAMILY_COST_MODELS)}"
        )
    if spec is None:
        runtime = getattr(impl, "runtime", None)
        spec = runtime.chip_spec if runtime is not None else detect_spec()
    compute, comm, hbm = FAMILY_COST_MODELS[family](impl, spec)
    schedule = getattr(impl, "COST_SCHEDULE", "sequential")
    if schedule == "compute_only":
        comm = 0.0
    chunks = overlap_chunks(impl) if schedule == "overlap" else None
    predicted = _combine(schedule, compute, comm, hbm, chunks)
    bound = max((("compute", compute), ("comm", comm), ("hbm", hbm)),
                key=lambda kv: kv[1])[0]
    return CostEstimate(compute_s=compute, comm_s=comm, hbm_s=hbm,
                        predicted_s=predicted, bound=bound, chip=spec.name)


# -- the calibrated prediction ------------------------------------------------


@dataclass(frozen=True)
class CalibratedEstimate:
    """The analytical bound plus a fitted table's overheads, priced
    through the member's own schedule law, so that it tracks measured
    medians instead of bounding them."""

    predicted_cal_s: float
    overhead_s: float  # predicted_cal_s - the analytical bound
    version: str  # the table's fingerprint (the cal_version column)
    chip: str
    backend: str

    def residual_frac(self, measured_s: float) -> float:
        """``(measured - calibrated) / calibrated`` (positive: slower than
        the fitted model); NaN when either side is absent."""
        if not (
            isinstance(measured_s, (int, float))
            and measured_s == measured_s  # not NaN
            and measured_s > 0.0
            and self.predicted_cal_s > 0.0
        ):
            return float("nan")
        return (measured_s - self.predicted_cal_s) / self.predicted_cal_s


def calibrated_estimate(impl, spec: Optional[ChipSpec] = None, table=None,
                        backend: Optional[str] = None) -> Optional[CalibratedEstimate]:
    """The calibrated prediction for one configured member: every wire
    step of the schedule's census (``calib.schedule_census``) costs one
    step overhead and one hop of its link class, every compute step one
    step overhead, and the dispatch constant lands once a row. ``table``
    defaults to the one ``DDLB_TPU_CALIB`` names; ``backend`` picks the
    (chip, backend) group. None when there is no table or no group for
    the chip."""
    from ddlb_tpu_torch.perfmodel import calib

    if table is None:
        table = calib.get_table()
    if table is None:
        return None
    est = estimate(impl, spec)
    group = table.group(est.chip, backend)
    if group is None:
        return None
    schedule = getattr(impl, "COST_SCHEDULE", "sequential")
    d = max(1, int(impl.num_partitions))
    link_class = calib.scope_link_class(str(impl.options.get("transport", "ici")))
    chunks = overlap_chunks(impl) if schedule == "overlap" else None
    census = calib.schedule_census(
        calib.family_op(getattr(impl, "primitive_name", ""), impl.options),
        d,
        has_compute=est.compute_s > 0.0,
        has_wire=est.comm_s > 0.0,
        chunks=chunks,
        link_class=link_class,
    )
    compute = est.compute_s + census["compute_steps"] * group.compute_overhead_s()
    comm = est.comm_s + census["wire_steps"] * group.wire_overhead_s(link_class)
    predicted = _combine(schedule, compute, comm, est.hbm_s, chunks) + group.dispatch_s
    return CalibratedEstimate(
        predicted_cal_s=predicted,
        overhead_s=predicted - est.predicted_s,
        version=table.version,
        chip=est.chip,
        backend=group.backend,
    )
