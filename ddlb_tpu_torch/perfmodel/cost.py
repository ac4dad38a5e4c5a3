"""Closed forms of the JAX package's ``perfmodel/cost.py`` that the port
reads.

- The KV handoff's price (:173-220), which the serving cluster reads.
  ``kv_bundle_bytes`` weighs a handoff bundle with the decode census's
  per-row convention (``utils/hbm_budget.decode_budget``'s ``kv_cache``);
  ``kv_handoff_seconds`` floors the time to move it: read out of the
  producer's memory, one link crossing, written into the consumer's,
  ``bytes * (2 / hbm_bw + 1 / link_bw)`` (on the card the link is
  NVLink). This is the JAX function's closed form (its ``calib=None``
  case): the calibration table that can replace it (``perfmodel.calib``)
  waits for the port's perfmodel tooling.
- The ring and composition wire census (:74-139, :236-372), which the
  topology compositions' ``wire_bytes()`` reads
  (``primitives/topo_compose.py``): ``wire_itemsize``, the flat ring's
  per-device bytes (``ring_wire_bytes``), the two-level decomposition's
  phases and bytes by link class (``hierarchical_phases``,
  ``hierarchical_wire_bytes``), a node's squarest 2-D factorization
  (``torus_factors``) and the striped composition's bytes
  (``striped_wire_bytes``). The link classes keep the JAX names: ``ici``
  is the link inside a node (NVLink on the card), ``dcn`` the link
  between nodes.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ddlb_tpu_torch.perfmodel.specs import ChipSpec


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


def kv_handoff_seconds(payload_bytes: float, spec: ChipSpec) -> float:
    """Latency floor of moving one KV bundle between two engines:
    ``bytes * (2 / hbm_bw + 1 / link_bw)``; 0 for an empty bundle."""
    if payload_bytes <= 0.0:
        return 0.0
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
