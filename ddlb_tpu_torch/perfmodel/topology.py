"""Synthetic worlds: chip specs composed into nodes and clusters.

The counterpart of the JAX package's ``perfmodel/topology.py``. The spec
registry (``specs.py``) knows one device's rates; this module composes
devices into the worlds the simulator (``ddlb_tpu_torch.simulator``)
replays schedules on: ``pods`` nodes of an ``ici_mesh`` each, joined by
every device's ``dcn`` share of the network, at sizes no test machine
holds. Stdlib only, like the rest of the perfmodel.

The model is the one the collectives assume (the link names keep the JAX
vocabulary: ``ici`` inside a node, ``dcn`` between nodes):

- inside a node a ring hop moves at ``ChipSpec.transport_bw("ici")``
  a direction;
- between nodes each device owns a ``transport_bw("dcn")`` share of the
  network;
- a *flat* ring over a world of several nodes advances in synchronous
  steps gated by its slowest link (the ``dcn`` hop), the reason
  hierarchical compositions exist.

**A switched node** (``ChipSpec.switched``, the ``h100-sxm`` entry). The
JAX package gives each ``ici_mesh`` dimension its own ring family at the
full link rate: a torus, where multi-path striping adds bandwidth. An
H100 node is one NVSwitch fabric, and two logical axes inside it share
one card's 450 GB/s of NVLink (striped rows on the card ran 1.5 to 2.7
times slower than the flat row). So a ``Topology`` of a switched chip
refuses a mesh of more than one dimension inside a node: its one fabric
is ``ici0``, the node has one path to stripe over, and the striped
composition is the hierarchical one there. The ``cpu`` entry keeps the
JAX torus, so both packages replay a ``cpu`` world alike.

Resource names (``mxu``, ``hbm``, ``ici0..iciN-1``, ``dcn``, ``flat``)
are the contract between ``Topology`` and the simulator's engine: every
schedule step names the resource it occupies, and
``Topology.resource_rate`` prices it. On the card ``mxu`` is the tensor
cores.

``PRESETS`` names H100 worlds (nodes of eight on NVLink, joined by the
50 GB/s a card ``dcn`` share).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Tuple

from ddlb_tpu_torch.perfmodel.cost import degraded_bw
from ddlb_tpu_torch.perfmodel.specs import ChipSpec, get_spec

#: spec format: the first factor is the node axis, the rest the mesh
#: inside a node
SPEC_FORMAT = "<chip>:<pods>x<ici_dim>[x<ici_dim>...]"


@dataclass(frozen=True)
class Degradation:
    """A per-link-class overlay: the degraded twin of a healthy world.

    ``factors`` maps link classes (``ici0``..``iciN-1``, ``dcn``) to the
    surviving bandwidth fraction in (0, 1]; ``down`` names classes that
    failed outright, whose steps price at zero rate (an unroutable
    composition replays to an infinite makespan). Spec string:
    comma-joined ``class=factor`` pairs, 0 meaning down (``"dcn=0.25"``,
    ``"ici1=0"``)."""

    factors: Mapping[str, float] = field(default_factory=dict)
    down: Tuple[str, ...] = ()
    name: str = ""

    def __post_init__(self) -> None:
        for cls, f in self.factors.items():
            if not (0.0 < float(f) <= 1.0):
                raise ValueError(
                    f"degradation factor for {cls!r} must be in (0, 1] "
                    f"(use down= for failed links), got {f}"
                )
        if not self.name:
            parts = [f"{c}={self.factors[c]:g}" for c in sorted(self.factors)]
            parts += [f"{c}=0" for c in sorted(self.down)]
            object.__setattr__(self, "name", ",".join(parts) or "healthy")

    def factor(self, resource: str) -> float:
        """The surviving-bandwidth multiplier of one link class: 0.0 when
        it is down, 1.0 when untouched."""
        if resource in self.down:
            return 0.0
        return float(self.factors.get(resource, 1.0))


def parse_degradation(spec: str) -> Degradation:
    """``'dcn=0.25,ici1=0'`` -> a ``Degradation`` (factor 0 = down)."""
    factors: Dict[str, float] = {}
    down = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        cls, sep, value = part.partition("=")
        cls = cls.strip()
        if not sep or not cls:
            raise ValueError(
                f"Bad degradation spec {spec!r}: expected "
                f"class=factor[,class=factor...] (factor 0 = link down)"
            )
        try:
            f = float(value)
        except ValueError:
            raise ValueError(
                f"Bad degradation spec {spec!r}: factor {value!r} is not a number"
            ) from None
        if f == 0.0:
            down.append(cls)
        else:
            factors[cls] = f
    if not factors and not down:
        raise ValueError(f"Bad degradation spec {spec!r}: empty")
    return Degradation(factors=factors, down=tuple(down))


@dataclass(frozen=True)
class Topology:
    """A synthetic world: ``pods`` nodes of one ``ici_mesh``.

    ``chip`` supplies every rate (``transport_bw`` for the links,
    ``peak_flops`` and ``hbm_bw`` for compute and memory); the
    composition supplies the counts. A one-node world is the degenerate
    flat topology the closed-form gate runs on."""

    chip: ChipSpec
    pods: int = 1
    ici_mesh: Tuple[int, ...] = (8,)
    name: str = ""
    #: the degraded-world overlay; None = every link healthy
    degradation: Optional[Degradation] = None

    def __post_init__(self) -> None:
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {self.pods}")
        if not self.ici_mesh or any(d < 1 for d in self.ici_mesh):
            raise ValueError(f"ici_mesh needs positive dims, got {self.ici_mesh!r}")
        if self.chip.switched and len(self.ici_mesh) > 1:
            raise ValueError(
                f"{self.chip.name} nodes are one switched fabric: one "
                f"dimension inside a node, got {self.ici_mesh!r}"
            )
        if not self.name:
            name = self.spec_string()
            if self.degradation is not None:
                name = f"{name}!{self.degradation.name}"
            object.__setattr__(self, "name", name)

    def degraded(self, degradation: Degradation) -> "Topology":
        """This world with ``degradation`` overlaid (a fresh name)."""
        return replace(self, degradation=degradation, name="")

    def link_factor(self, resource: str) -> float:
        """The overlay's multiplier for one link class (1.0 when healthy)."""
        if self.degradation is None:
            return 1.0
        return self.degradation.factor(resource)

    def alive_ici_axes(self) -> Tuple[int, ...]:
        """The ring families inside a node that still carry traffic, by
        mesh dimension: the paths striping spreads over."""
        return tuple(i for i in range(len(self.ici_mesh))
                     if self.link_factor(f"ici{i}") > 0.0)

    # -- composition ---------------------------------------------------------

    @property
    def chips_per_pod(self) -> int:
        total = 1
        for dim in self.ici_mesh:
            total *= dim
        return total

    @property
    def num_chips(self) -> int:
        return self.pods * self.chips_per_pod

    def spec_string(self) -> str:
        dims = "x".join(str(d) for d in self.ici_mesh)
        return f"{self.chip.name}:{self.pods}x{dims}"

    # -- link rates (bytes/s a device, a direction) --------------------------

    @property
    def ici_bw(self) -> float:
        return self.chip.transport_bw("ici")

    @property
    def dcn_bw(self) -> float:
        return self.chip.transport_bw("dcn")

    @property
    def flat_bw(self) -> float:
        """The rate a synchronous step of a world-spanning ring moves at:
        the slowest link class it crosses (every ring family inside a
        node; the ``dcn`` share too across nodes), 0 when one is down."""
        ici = min(
            (degraded_bw(self.ici_bw, self.link_factor(f"ici{i}"))
             for i in range(len(self.ici_mesh))),
            default=self.ici_bw,
        )
        if self.pods > 1:
            return min(ici, degraded_bw(self.dcn_bw, self.link_factor("dcn")))
        return ici

    def resource_rate(self, resource: str, dtype: str = "bfloat16") -> float:
        """The price of one resource in units a second: FLOP/s for
        ``mxu`` (the tensor cores on the card) at the ``dtype`` peak,
        bytes/s otherwise, link classes scaled by the overlay (0.0 =
        down). An unknown resource raises: a step on a resource the world
        cannot price would otherwise replay at infinite speed."""
        if resource == "mxu":
            return self.chip.peak_flops(dtype)
        if resource == "hbm":
            return self.chip.hbm_bw
        if resource == "dcn":
            return degraded_bw(self.dcn_bw, self.link_factor("dcn"))
        if resource == "flat":
            return self.flat_bw
        if resource.startswith("ici"):
            idx = resource[3:] or "0"
            if idx.isdigit() and int(idx) < len(self.ici_mesh):
                return degraded_bw(self.ici_bw, self.link_factor(resource))
        raise ValueError(
            f"Topology {self.name} cannot price resource {resource!r} "
            f"(ici_mesh has {len(self.ici_mesh)} dims)"
        )

    def comm_resources(self) -> Tuple[str, ...]:
        """Every link resource this world has: the rows of the per-link
        utilization breakdown."""
        out = [f"ici{i}" for i in range(len(self.ici_mesh))]
        if self.pods > 1:
            out += ["dcn", "flat"]
        return tuple(out)

    # -- flat-ring accounting ------------------------------------------------

    def flat_hop_fractions(self) -> Dict[str, float]:
        """How a world-spanning ring's hops split across link classes: it
        leaves each of the ``pods`` nodes once, every other hop is inside
        a node. Attributes a ``flat`` step's bytes to physical classes."""
        n = self.num_chips
        if self.pods <= 1 or n <= 1:
            return {"ici0": 1.0}
        dcn_hops = self.pods
        return {"ici0": (n - dcn_hops) / n, "dcn": dcn_hops / n}

    def describe(self) -> str:
        dims = "x".join(str(d) for d in self.ici_mesh)
        text = (
            f"{self.name}: {self.num_chips} x {self.chip.name} chips "
            f"({self.pods} pod(s) of {dims}), "
            f"ici {self.ici_bw / 1e9:.0f} GB/s/dir, "
            f"dcn {self.dcn_bw / 1e9:.2f} GB/s/chip"
        )
        if self.degradation is not None:
            text += f", DEGRADED {self.degradation.name}"
        return text


def parse_topology(spec: str) -> Topology:
    """``'h100-sxm:4x8'`` -> 4 nodes of 8 cards. A bare ``chip:N`` is the
    degenerate flat world, one node of a 1-D ring of N. A malformed spec
    raises with the format in the message; an unknown chip ``KeyError``."""
    text = str(spec).strip()
    chip_name, sep, rest = text.partition(":")
    if not sep or not chip_name.strip() or not rest.strip():
        raise ValueError(f"Bad topology spec {spec!r}: expected {SPEC_FORMAT}")
    chip = get_spec(chip_name)
    try:
        factors = [int(p) for p in rest.strip().lower().split("x")]
    except ValueError:
        raise ValueError(
            f"Bad topology spec {spec!r}: dims must be integers ({SPEC_FORMAT})"
        ) from None
    if any(f < 1 for f in factors):
        raise ValueError(f"Bad topology spec {spec!r}: dims must be positive")
    if len(factors) == 1:
        return Topology(chip=chip, pods=1, ici_mesh=(factors[0],))
    return Topology(chip=chip, pods=factors[0], ici_mesh=tuple(factors[1:]))


def flat_topology(num_chips: int, chip: str = "cpu") -> Topology:
    """The degenerate world of the closed-form gate: one node, a 1-D
    ring, where the replay must equal the cost model's closed forms."""
    return Topology(chip=get_spec(chip), pods=1, ici_mesh=(int(num_chips),))


#: named H100 worlds: nodes of eight on NVLink joined by the ``dcn``
#: share; ``resolve_topology`` takes these names and raw specs
PRESETS: Dict[str, str] = {
    "node8": "h100-sxm:1x8",
    "4node32": "h100-sxm:4x8",
    "32node256": "h100-sxm:32x8",
    "128node1024": "h100-sxm:128x8",
    "512node4096": "h100-sxm:512x8",
}


def resolve_topology(spec: str) -> Topology:
    """A preset name or a raw spec -> ``Topology``."""
    return parse_topology(PRESETS.get(str(spec).strip(), spec))
