"""Hardware specs: the capability numbers every cost term reads.

The counterpart of the JAX package's ``perfmodel/specs.py``: one
``ChipSpec`` per device the port runs on, in SI units. The cost models
(``perfmodel/cost.py``), the serving cluster's census rate and handoff
price (``serve/admission.decode_token_rate``,
``cost.kv_handoff_seconds``) and ``chip_smoke.py``'s kernel bounds read
these numbers and no others.

- ``h100-sxm``: NVIDIA's data sheet for the H100 SXM 80 GB, dense
  (no sparsity): bf16 and fp16 989 TFLOP/s, int8 1979 TOP/s, float32
  67 TFLOP/s, float64 67; HBM3 80 GB at 3.35 TB/s; NVLink 900 GB/s both
  ways, 450 GB/s a direction; ``dcn`` one 400 Gb/s NIC a GPU as in a DGX
  H100, 50 GB/s a direction. Data sheet, not measured: measured rates go
  in PERF.md, never here, so that every prediction stays a bound. A
  node's cards share one NVSwitch fabric (``switched``). The
  card it stands for reports itself to ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` as "NVIDIA H100
  80GB HBM3, 700.00 W".
- ``cpu``: the JAX package's ``cpu-sim`` entry exactly (1 TFLOP/s for
  every dtype, 16 GiB, 100 GB/s memory and link, 10 GB/s ``dcn``), so a
  CPU runtime prices a row as the JAX package does on its CPU simulation.

**The dtype rule of the H100 entry departs from the JAX convention on
purpose.** The JAX package prices float32/float64 at the bf16 rate over
three (the TPU's bf16x3 passes) and integer operands at the int8 peak.
On the H100 that would be 330 TFLOP/s for a float32 row, but the port's
float32 rows run true float32 with TF32 off
(``primitives/base.matmul_precision_scope``) on the 67 TFLOP/s units,
and its int32/int64 rows multiply in float64 (``ops/accum.py``) at the
67 TFLOP/s FP64 tensor-core rate: a bound 5 to 30 times too optimistic
is still a bound, but says nothing. So the entry names every dtype the
port runs and gives it the rate of the units that run it; ``int8`` is the
rate the ``quantized`` members are priced at (their ``COST_DTYPE``).
``peak_flops`` keeps the JAX fallbacks for a dtype an entry leaves out,
so the ``cpu`` entry prices exactly as ``cpu-sim``.

``spec_for_device`` picks the entry of a runtime (``Runtime.chip_spec``):
the ``DDLB_TPU_CHIP`` override first (an unknown name raises; a CUDA
runtime refuses the ``cpu`` entry), then ``cpu`` on the host, then the
card's name. A card the registry does not hold raises: a wrong
denominator would make every prediction silently wrong.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

GB = 1e9
GiB = float(1 << 30)

#: env override: force a registry entry by name or alias
CHIP_ENV = "DDLB_TPU_CHIP"


@dataclass(frozen=True)
class ChipSpec:
    """One device's published capability numbers, in SI units."""

    name: str
    #: device memory, bytes
    hbm_bytes: float
    #: device memory bandwidth, bytes/s
    hbm_bw: float
    #: one link to a peer inside a node, one direction, bytes/s (NVLink
    #: on the card; the JAX spec's ``ici`` rate)
    link_bw: float
    #: one device's share of the network between nodes, one direction,
    #: bytes/s (the JAX spec's ``dcn`` rate)
    dcn_bw: float = 0.0
    #: operand dtype name -> peak in TFLOP/s (TOP/s for integers)
    peak_tflops: Mapping[str, float] = field(default_factory=dict)
    aliases: Tuple[str, ...] = ()
    #: True where a node's devices share one switched fabric (NVSwitch):
    #: the simulator's topology allows one dimension inside a node. False
    #: keeps the JAX convention of a torus, one independent ring family a
    #: mesh dimension (``perfmodel/topology.py``)
    switched: bool = False

    def peak_flops(self, dtype: str) -> float:
        """Peak FLOP/s for operands of ``dtype``: the entry's own rate;
        else the JAX fallbacks (float32/float64 at the bf16 rate over 3,
        integers at the int8 rate, anything else at the bf16 rate)."""
        table = self.peak_tflops
        if dtype in table:
            return table[dtype] * 1e12
        if dtype in ("float32", "float64"):
            return table["bfloat16"] / 3.0 * 1e12
        if dtype in ("int8", "int32", "int64"):
            return table.get("int8", table["bfloat16"]) * 1e12
        return table["bfloat16"] * 1e12

    def transport_bw(self, transport: str = "ici") -> float:
        """Bytes/s of one ring hop over ``transport``: ``dcn`` between
        nodes, anything else (``ici``) inside one (the JAX spec's
        ``link_bw(transport)``)."""
        return self.dcn_bw if transport == "dcn" else self.link_bw


#: the registry (see the module docstring)
CHIP_SPECS: Dict[str, ChipSpec] = {
    spec.name: spec
    for spec in (
        # data sheet, not measured; "NVIDIA H100 80GB HBM3, 700.00 W"
        ChipSpec(
            name="h100-sxm",
            hbm_bytes=80.0 * GB,
            hbm_bw=3350.0 * GB,
            link_bw=450.0 * GB,
            dcn_bw=50.0 * GB,
            peak_tflops={
                "bfloat16": 989.0,
                "float16": 989.0,
                "int8": 1979.0,
                # TF32 off: the float32 units
                "float32": 67.0,
                # float64 and the integer operands (float64 products):
                # the FP64 tensor-core rate
                "float64": 67.0,
                "int32": 67.0,
                "int64": 67.0,
            },
            aliases=("h100", "h100-sxm5", "nvidia h100 80gb hbm3"),
            # one NVSwitch fabric a node of eight
            switched=True,
        ),
        # the JAX package's cpu-sim numbers
        ChipSpec(
            name="cpu",
            hbm_bytes=16.0 * GiB,
            hbm_bw=100.0 * GB,
            link_bw=100.0 * GB,
            dcn_bw=10.0 * GB,
            peak_tflops={
                "bfloat16": 1.0,
                "float16": 1.0,
                "float32": 1.0,
                "float64": 1.0,
                "int8": 1.0,
            },
            aliases=("cpu-sim", "sim", "host"),
        ),
    )
}

_ALIASES = {
    alias: spec.name
    for spec in CHIP_SPECS.values()
    for alias in (spec.name, *spec.aliases)
}

#: ``torch.cuda.get_device_name`` -> registry entry
DEVICE_NAMES = {"NVIDIA H100 80GB HBM3": "h100-sxm"}


def get_spec(name: str) -> ChipSpec:
    """The entry for a canonical name or alias (case-insensitive);
    raises ``KeyError`` for a name the registry does not hold."""
    key = _ALIASES.get(str(name).strip().lower())
    if key is None:
        raise KeyError(f"Unknown chip {name!r}. Registered: {sorted(CHIP_SPECS)}")
    return CHIP_SPECS[key]


def chip_override() -> str:
    """The ``DDLB_TPU_CHIP`` value, stripped ("" when unset)."""
    return os.environ.get(CHIP_ENV, "").strip()


def detect_spec() -> ChipSpec:
    """The entry for code that has no runtime (a duck-typed stand-in):
    the override when set, else ``cpu``."""
    override = chip_override()
    return get_spec(override) if override else CHIP_SPECS["cpu"]


def spec_for_device(platform: str, device_name: str = "") -> ChipSpec:
    """The entry for a runtime on ``platform`` (``"cpu"`` or ``"cuda"``)
    whose card is called ``device_name`` (see the module docstring);
    raises ``KeyError`` for an unknown override and ``ValueError`` for a
    card the registry does not hold or a CUDA runtime overridden to
    ``cpu``."""
    override = chip_override()
    if override:
        spec = get_spec(override)
        if platform != "cpu" and spec.name == "cpu":
            raise ValueError(
                f"{CHIP_ENV}={override!r} would price a {platform} row with the "
                f"CPU entry; name a card's entry"
            )
        return spec
    if platform == "cpu":
        return CHIP_SPECS["cpu"]
    key = DEVICE_NAMES.get(device_name)
    if key is None:
        raise ValueError(
            f"no hardware spec for the card {device_name!r} (known: "
            f"{sorted(DEVICE_NAMES)}); add its data sheet's numbers to "
            f"ddlb_tpu_torch/perfmodel/specs.py"
        )
    return CHIP_SPECS[key]
