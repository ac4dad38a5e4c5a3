"""Hardware specs: the capability numbers the port's cost terms read.

The counterpart of the JAX package's ``perfmodel/specs.py``, cut to the
fields ported code reads (``serve/admission.decode_token_rate``,
``perfmodel/cost.kv_handoff_seconds``): the name, the device memory in
bytes, its bandwidth and the bandwidth of one link in one direction, all
in SI units.

- ``h100-sxm``: NVIDIA's data sheet for the H100 SXM 80 GB (HBM3,
  3.35 TB/s; NVLink 900 GB/s both ways, 450 GB/s a direction). It is NOT
  calibrated: no number here was measured. The card it stands for
  reports itself to ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` as "NVIDIA H100 80GB HBM3, 700.00 W".
- ``cpu``: the JAX package's ``cpu-sim`` entry (16 GiB, 100 GB/s memory
  and link), so a CPU runtime prices a handoff and a census rate as the
  JAX package does on its CPU simulation.

There is no TPU entry. ``Runtime.chip_spec`` picks the entry for its
device, and raises for a card that has none (a wrong denominator would
make every census rate and handoff price silently wrong).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

GB = 1e9
GiB = float(1 << 30)


@dataclass(frozen=True)
class ChipSpec:
    """One device's published capability numbers, in SI units."""

    name: str
    #: device memory, bytes
    hbm_bytes: float
    #: device memory bandwidth, bytes/s
    hbm_bw: float
    #: one link to a peer, one direction, bytes/s (NVLink on the card)
    link_bw: float


#: the registry (see the module docstring)
CHIP_SPECS: Dict[str, ChipSpec] = {
    spec.name: spec
    for spec in (
        # data sheet, uncalibrated; "NVIDIA H100 80GB HBM3, 700.00 W"
        ChipSpec(name="h100-sxm", hbm_bytes=80.0 * GB, hbm_bw=3350.0 * GB,
                 link_bw=450.0 * GB),
        # the JAX package's cpu-sim numbers
        ChipSpec(name="cpu", hbm_bytes=16.0 * GiB, hbm_bw=100.0 * GB,
                 link_bw=100.0 * GB),
    )
}

#: ``torch.cuda.get_device_name`` -> registry entry
DEVICE_NAMES = {"NVIDIA H100 80GB HBM3": "h100-sxm"}


def spec_for_device(platform: str, device_name: str = "") -> ChipSpec:
    """The entry for a runtime on ``platform`` (``"cpu"`` or ``"cuda"``)
    whose card is called ``device_name``; raises ``ValueError`` for a card
    the registry does not hold."""
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
