"""Traffic-scale serving workloads: seeded generation + SLO telemetry.

The port's copy of the JAX package's ``workload/`` (numpy and stdlib
only, no torch):

- ``generator``: a seeded, deterministic open-loop workload generator
  (Poisson and bursty arrivals, mixed prompt/output lengths, a
  Zipf-popular shared-prefix population);
- ``slo``: streaming percentiles and the per-request timeline ledger
  behind the ``slo_*`` row columns (TTFT/TPOT percentiles, goodput under
  an SLO bound, attainment, queue-depth gauges).

Consumed by the ``serving_load`` family (``primitives/serving_load``).
"""

from __future__ import annotations

from ddlb_tpu_torch.workload.generator import (  # noqa: F401
    TimedRequest,
    WorkloadSpec,
    generate_trace,
    prefix_tokens,
)
from ddlb_tpu_torch.workload.slo import (  # noqa: F401
    SLOTracker,
    StreamingQuantile,
)

__all__ = [
    "SLOTracker",
    "StreamingQuantile",
    "TimedRequest",
    "WorkloadSpec",
    "generate_trace",
    "prefix_tokens",
]
