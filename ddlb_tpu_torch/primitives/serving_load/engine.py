"""The continuous-batching member: admit into any free slot, any tick.

The counterpart of the JAX package's ``serving_load/engine.py``: a request
is admitted the moment a slot frees, so lanes never idle while traffic
waits. With ``preempt_hol_ticks`` set, the base drive loop also relieves
head-of-line blocking by preempting the active request with the most
budget left.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.serving_load.base import ServingLoad


class EngineServingLoad(ServingLoad):
    def _admission_open(self, engine) -> bool:
        return True
