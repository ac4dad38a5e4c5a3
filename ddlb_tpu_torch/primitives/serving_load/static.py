"""The batch-synchronous strawman: admit only when every slot is idle.

The counterpart of the JAX package's ``serving_load/static.py``: a wave
of requests is admitted together and the next waits until the whole
batch drains, so one long generation holds ``batch - 1`` finished lanes.
Under the same traffic as ``engine``, the TTFT and goodput gap between
the two is what continuous batching wins.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.serving_load.base import ServingLoad


class StaticServingLoad(ServingLoad):
    def _admission_open(self, engine) -> bool:
        return not engine.active_slots()
