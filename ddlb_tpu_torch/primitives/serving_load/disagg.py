"""The disaggregated member: separate prefill and decode engine pools
with an explicit, priced KV handoff between them.

The counterpart of the JAX package's ``serving_load/disagg.py``. Prefill
and decode want different hardware shapes (compute-bound against
memory-bound); this member realizes the split on the engine's own
mechanism: a request enters the prefill pool as ``max_new=1`` (completed
at admission: a prefill engine is a pure prefill server), and the remnant
continues in the decode pool through a ``KVBundle`` whose prompt is
exactly the ``preempt()`` fold, so no token is generated twice and the
prompt crosses the seam byte for byte.

The handoff is priced, not performed: ``perfmodel.cost.kv_bundle_bytes``
weighs the bundle with the decode census's per-row convention,
``kv_handoff_seconds`` floors its latency (two memory crossings and one
link hop, or a fitted table's constants under ``DDLB_TPU_CALIB``), and
the row counts both (``serve_handoff_bytes`` / ``serve_handoff_ms``).
``handoff_bytes`` is the trace's planned handoff census, which the family
cost model prices (``perfmodel.cost._serving_cost``).
"""

from __future__ import annotations

from typing import Tuple

from ddlb_tpu_torch.perfmodel.cost import kv_bundle_bytes
from ddlb_tpu_torch.primitives.serving_load.cluster_base import (
    CLUSTER_ALLOWED,
    CLUSTER_OPTIONS,
    ClusterServingLoad,
)


class DisaggServingLoad(ClusterServingLoad):
    DEFAULT_OPTIONS = {
        **CLUSTER_OPTIONS,
        "prefill_shards": 1,
        "decode_shards": 1,
    }
    ALLOWED_VALUES = {
        **CLUSTER_ALLOWED,
        "prefill_shards": (1, None),
        "decode_shards": (1, None),
    }

    def _pool_sizes(self) -> Tuple[int, int]:
        o = self.options
        return o["prefill_shards"], o["decode_shards"]

    def _topology_base(self) -> str:
        o = self.options
        return f"disagg:p{o['prefill_shards']}+d{o['decode_shards']}"

    def handoff_bytes(self) -> float:
        """The trace's planned handoff census (the JAX member's, :56):
        every request with budget past its prefill token hands ``S0 + 1``
        rows to the decode pool, the bytes the row's
        ``serve_handoff_bytes`` counts."""
        o = self.options
        return sum(
            kv_bundle_bytes(
                d_model=self.n,
                n_heads=o["n_heads"],
                n_kv_heads=o["n_kv_heads"],
                layers=o["layers"],
                kv_cache=o["kv_cache"],
                tokens=r.prompt.size + 1,
            )
            for r in self._trace
            if r.max_new > 1
        )
