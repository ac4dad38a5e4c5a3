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
link hop), and the row counts both (``serve_handoff_bytes`` /
``serve_handoff_ms``). The JAX member's ``handoff_bytes`` (the trace's
planned handoff census, read by its family cost model) waits for the
port's cost model.
"""

from __future__ import annotations

from typing import Tuple

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
