"""The routed member: dp > 1 as one engine per dp shard behind the
prefix-affinity router.

The counterpart of the JAX package's ``serving_load/router.py``. The
single engine is a dp = 1 world by design (its batch axis is the slot
axis); this member is how serving composes with data parallelism: ``dp``
engines each own ``batch / dp`` slots, and the ``PrefixAffinityRouter``
dispatches each arrival (shared-prefix affinity first, the least
outstanding work otherwise). Against the ``engine`` member at the same
total slot count and offered load, the routed row's TTFT tail is what the
router exists to improve: admission prefills serialize per engine, so two
engines admit where one would wait.

With ``watch_ticks`` set, the SLO-aware straggler watch arms: a shard
whose median decode tick both dominates its peers and breaks the TPOT SLO
on its own is indicted and drained (in-flight requests migrate to the
survivors over the KV-handoff path, queued ones re-route).
"""

from __future__ import annotations

from typing import Tuple

from ddlb_tpu_torch.primitives.serving_load.cluster_base import (
    CLUSTER_ALLOWED,
    CLUSTER_OPTIONS,
    ClusterServingLoad,
)


class RouterServingLoad(ClusterServingLoad):
    DEFAULT_OPTIONS = {
        **CLUSTER_OPTIONS,
        #: decode engines (dp shards); the batch splits evenly across them
        "dp": 2,
    }
    ALLOWED_VALUES = {
        **CLUSTER_ALLOWED,
        "dp": (1, None),
    }

    def _pool_sizes(self) -> Tuple[int, int]:
        return 0, self.options["dp"]

    def _topology_base(self) -> str:
        return f"router:dp={self.options['dp']}"
