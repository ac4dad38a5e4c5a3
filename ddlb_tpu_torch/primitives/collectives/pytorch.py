"""Explicit collectives: one ``torch.distributed`` call per op, nothing else
in the measured step.

The counterpart of the JAX package's ``collectives/jax_spmd.py`` (one
``jax.lax`` collective per op):

- ``all_gather``: ``Runtime.all_gather_rows`` (NCCL's all-gather);
- ``reduce_scatter``: ``Runtime.reduce_scatter_rows``;
- ``all_to_all``: ``Runtime.all_to_all_rows``;
- ``ppermute``: one ``Runtime.ring_shift`` hop to the next rank;
- ``all_reduce`` by ``strategy``: ``psum``, one NCCL all-reduce; ``rs_ag``,
  the two-phase ring decomposition (reduce-scatter, then all-gather), to
  race against it; ``hierarchical``, the two-level decomposition over a
  (node, card-in-node) split of the world read from ``LOCAL_WORLD_SIZE``:
  reduce-scatter within the node, all-reduce of the scattered block
  across the nodes among equal local ranks, all-gather within the node,
  so the links between nodes carry ``1 / (cards a node)`` of the payload.
  On one node the across-node step has one member and the strategy is
  ``rs_ag`` exactly, which the member logs. ``hierarchical`` decomposes
  ``all_reduce`` only and builds its own split, so an overridden
  ``transport`` is rejected.
"""

from __future__ import annotations

import logging

from ddlb_tpu_torch.primitives.collectives.base import Collectives

log = logging.getLogger(__name__)


class PyTorchCollectives(Collectives):
    DEFAULT_OPTIONS = {"strategy": "psum"}
    ALLOWED_VALUES = {"strategy": ["psum", "rs_ag", "hierarchical"]}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        if self.options["strategy"] != "hierarchical":
            return
        if self.options["op"] != "all_reduce":
            raise ValueError("strategy='hierarchical' decomposes all_reduce only")
        if "transport" in self._options_manager.overridden:
            raise ValueError(
                "strategy='hierarchical' builds its own (node, card) split of "
                "the world; the transport axis does not apply"
            )
        local = self.runtime.local_world_size
        if self.num_partitions % local:
            raise ValueError(
                f"world {self.num_partitions} is not whole nodes of "
                f"LOCAL_WORLD_SIZE={local}"
            )
        if self.num_partitions == local:
            log.warning(
                "strategy='hierarchical' on a single node: the across-node "
                "step has one member; this row measures the rs_ag decomposition"
            )

    def _input_setup(self) -> None:
        super()._input_setup()
        rt = self.runtime
        op, strategy = self.options["op"], self.options["strategy"]
        if op == "all_gather":
            self._fn = rt.all_gather_rows
        elif op == "reduce_scatter":
            self._fn = rt.reduce_scatter_rows
        elif op == "all_to_all":
            self._fn = rt.all_to_all_rows
        elif op == "ppermute":
            def step(a_shard):
                (out,), handles = rt.ring_shift(a_shard)
                for h in handles:
                    h.wait()
                return out

            self._fn = step
        elif strategy == "psum":
            # all_reduce sums in place: hand it a fresh copy every call
            self._fn = lambda a_shard: rt.all_reduce(a_shard.clone())
        elif strategy == "rs_ag":
            self._fn = lambda a_shard: rt.all_gather_rows(rt.reduce_scatter_rows(a_shard))
        else:
            local = rt.local_world_size
            # (node, card-in-node) as a (dp, tp) mesh: rank = node * local + card
            mesh = rt.mesh(self.num_partitions // local, local)

            def step(a_shard):
                part = mesh.tp_reduce_scatter_rows(a_shard)
                part = mesh.axis_sum(part.clone(), "dp")
                return mesh.tp_all_gather_rows(part)

            self._fn = step
