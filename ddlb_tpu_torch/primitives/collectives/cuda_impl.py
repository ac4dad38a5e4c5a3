"""Hand-driven NVLink rings for the pure collectives: the kernel member.

The counterpart of the JAX package's ``pallas`` member
(``collectives/pallas_impl.py``): each op is one hand-written kernel a
rank, circulating the payload through peer memory with no compute in the
way (``ops/ring_collectives.py``):

- ``all_gather``: K4 (``ring_all_gather``), shard chunks ride the ring into
  the output rows;
- ``reduce_scatter``: K5 (``ring_reduce_scatter``), travelling partial sums
  fold each rank's chunk, in the operand dtype;
- ``all_reduce``: the two-phase ring, K5 then K4 on its result, two
  launches back to back, each on its own peer ring.

``all_to_all`` and ``ppermute`` stay with the ``pytorch`` member (their
fused form is K6, ``ops/alltoall_matmul.py``) and raise here. The peer
rings are allocated once, at set-up (a collective). ``detect_races`` (the
Pallas interpreter's race detector) has no CUDA counterpart: it stays in
the schema and only ``false`` is taken. K4 and K5 take bfloat16, float16
and float32 with rows of a multiple of 16 bytes; anything else raises
``ValueError`` at construction. On a CPU tensor the kernels' plain rings
run.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import ring_collectives as rc
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.collectives.base import Collectives


class CudaCollectives(Collectives):
    DEFAULT_OPTIONS = {"detect_races": False}
    ALLOWED_VALUES = {
        "op": ["all_gather", "reduce_scatter", "all_reduce"],
        "detect_races": [True, False],
    }

    def _check_shapes(self) -> None:
        super()._check_shapes()
        if self.options["detect_races"]:
            raise ValueError(
                "detect_races=true is the Pallas interpreter's race detector and "
                "has no CUDA counterpart in ddlb_tpu_torch"
            )
        rc.check_rows(self.k, torch_dtype(self.dtype))

    def _input_setup(self) -> None:
        super()._input_setup()
        rt, op, dtype = self.runtime, self.options["op"], self.a.dtype
        rows = self.m // self.num_partitions
        part = rows // self.num_partitions
        on_card = self.a.device.type == "cuda"
        gather = scatter = None
        if on_card and op in ("all_gather", "all_reduce"):
            chunk = (rows if op == "all_gather" else part) * self.k
            gather = rc.peer_ring(rt, "all_gather", chunk, dtype)
        if on_card and op in ("reduce_scatter", "all_reduce"):
            scatter = rc.peer_ring(rt, "reduce_scatter", part * self.k, dtype)

        if op == "all_gather":
            def step(a_shard):
                return rc.ring_all_gather(a_shard, rt, gather)
        elif op == "reduce_scatter":
            def step(a_shard):
                return rc.ring_reduce_scatter(a_shard, rt, scatter)
        else:
            def step(a_shard):
                return rc.ring_all_gather(rc.ring_reduce_scatter(a_shard, rt, scatter),
                                          rt, gather)
        self._fn = step
