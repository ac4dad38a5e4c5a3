"""Compiler-partitioned chain: DTensor picks how each stage's weight
reaches the activation, Inductor schedules it.

The counterpart of the JAX package's ``pp_pipeline/xla_gspmd.py``: the
chain as S plain products ``y @ W[j]`` against slices of the weight stack
``[S, k, n]``, sharded ``Shard(0)`` over a 'tp' mesh of the world (stage
``p`` on rank ``p``), with ``x`` and the output replicated. Picking a
stage out of the sharded stack is what makes DTensor move the weights:
each pick all-gathers the whole stack (``aten.select`` has no sharded
rule along the sharded dimension), so the eager program issues d
all-gathers of ``[S, k, n]`` where GSPMD broadcasts each stage once
(``CommDebugMode``, ``tests/test_torch_pipeline_multirank.py``); either
is the "weight-gathered pipeline" this member measures. The mesh is in
rank order, so under a reordered ring (``Runtime.order_ring``) the chain
walks the stack in position order (stage ``p`` is rank ``order[p]``'s
block). The options are the compiler knobs of ``compile_options``.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate

from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin, local
from ddlb_tpu_torch.primitives.pp_pipeline.base import PPPipeline
from ddlb_tpu_torch.primitives.pp_pipeline.compute_only import chain
from ddlb_tpu_torch.runtime import placements


class CompiledPPPipeline(CompiledOptionsMixin, PPPipeline):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    def _input_setup(self) -> None:
        super()._input_setup()
        mesh = self.runtime.device_mesh(("tp",), (self.num_partitions,))
        self.a = DTensor.from_local(self.a, mesh, placements(mesh, {}), run_check=False)
        self.w = DTensor.from_local(self.w[None], mesh, placements(mesh, {"tp": 0}),
                                    run_check=False)
        stages = list(self.runtime.order)
        compiled = self._compile(
            lambda a, w: chain(a, w, stages).redistribute(mesh, [Replicate()]), mesh)
        self._fn = lambda a, w: local(compiled(a, w))
