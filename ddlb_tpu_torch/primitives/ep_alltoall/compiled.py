"""Compiler-partitioned MoE dispatch and combine: DTensor picks the
collectives, Inductor schedules them.

The counterpart of the JAX package's ``ep_alltoall/xla_gspmd.py``: the
tokens ``[m, k]`` and the expert stack ``[d, k, n]`` sharded over 'tp' on
dim 0, the tokens viewed as ``[src, expert, token, k]``, transposed to
expert-major and redistributed to expert-sharded (the dispatch, where the
JAX code has ``with_sharding_constraint``), the expert GEMM, and the
transpose back redistributed to source-sharded (the combine). DTensor
turns each ``Shard(1) -> Shard(0)`` into an all-to-all on NCCL; gloo has
no DTensor all-to-all, so on the CPU it is an all-gather and a chunk.

The expert GEMM runs in the operand dtype: a half-precision GEMM sums in
float32 and rounds once, as JAX's ``preferred_element_type=float32``
followed by the cast to the operand dtype does. The mesh is in rank
order, so under a reordered ring (``Runtime.order_ring``) each rank's
token groups are taken in rank order at set-up (group ``i`` is the one
bound for rank ``i``'s expert) and its outputs come back in rank order,
permuted into position order.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Shard

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin, local
from ddlb_tpu_torch.primitives.ep_alltoall.base import EPAllToAll
from ddlb_tpu_torch.runtime import placements


class CompiledEPAllToAll(CompiledOptionsMixin, EPAllToAll):
    def _input_setup(self) -> None:
        super()._input_setup()
        rt = self.runtime
        self.a = rt.blocks_by_rank(self.a)
        d, g = self.num_partitions, self.group_tokens
        m, n, k = self.m, self.n, self.k
        mesh = self.runtime.device_mesh(("tp",), (d,))
        rows = placements(mesh, {"tp": 0})
        self.a = DTensor.from_local(self.a, mesh, rows, run_check=False)
        # this rank's expert as its block of the [d, k, n] stack
        self.w = DTensor.from_local(self.w[None], mesh, rows, run_check=False)
        src = [Shard(0)]

        def step(a, w):
            x = a.reshape(d, d, g, k).redistribute(mesh, src)  # [src, expert, token, k]
            # expert-major: resharding axis 0 from src to expert is the dispatch
            xe = x.transpose(0, 1).redistribute(mesh, src)
            y = torch_matmul(xe.reshape(d, d * g, k), w).reshape(d, d, g, n)
            # source-major again: the combine
            return y.transpose(0, 1).redistribute(mesh, src).flatten(1, 2)

        compiled = self._compile(step, mesh)
        # [1, m/d, n] -> this rank's [m/d, n] rows (the global [d, m/d, n]
        # -> [m, n] merge of a sharded axis, which DTensor refuses at d = 1)
        self._fn = lambda a, w: rt.blocks_by_position(local(compiled(a, w))[0])
