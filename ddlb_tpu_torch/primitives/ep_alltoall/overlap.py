"""Comm/compute-overlap pipelines for MoE dispatch and combine (the nvFuser
slot, EP member).

The port of the JAX package's ``ep_alltoall/overlap.py``, on CUDA streams
as the other overlap members: collectives are posted asynchronously and
waited on just before their data is used. Each expert GEMM sums in
float32 (the integer dtypes in int32) and rounds once to the operand
dtype. Same options, defaults and shape checks as the JAX member:

- ``default``: one dispatch all-to-all, one expert GEMM, one combine
  all-to-all (the ``pytorch`` member's schedule).
- ``coll_pipeline``: each routing group split into ``s`` chunks; chunk
  ``i + 1``'s dispatch is posted before chunk ``i``'s GEMM and chunk
  ``i``'s combine flies while chunk ``i + 1``'s GEMM runs;
  ``m % (d^2*s) == 0``.
- ``chunked``: the chunked-fusion engine (``ops/chunked_fusion.py``,
  ``build_chunked_alltoall_expert``: every exchange as ``d - 1``
  shift-by-``t`` hops); ``m % (d^2*chunk_count) == 0``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops import chunked_fusion
from ddlb_tpu_torch.ops.accum import accum_matmul
from ddlb_tpu_torch.primitives.ep_alltoall.base import EPAllToAll


class OverlapEPAllToAll(EPAllToAll):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"algorithm": "coll_pipeline", "s": 4, "chunk_count": 2}
    ALLOWED_VALUES = {
        "algorithm": ["default", "coll_pipeline", "chunked"],
        "s": (1, None),
        "chunk_count": (1, None),
    }

    def _check_shapes(self) -> None:
        super()._check_shapes()
        d, s = self.num_partitions, self.options["s"]
        if self.options["algorithm"] == "coll_pipeline" and self.m % (d * d * s) != 0:
            raise ValueError(
                f"m={self.m} must be divisible by d^2*s={d * d * s} for "
                f"coll_pipeline"
            )
        if self.options["algorithm"] == "chunked":
            c = self.options["chunk_count"]
            if self.m % (d * d * c) != 0:
                raise ValueError(
                    f"m={self.m} must be divisible by d^2*chunk_count="
                    f"{d * d * c} for the chunked engine"
                )

    def _input_setup(self) -> None:
        super()._input_setup()
        d, k, n = self.num_partitions, self.k, self.n
        a2a = self.runtime.all_to_all_rows
        algo = self.options["algorithm"]
        if algo == "chunked":
            self._fn = chunked_fusion.build_chunked_alltoall_expert(
                m=self.m, n=n, k=k, runtime=self.runtime,
                chunk_count=int(self.options["chunk_count"]),
            )
            return

        def expert(x, w_loc):
            acc_t, _ = chunked_fusion.accum_wire_dtypes(x.dtype)
            return accum_matmul(x, w_loc, acc_t).to(x.dtype)

        if algo == "default":
            def step(a_loc, w_loc):
                return a2a(expert(a2a(a_loc), w_loc))

            self._fn = step
            return

        s = self.options["s"]
        gc = self.m // (d * d * s)  # tokens per chunk per group

        def step(a_loc, w_loc):
            x = a_loc.reshape(d, s, gc, k)  # [dst group, chunk, token, k]
            outs, handles = [], []
            pending = a2a(x[:, 0].reshape(d * gc, k), async_op=True)
            for i in range(s):
                xi, waits = pending
                if i + 1 < s:  # the next chunk's dispatch flies under this GEMM
                    pending = a2a(x[:, i + 1].reshape(d * gc, k), async_op=True)
                for h in waits:
                    h.wait()
                yi, h = a2a(expert(xi, w_loc), async_op=True)
                outs.append(yi.reshape(d, gc, n))
                handles += h
            for h in handles:
                h.wait()
            return torch.stack(outs, dim=1).reshape(d * s * gc, n)  # [group, chunk, gc, n]

        self._fn = step
