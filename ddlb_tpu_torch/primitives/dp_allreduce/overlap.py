"""Comm/compute-overlap pipelines for GEMM+AR (the nvFuser slot, DP member).

The port of the JAX package's ``dp_allreduce/overlap.py``, on CUDA streams
as the tp overlap members: collectives are posted asynchronously and
waited on just before their data is used. The overlapped collective is a
full all-reduce of the gradient. Same options, defaults and shape checks
as the JAX member:

- ``default``: one partial GEMM, one all-reduce.
- ``coll_pipeline``: M tiled into ``s`` stages; stage ``i`` GEMMs an
  ``[m/s, k/d]`` slab and posts its all-reduce, which flies while stage
  ``i + 1``'s GEMM runs; ``m % s == 0``.
- ``p2p_pipeline``: a ring all-reduce. A reduce-scatter phase of ``d``
  ring steps, each folding a per-chunk GEMM into the partial sums whose
  hop is in flight (the tp_rowwise ring: float32 accumulator, the operand
  dtype on the wire; ``tp_rowwise.overlap.ring_rs_unidirectional``), then
  an all-gather phase circulating the finished
  chunks ``d - 1`` more hops; ``m % d == 0``.
  ``direction='bidirectional'`` runs both ring directions with
  half-chunks; ``m % 2d == 0``.
- ``chunked``: the chunked-fusion engine (``ops/chunked_fusion.py``,
  ``build_chunked_matmul_ar``); ``m % (d*chunk_count) == 0``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops import chunked_fusion
from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.dp_allreduce.base import DPAllReduce
from ddlb_tpu_torch.primitives.tp_columnwise.overlap import ALGORITHMS
from ddlb_tpu_torch.primitives.tp_rowwise.overlap import (
    ring_rs_bidirectional,
    ring_rs_unidirectional,
)
from ddlb_tpu_torch.utils.ring_schedule import ring_schedule


class OverlapDPAllReduce(DPAllReduce):
    DEFAULT_OPTIONS = {
        "algorithm": "coll_pipeline",
        "s": 8,
        "direction": "unidirectional",
        "chunk_count": 2,
    }
    ALLOWED_VALUES = {
        "algorithm": ALGORITHMS,
        "s": (1, None),
        "direction": ["unidirectional", "bidirectional"],
        "chunk_count": (1, None),
    }

    def _check_shapes(self) -> None:
        super()._check_shapes()
        d = self.num_partitions
        algo = self.options["algorithm"]
        if algo == "coll_pipeline" and self.m % self.options["s"] != 0:
            raise ValueError(
                f"m={self.m} must be divisible by s={self.options['s']} "
                f"for coll_pipeline"
            )
        if algo == "chunked":
            c = self.options["chunk_count"]
            if self.m % (d * c) != 0:
                raise ValueError(
                    f"m={self.m} must be divisible by partitions*"
                    f"chunk_count={d * c} for the chunked engine"
                )
        if algo == "p2p_pipeline":
            need = 2 * d if self.options["direction"] == "bidirectional" else d
            if self.m % need != 0:
                raise ValueError(
                    f"m={self.m} must be divisible by {need} for "
                    f"p2p_pipeline ({self.options['direction']})"
                )

    def _input_setup(self) -> None:
        super()._input_setup()
        self._fn = {
            "default": self._build_default,
            "coll_pipeline": self._build_coll_pipeline,
            "p2p_pipeline": self._build_p2p_pipeline,
            "chunked": self._build_chunked,
        }[self.options["algorithm"]]()

    # -- algorithms ----------------------------------------------------------

    def _build_chunked(self):
        return chunked_fusion.build_chunked_matmul_ar(
            m=self.m, n=self.n, k=self.k, runtime=self.runtime,
            chunk_count=int(self.options["chunk_count"]),
        )

    def _build_default(self):
        all_reduce = self.runtime.all_reduce

        def step(a_shard, b_shard):
            return all_reduce(torch_matmul(a_shard, b_shard))

        return step

    def _build_coll_pipeline(self):
        s = self.options["s"]
        rows = self.m // s
        all_reduce = self.runtime.all_reduce

        def step(a_shard, b_shard):
            tiles, handles = [], []
            for i in range(s):
                tile, h = all_reduce(torch_matmul(a_shard[i * rows:(i + 1) * rows], b_shard),
                                     async_op=True)
                tiles.append(tile)
                handles += h
            for h in handles:
                h.wait()
            return torch.cat(tiles)

        return step

    def _build_p2p_pipeline(self):
        d = self.num_partitions
        b_rows = self.m // d
        shift = self.runtime.ring_shift
        # the reduce-scatter phase leaves each rank its own chunk, reduced;
        # the all-gather phase tracks the chunk held after t hops
        if self.options["direction"] == "unidirectional":
            sched_rs = ring_schedule(d, "rs_fwd")[self.rank]
            sched_ag = ring_schedule(d, "ag_fwd")[self.rank]

            def step(a_shard, b_shard):
                acc = ring_rs_unidirectional(a_shard, b_shard, b_rows, sched_rs, shift)
                out = chunked_fusion.ring_ag_chunk(acc.to(a_shard.dtype), sched_ag,
                                                   self.runtime)
                return out.reshape(self.m, self.n)

            return step
        rs_f = ring_schedule(d, "rs_fwd")[self.rank]
        rs_r = ring_schedule(d, "rs_bwd")[self.rank]
        ag_f = ring_schedule(d, "ag_fwd")[self.rank]
        ag_r = ring_schedule(d, "ag_bwd")[self.rank]

        def step(a_shard, b_shard):
            # front halves ride the forward ring, back halves the backward one
            acc_f, acc_r = ring_rs_bidirectional(a_shard, b_shard, b_rows, rs_f, rs_r, shift)
            buf_f, buf_r = acc_f.to(a_shard.dtype), acc_r.to(a_shard.dtype)
            out = torch.empty((d, 2, b_rows // 2, self.n), dtype=a_shard.dtype,
                              device=a_shard.device)
            for t in range(d):
                out[int(ag_f[t]), 0] = buf_f
                out[int(ag_r[t]), 1] = buf_r
                if t + 1 < d:
                    (buf_f,), h_f = shift(buf_f, tag=0)
                    (buf_r,), h_r = shift(buf_r, reverse=True, tag=1)
                    for h in h_f + h_r:
                        h.wait()
            return out.reshape(self.m, self.n)

        return step
