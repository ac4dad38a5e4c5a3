"""Comm/compute-overlap pipelines for AG+GEMM (the nvFuser slot).

The port of the JAX package's ``tp_columnwise/overlap.py``, the
re-creation of the upstream project's three nvFuser algorithms, here on
CUDA streams as upstream: every collective is posted asynchronously (NCCL
runs it on its own stream) and its handles are waited on only just before
its data is used, so the GEMMs issued meanwhile on the current stream
overlap it. The GEMM is ``torch.matmul``. Same options, defaults and shape
checks as the JAX member:

- ``default``: one all-gather, then the GEMM.
- ``coll_pipeline``: M tiled into ``s`` stages; stage ``i + 1``'s
  all-gather is posted before stage ``i``'s GEMM; ``m % (d*s) == 0``. The
  stage outputs land in rank-major order (the ``[s, d] -> [d, s]``
  reorder).
- ``p2p_pipeline``: each rank GEMMs the chunk it holds while the next ring
  hop (``Runtime.ring_shift``) forwards it, chunks scheduled by
  ``ring_schedule(d, 'ag_fwd')``. ``direction='bidirectional'`` splits
  each chunk in half and runs both ring directions at once, with distinct
  tags; ``m % 2d == 0``.
- ``chunked``: the chunked-fusion engine (``ops/chunked_fusion.py``):
  ``chunk_count`` row-chunks, each ring-all-gathered while the previous
  chunk's GEMM runs; ``m % (d*chunk_count) == 0``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops import chunked_fusion
from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.tp_columnwise.base import TPColumnwise
from ddlb_tpu_torch.utils.ring_schedule import ring_schedule

ALGORITHMS = ["default", "coll_pipeline", "p2p_pipeline", "chunked"]


def check_overlap_shapes(m: int, d: int, options) -> None:
    """The overlap members' divisibility rules (both tp families)."""
    algo = options["algorithm"]
    if algo == "coll_pipeline" and m % (d * options["s"]) != 0:
        raise ValueError(
            f"m={m} must be divisible by partitions*s={d * options['s']} "
            f"for coll_pipeline"
        )
    if algo == "chunked" and m % (d * options["chunk_count"]) != 0:
        raise ValueError(
            f"m={m} must be divisible by partitions*"
            f"chunk_count={d * options['chunk_count']} for the chunked engine"
        )
    if (algo == "p2p_pipeline" and options["direction"] == "bidirectional"
            and m % (2 * d) != 0):
        raise ValueError(
            f"m={m} must be divisible by 2*partitions={2 * d} "
            f"for bidirectional p2p_pipeline"
        )


class OverlapTPColumnwise(TPColumnwise):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

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
        check_overlap_shapes(self.m, self.num_partitions, self.options)

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
        return chunked_fusion.build_chunked_ag_matmul(
            m=self.m, n=self.n, k=self.k, runtime=self.runtime,
            chunk_count=int(self.options["chunk_count"]),
        )

    def _build_default(self):
        gather = self.runtime.all_gather_rows

        def step(a_shard, b):
            return torch_matmul(gather(a_shard), b)

        return step

    def _build_coll_pipeline(self):
        d, s, n, k = self.num_partitions, self.options["s"], self.n, self.k
        b_rows = self.m // (d * s)  # rows per rank per stage
        gather = self.runtime.all_gather_rows

        def step(a_shard, b):
            # a_shard: [m/d, k] = [s, b_rows, k] stage-major per rank
            chunks = a_shard.reshape(s, b_rows, k)
            out = torch.empty((d, s, b_rows, n), dtype=a_shard.dtype, device=a_shard.device)
            pending = gather(chunks[0], async_op=True)
            for i in range(s):
                slab, handles = pending
                if i + 1 < s:  # the next stage's gather flies under this GEMM
                    pending = gather(chunks[i + 1], async_op=True)
                for h in handles:
                    h.wait()
                # the slab's rows are rank-major; global order is rank, then
                # stage
                out[:, i] = torch_matmul(slab, b).reshape(d, b_rows, n)
            return out.reshape(self.m, n)

        return step

    def _build_p2p_pipeline(self):
        if self.options["direction"] == "bidirectional":
            return self._build_p2p_bidirectional()
        d, n = self.num_partitions, self.n
        b_rows = self.m // d
        shift = self.runtime.ring_shift
        # sched[t]: the chunk this rank holds after t forward hops
        sched = ring_schedule(d, "ag_fwd")[self.rank]

        def step(a_shard, b):
            out = torch.empty((d, b_rows, n), dtype=a_shard.dtype, device=a_shard.device)
            held = a_shard
            for t in range(d):
                handles = []
                if t + 1 < d:  # send the chunk on while its GEMM runs
                    (nxt,), handles = shift(held)
                out[int(sched[t])] = torch_matmul(held, b)
                for h in handles:
                    h.wait()
                if t + 1 < d:
                    held = nxt
            return out.reshape(self.m, n)

        return step

    def _build_p2p_bidirectional(self):
        d, n = self.num_partitions, self.n
        half = self.m // d // 2
        shift = self.runtime.ring_shift
        sched_f = ring_schedule(d, "ag_fwd")[self.rank]
        sched_r = ring_schedule(d, "ag_bwd")[self.rank]

        def step(a_shard, b):
            # the halves travel opposite ways round the ring
            buf_f, buf_r = a_shard[:half].contiguous(), a_shard[half:].contiguous()
            out = torch.empty((d, 2, half, n), dtype=a_shard.dtype, device=a_shard.device)
            for t in range(d):
                handles = []
                if t + 1 < d:
                    (nxt_f,), h_f = shift(buf_f, tag=0)
                    (nxt_r,), h_r = shift(buf_r, reverse=True, tag=1)
                    handles = h_f + h_r
                out[int(sched_f[t]), 0] = torch_matmul(buf_f, b)
                out[int(sched_r[t]), 1] = torch_matmul(buf_r, b)
                for h in handles:
                    h.wait()
                if t + 1 < d:
                    buf_f, buf_r = nxt_f, nxt_r
            return out.reshape(self.m, n)

        return step
