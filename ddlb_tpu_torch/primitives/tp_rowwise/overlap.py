"""Comm/compute-overlap pipelines for GEMM+RS (the nvFuser slot).

The port of the JAX package's ``tp_rowwise/overlap.py``, on CUDA streams
as the tp_columnwise overlap member (see its docstring): collectives are
posted asynchronously and waited on just before their data is used. The
sequence (M) dimension is what gets tiled. Same options, defaults and
shape checks as the JAX member:

- ``default``: one partial GEMM, one reduce-scatter.
- ``coll_pipeline``: ``s`` stages; stage ``i`` GEMMs its row slab of the
  partial product and posts its reduce-scatter, which flies while the
  next stage's GEMM runs; ``m % (d*s) == 0``.
- ``p2p_pipeline``: a ring reduce-scatter; the partial sums of each output
  chunk travel the ring (``ring_schedule(d, 'rs_fwd')``), each rank adding
  its contribution, whose GEMM runs while the accumulator's hop is in
  flight. The accumulator is float32 and rounds to the operand dtype only
  on the wire: each local product is a float32 product of the operands in
  their own dtype (``ops.accum.accum_matmul``), never a product in the
  operand dtype cast afterwards. ``direction='bidirectional'`` runs both
  ring directions with half-chunks; ``m % 2d == 0``.
- ``chunked``: the chunked-fusion engine (``ops/chunked_fusion.py``);
  ``m % (d*chunk_count) == 0``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops import chunked_fusion
from ddlb_tpu_torch.ops.accum import accum_matmul
from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.tp_columnwise.overlap import (
    ALGORITHMS,
    check_overlap_shapes,
)
from ddlb_tpu_torch.primitives.tp_rowwise.base import TPRowwise
from ddlb_tpu_torch.utils.ring_schedule import ring_schedule


class OverlapTPRowwise(TPRowwise):
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
        return chunked_fusion.build_chunked_matmul_rs(
            m=self.m, n=self.n, k=self.k, runtime=self.runtime,
            chunk_count=int(self.options["chunk_count"]),
        )

    def _build_default(self):
        scatter = self.runtime.reduce_scatter_rows

        def step(a_shard, b_shard):
            return scatter(torch_matmul(a_shard, b_shard))

        return step

    def _build_coll_pipeline(self):
        d, s = self.num_partitions, self.options["s"]
        b_rows = self.m // (d * s)
        kd = self.k // d
        scatter = self.runtime.reduce_scatter_rows

        def step(a_shard, b_shard):
            # stage i needs the rows that land as local stage-i rows on
            # every rank: view [d, s, b_rows, k/d]
            chunks = a_shard.reshape(d, s, b_rows, kd)
            outs, handles = [], []
            for i in range(s):
                partial = torch_matmul(chunks[:, i].reshape(d * b_rows, kd), b_shard)
                out, h = scatter(partial, async_op=True)  # [b_rows, n], reduced
                outs.append(out)
                handles += h
            for h in handles:
                h.wait()
            # local row order is stage-major: [s, b_rows, n] -> [m/d, n]
            return torch.stack(outs).reshape(self.m // d, self.n)

        return step

    def _build_p2p_pipeline(self):
        d = self.num_partitions
        b_rows = self.m // d
        shift = self.runtime.ring_shift
        if self.options["direction"] == "bidirectional":
            sched_f = ring_schedule(d, "rs_fwd")[self.rank]
            sched_r = ring_schedule(d, "rs_bwd")[self.rank]

            def step(a_shard, b_shard):
                acc_f, acc_r = ring_rs_bidirectional(a_shard, b_shard, b_rows, sched_f,
                                                     sched_r, shift)
                return torch.cat([acc_f, acc_r]).to(a_shard.dtype)

            return step
        # the accumulator a rank holds at the end is its own chunk, reduced
        sched = ring_schedule(d, "rs_fwd")[self.rank]

        def step(a_shard, b_shard):
            return ring_rs_unidirectional(a_shard, b_shard, b_rows, sched,
                                          shift).to(a_shard.dtype)

        return step


def ring_rs_unidirectional(a_shard, b_shard, b_rows: int, sched, shift) -> torch.Tensor:
    """The p2p ring reduce-scatter of ``a_shard [d*b_rows, k/d] @ b_shard``:
    at step ``t`` the rows of chunk ``sched[t]`` are multiplied (a float32
    product of the operands in their own dtype, ``accum_matmul``) while the
    accumulator's hop (``shift``, ``Runtime.ring_shift``) is in flight, then
    folded in; the accumulator rides the wire in the operand dtype. Returns
    this rank's reduced ``[b_rows, n]`` chunk in float32 (the integer
    dtypes as they are). Shared with ``dp_allreduce``'s ``p2p_pipeline``."""
    acc_t, wire_t = chunked_fusion.accum_wire_dtypes(a_shard.dtype)
    acc, handles = None, []
    for t, c in enumerate(int(c) for c in sched):
        prod = accum_matmul(a_shard[c * b_rows:(c + 1) * b_rows], b_shard, acc_t)
        if acc is None:
            acc = prod
        else:
            for h in handles:
                h.wait()
            acc = received.to(acc_t) + prod
        if t + 1 < len(sched):  # the partial sums ride on in the operand dtype
            (received,), handles = shift(acc.to(wire_t))
    return acc


def ring_rs_bidirectional(a_shard, b_shard, b_rows: int, sched_f, sched_r, shift):
    """``ring_rs_unidirectional`` on both ring directions at once: the front
    half of each chunk rides the forward ring (``sched_f``), the back half
    the backward one (``sched_r``), with distinct tags. Returns the two
    reduced halves."""
    acc_t, wire_t = chunked_fusion.accum_wire_dtypes(a_shard.dtype)
    half = b_rows // 2
    acc_f = acc_r = None
    handles = []
    for t in range(len(sched_f)):
        cf, cr = int(sched_f[t]), int(sched_r[t])
        prod_f = accum_matmul(a_shard[cf * b_rows:cf * b_rows + half], b_shard, acc_t)
        prod_r = accum_matmul(a_shard[cr * b_rows + half:(cr + 1) * b_rows], b_shard, acc_t)
        if acc_f is None:
            acc_f, acc_r = prod_f, prod_r
        else:
            for h in handles:
                h.wait()
            acc_f = recv_f.to(acc_t) + prod_f
            acc_r = recv_r.to(acc_t) + prod_r
        if t + 1 < len(sched_f):
            (recv_f,), h_f = shift(acc_f.to(wire_t), tag=0)
            (recv_r,), h_r = shift(acc_r.to(wire_t), reverse=True, tag=1)
            handles = h_f + h_r
    return acc_f, acc_r
