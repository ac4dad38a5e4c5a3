"""Chunked compute/collective fusion: the ring engine behind ``overlap``'s
``chunked`` algorithm.

The port of the JAX package's ``ops/chunked_fusion.py`` for the four
collective GEMM families. The GEMM is tiled along the sharded dimension
into ``chunk_count`` pieces; each chunk's collective is an explicit ring
of ``Runtime.ring_shift`` hops, each hop's handles waited on just before
its data is used, so that a hop in flight (on NCCL's own stream on the
card) overlaps the GEMM issued meanwhile on the current stream. At steady
state two chunk buffers are live: the one the GEMM consumes and the one
on the wire. Chunking does not change the bytes on the wire, only the
schedule.

- ``build_chunked_ag_matmul`` (``tp_columnwise``): each chunk is
  ring-all-gathered, then GEMMed; chunk ``j + 1``'s first hop is posted
  before chunk ``j``'s GEMM.
- ``build_chunked_matmul_rs`` (``tp_rowwise``): each chunk's partial GEMM
  feeds a ring reduce-scatter; the travelling accumulator rides the wire
  in the operand dtype and folds in float32 (``accum_wire_dtypes``).
- ``build_chunked_matmul_ar`` (``dp_allreduce``): each chunk's partial
  GEMM is ring-reduce-scattered, then its reduced blocks are
  ring-all-gathered; the next chunk's GEMM is issued under the first hop.
- ``build_chunked_alltoall_expert`` (``ep_alltoall``): each chunk of every
  routing group rides ``ring_a2a_chunk`` (``d - 1`` shift-by-``t``
  exchanges) to its expert and back.

With ``path="cuda"`` the tp builders route to the hand-written ring kernels
K2/K3 (``ops/collective_matmul.py``; the JAX package's ``path="pallas"``),
whose two peer-memory slots are this engine's two buffers held by the
kernel, with the ring granularity pinned to ``chunk_count == d`` (one
chunk per ring step, the only granularity their credit protocol encodes).

Left out: the JAX module's ``plan_report``, which writes the planned
chunk and hop schedule as telemetry spans and fault-injection sites (the
port has neither subsystem yet).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops.accum import accum_matmul, torch_matmul
from ddlb_tpu_torch.utils.ring_schedule import ring_schedule

PATHS = ("ring_shift", "cuda")


def fwd_perm(d: int):
    """The clockwise neighbour ring ``i -> i+1 (mod d)``."""
    return [(i, (i + 1) % d) for i in range(d)]


def accum_wire_dtypes(dtype: torch.dtype):
    """(accumulator, wire) dtypes of ring partial sums: floats accumulate
    in float32 and ride the wire in the operand dtype; integers are exact
    and stay as they are (``ddlb_tpu/primitives/base.py::accum_wire_dtypes``)."""
    if dtype.is_floating_point:
        return torch.float32, dtype
    return dtype, dtype


def ring_ag_chunk(piece: torch.Tensor, my_sched, runtime, first=None):
    """Ring all-gather of one chunk: ``piece [r, ...]`` -> ``[d, r, ...]``
    rank-major. ``my_sched[t]`` is the rank whose piece this rank holds
    after ``t`` hops (``ag_fwd``). ``first``, when given, is the already
    posted first hop of ``piece`` (``(received, handles)``)."""
    d = runtime.world_size
    out = torch.empty((d,) + tuple(piece.shape), dtype=piece.dtype, device=piece.device)
    held = piece
    pending = first
    for t in range(d):
        out[int(my_sched[t])] = held
        if t + 1 < d:
            (held,), handles = pending or runtime.ring_shift(held)
            pending = None
            for h in handles:
                h.wait()
    return out


def ring_rs_chunk(partial: torch.Tensor, my_sched, runtime, block_rows: int,
                  acc_t: torch.dtype, wire_t: torch.dtype,
                  in_flight: Optional[Callable[[], None]] = None) -> torch.Tensor:
    """Ring reduce-scatter of one chunk's partial sums: ``partial
    [d*block_rows, n]`` (rank-major blocks) -> ``[block_rows, n]``, this
    rank's block summed over the ring. ``my_sched[t]`` is the block folded
    at step ``t`` (``rs_fwd``); the accumulator rides the wire in
    ``wire_t`` and folds in ``acc_t``. ``in_flight`` (the next chunk's
    GEMM) is issued while the first hop is on the wire."""
    d = runtime.world_size
    acc = None
    for t in range(d):
        c = int(my_sched[t])
        block = partial[c * block_rows:(c + 1) * block_rows].to(acc_t)
        acc = block if acc is None else acc + block
        if t + 1 < d:
            (received,), handles = runtime.ring_shift(acc.to(wire_t).contiguous())
            if in_flight is not None:
                in_flight()
                in_flight = None
            for h in handles:
                h.wait()
            acc = received.to(acc_t)
    if in_flight is not None:
        in_flight()
    return acc


def ring_a2a_chunk(x: torch.Tensor, runtime) -> torch.Tensor:
    """All-to-all of one chunk as ``d - 1`` shift-by-``t`` exchanges:
    ``x [d, g, ...]`` (block ``e`` bound for ring position ``e``) ->
    ``[d, g, ...]`` (block ``s`` arrived from position ``s``), the tiled
    ``all_to_all`` with split and concat axis 0. The diagonal block stays
    local, so a rank's wire is ``(d - 1) / d`` of the payload. Each
    exchange (``Runtime.ring_shift(offset=t)``: send to position ``r + t``,
    receive from ``r - t``) is waited on before the next is posted."""
    d, r = runtime.world_size, runtime.position
    out = torch.empty_like(x)
    out[r] = x[r]
    for t in range(1, d):
        (recv,), handles = runtime.ring_shift(x[(r + t) % d].contiguous(), offset=t)
        for h in handles:
            h.wait()
        out[(r - t) % d] = recv
    return out


def _check_granularity(m: int, d: int, chunk_count: int) -> None:
    if m % (d * chunk_count):
        raise ValueError(
            f"m={m} must be divisible by partitions*chunk_count="
            f"{d * chunk_count} for the chunked engine"
        )


def _require_ring_granularity(chunk_count: int, d: int) -> None:
    if chunk_count != d:
        raise ValueError(
            f"the cuda path's credit protocol pins chunk_count to the ring "
            f"size (one chunk per ring step): got chunk_count={chunk_count}, "
            f"axis_size={d}"
        )


def build_chunked_ag_matmul(*, m: int, n: int, k: int, runtime, chunk_count: int,
                            path: str = "ring_shift", ring: Optional[cm.Ring] = None):
    """AG+GEMM (tp_columnwise): ``a_shard [m/d, k]``, ``b [k, n]`` ->
    ``[m, n]``. The shard is tiled into ``chunk_count`` row-chunks; chunk
    ``j`` is ring-all-gathered and GEMMed while chunk ``j + 1``'s first hop
    flies. Requires ``m % (d * chunk_count) == 0``. ``path="cuda"`` takes
    K2 on ``ring`` (``ops.collective_matmul.peer_ring``)."""
    d = runtime.world_size
    _check_granularity(m, d, chunk_count)
    if path == "cuda":
        _require_ring_granularity(chunk_count, d)

        def kernel_step(a_shard, b):
            return cm.ring_ag_matmul(a_shard, b, runtime, ring)

        return kernel_step
    if path != "ring_shift":
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    rows_c = m // (d * chunk_count)  # rows per rank per chunk
    my_sched = ring_schedule(d, "ag_fwd")[runtime.position]

    def step(a_shard, b):
        chunks = a_shard.reshape(chunk_count, rows_c, k)
        out = torch.empty((d, chunk_count, rows_c, n), dtype=a_shard.dtype,
                          device=a_shard.device)
        first = runtime.ring_shift(chunks[0]) if d > 1 else None
        for j in range(chunk_count):
            gathered = ring_ag_chunk(chunks[j], my_sched, runtime, first)
            first = (runtime.ring_shift(chunks[j + 1])
                     if d > 1 and j + 1 < chunk_count else None)
            # rank-major rows of chunk j: global order is rank, then chunk
            out[:, j] = torch_matmul(gathered.reshape(d * rows_c, k), b).reshape(d, rows_c, n)
        return out.reshape(m, n)

    return step


def build_chunked_matmul_rs(*, m: int, n: int, k: int, runtime, chunk_count: int,
                            path: str = "ring_shift", ring: Optional[cm.Ring] = None):
    """GEMM+RS (tp_rowwise): ``a_shard [m, k/d]``, ``b_shard [k/d, n]`` ->
    ``[m/d, n]``. Chunk ``j``'s slab gathers the rows that land as every
    rank's local chunk-``j`` block; its partial GEMM feeds a ring
    reduce-scatter. Requires ``m % (d * chunk_count) == 0``.
    ``path="cuda"`` takes K3 on ``ring``."""
    d = runtime.world_size
    _check_granularity(m, d, chunk_count)
    if path == "cuda":
        _require_ring_granularity(chunk_count, d)

        def kernel_step(a_shard, b_shard):
            return cm.ring_matmul_rs(a_shard, b_shard, runtime, ring)

        return kernel_step
    if path != "ring_shift":
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    rows_c = m // (d * chunk_count)
    kd = k // d
    my_sched = ring_schedule(d, "rs_fwd")[runtime.position]

    def step(a_shard, b_shard):
        acc_t, wire_t = accum_wire_dtypes(a_shard.dtype)
        a4 = a_shard.reshape(d, chunk_count, rows_c, kd)
        partials = [None] * (chunk_count + 1)

        def gemm(j):
            if j < chunk_count:
                slab = a4[:, j].reshape(d * rows_c, kd)
                partials[j] = accum_matmul(slab, b_shard, acc_t)

        gemm(0)
        outs = []
        for j in range(chunk_count):
            outs.append(ring_rs_chunk(
                partials[j], my_sched, runtime, rows_c, acc_t, wire_t,
                in_flight=lambda j=j: gemm(j + 1),
            ))
            partials[j] = None
        # local row order is chunk-major: [c, rows_c, n] -> [m/d, n]
        return torch.stack(outs).reshape(m // d, n).to(a_shard.dtype)

    return step


def build_chunked_matmul_ar(*, m: int, n: int, k: int, runtime, chunk_count: int):
    """GEMM+AR (dp_allreduce): ``a_shard [m, k/d]``, ``b_shard [k/d, n]`` ->
    ``[m, n]`` on every rank. The all-reduce is decomposed RS -> AG around
    each chunk's GEMM: chunk ``j`` (the contiguous row slab ``j`` of
    ``chunk_count``; every row is local in the k-sharded layout) GEMMs its
    float32 partial, ring-reduce-scatters it (the accumulator on the wire
    in the operand dtype) and ring-all-gathers the reduced blocks; chunk
    ``j + 1``'s GEMM is issued while chunk ``j``'s first hop is on the
    wire. Requires ``m % (d * chunk_count) == 0``."""
    d = runtime.world_size
    _check_granularity(m, d, chunk_count)
    rows_c = m // (d * chunk_count)  # rows per rank-block per chunk
    kd = k // d
    my_rs = ring_schedule(d, "rs_fwd")[runtime.position]
    my_ag = ring_schedule(d, "ag_fwd")[runtime.position]

    def step(a_shard, b_shard):
        acc_t, wire_t = accum_wire_dtypes(a_shard.dtype)
        a3 = a_shard.reshape(chunk_count, d * rows_c, kd)
        partials = [None] * (chunk_count + 1)

        def gemm(j):
            if j < chunk_count:
                partials[j] = accum_matmul(a3[j], b_shard, acc_t)

        gemm(0)
        outs = []
        for j in range(chunk_count):
            red = ring_rs_chunk(partials[j], my_rs, runtime, rows_c, acc_t, wire_t,
                                in_flight=lambda j=j: gemm(j + 1))
            partials[j] = None
            # [d, rows_c, n] rank-major: the slab's row order
            gathered = ring_ag_chunk(red.to(a_shard.dtype), my_ag, runtime)
            outs.append(gathered.reshape(d * rows_c, n))
        return torch.cat(outs)

    return step


def build_chunked_alltoall_expert(*, m: int, n: int, k: int, runtime,
                                  chunk_count: int):
    """Dispatch, expert GEMM, combine (ep_alltoall): ``a_loc [m/d, k]``,
    ``w_loc [k, n]`` (the resident expert) -> ``[m/d, n]`` in token order.
    Every routing group is tiled into ``chunk_count`` chunks; chunk ``j``'s
    dispatch (``ring_a2a_chunk``), expert GEMM (float32 sums, rounded once
    to the operand dtype) and combine run in turn. Requires
    ``m % (d * d * chunk_count) == 0``."""
    d = runtime.world_size
    if m % (d * d * chunk_count):
        raise ValueError(
            f"m={m} must be divisible by partitions^2*chunk_count="
            f"{d * d * chunk_count} for the chunked engine"
        )
    gc = m // (d * d * chunk_count)  # tokens per chunk per group

    def step(a_loc, w_loc):
        acc_t, _ = accum_wire_dtypes(a_loc.dtype)
        x = a_loc.reshape(d, chunk_count, gc, k)  # [dst group, chunk, token, k]
        outs = []
        for j in range(chunk_count):
            xj = ring_a2a_chunk(x[:, j].contiguous(), runtime)
            yj = accum_matmul(xj.reshape(d * gc, k), w_loc, acc_t)
            yj = yj.to(a_loc.dtype).reshape(d, gc, n)
            outs.append(ring_a2a_chunk(yj, runtime))
        return torch.stack(outs, dim=1).reshape(d * chunk_count * gc, n)

    return step
