"""K4 and K5: the pure ring collectives, written by hand in CUDA C++.

Replace ``ddlb_tpu/ops/ring_collectives.py``'s two Pallas programs, the
communication half of the ring collective matmuls (K2, K3) with no GEMM in
the way:

- K4 ``ring_all_gather`` (``_ring_ag_kernel``): ``a_shard [m/d, k] ->
  [m, k]`` on every rank. At step ``t`` rank ``r`` lands the chunk it
  holds, ``(r - t) % d``, in its output rows while it forwards it to rank
  ``r + 1``. At d = 1 it is one copy.
- K5 ``ring_reduce_scatter`` (``_ring_rs_kernel``): ``a_local [m/d, k]``
  viewed as d chunks ``[m/d^2, k]``; the sum of chunk ``j`` over the ranks
  lands on rank ``j``. At step ``t`` rank ``r`` folds chunk
  ``(r + d - 1 - t) % d`` into the accumulator rank ``r - 1`` sent and
  forwards it. The accumulator travels in the operand dtype, as on the TPU
  (``acc_init`` there): each hop rounds ``float(chunk) + float(received)``
  once; step 0 sends the chunk as it is.

Bound (one rank at ``scripts/config_collectives.json``'s m = k = 8192 bf16,
d = 4, the data sheet's 450 GB/s a direction of NVLink): K4 sends 3 shards
of 32 MiB, 0.224 ms; K5 3 chunks of 8 MiB, 0.056 ms. Both move bytes only.

Design (``csrc/ring_collectives.cu`` has the full note): K2's ring
protocol without the GEMM, on per-block flags. One cooperative launch a
rank; every block reads its share of the chunk once and stores it twice
(K4: the output rows and the right neighbour's slot) or folds it (K5: the
sum's store is the put), four 16-byte loads in flight a thread; two slots
of a chunk in peer memory (``Runtime.peer_buffer``), credits before a
slot is reused, an entry barrier with both neighbours, epochs instead of
resets. Both signal point to point: block ``b``'s share at step ``t``
depends on block ``b`` of the left rank at step ``t - 1`` alone (every
rank splits a chunk the same way), so each block waits for that block's
arrival and for the right rank's block ``b``'s credit, and the blocks move
through the ring at their own pace. The per-block words
(``block_flag_offsets``) fill the flag area past the entry barrier's first
1 KB: the rings share K2/K3's layout (``collective_matmul.Ring``:
``collective_matmul.FLAG_BYTES`` of flags, then two slots), whose flag
area is sized for them, so ``peer_ring`` and ``loopback_ring`` make them
with kind ``all_gather`` or ``reduce_scatter``, and ``buffer_bytes`` is
the same for every kind; a grid is at most ``MAX_FLAG_BLOCKS`` blocks a
rank. A ring serves one kernel only (its counters grow by one a launch).
A launch's host work is kept small: the buffer table of a ring, its slot
stride and the element sizes are computed once, and the library asks
CUDA for a kernel's grid once a process.

Dispatch: a CPU tensor takes the plain version (``ring_*_plain``: the same
ring over ``Runtime.ring_shift``, one hop in flight). A CUDA tensor
launches the kernel on the ``Ring`` the caller set up once, or raises;
there is no fallback. ``ring_*_virtual`` run the ring's arithmetic over a
list of ``d`` shards in one process (the loopback check and the CPU
tests); ``ring_*_loopback`` launch the kernel for ``d`` virtual ranks on
one card. Both kernels take float32, float16 and bfloat16 with rows of a
multiple of 16 bytes (``k * itemsize % 16 == 0``). ``LAUNCHES`` counts
kernel launches, ``ag`` for K4 and ``rs`` for K5.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from ddlb_tpu_torch.ops import _build
from ddlb_tpu_torch.ops import collective_matmul as cm

#: kernel launches since the counts were last reset (plain calls excluded)
LAUNCHES = {"ag": 0, "rs": 0}
#: the ring kinds of the two kernels (``collective_matmul.Ring.kind``) and
#: their codes in ``ddlb_ring_collective``
KINDS = {"all_gather": 0, "reduce_scatter": 1}
_COUNTER = {"all_gather": "ag", "reduce_scatter": "rs"}
_NAMES = {"all_gather": "K4 ring_all_gather", "reduce_scatter": "K5 ring_reduce_scatter"}
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_ITEMSIZE = {torch.float32: 4, torch.float16: 2, torch.bfloat16: 2}
#: K4's and K5's per-block flag area, as ``csrc/ring_collectives.cu`` lays
#: it out (its ``BLOCK_FLAGS``, ``BLOCK_WORDS`` and ``MAX_FLAG_BLOCKS``, held
#: inside ``FLAG_BYTES`` by a ``static_assert`` there): its first uint32
#: word, the words a block (arrivals of steps 0..7, then credits) and the
#: blocks it holds, which caps both grids. The kernels address their flags
#: themselves; these describe the layout to the tests.
BLOCK_FLAG_WORD, BLOCK_FLAG_WORDS, MAX_FLAG_BLOCKS = 256, 16, 304


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def block_flag_offsets(block: int, step: int):
    """Byte offsets in a K4 or K5 ring's buffer of block ``block``'s
    arrival counter and credit of ring step ``step``."""
    if not (0 <= block < MAX_FLAG_BLOCKS and 0 <= step < cm.MAX_RANKS):
        raise ValueError(f"block {block}, step {step}: K4/K5 hold {MAX_FLAG_BLOCKS} "
                         f"blocks of {cm.MAX_RANKS} steps")
    word = BLOCK_FLAG_WORD + block * BLOCK_FLAG_WORDS + step
    return 4 * word, 4 * (word + cm.MAX_RANKS)


def peer_ring(runtime, kind: str, chunk_numel: int, dtype: torch.dtype) -> cm.Ring:
    """The ring of this rank's world in peer memory for ``kind``
    (``all_gather``: a chunk is the ``[m/d, k]`` shard; ``reduce_scatter``:
    ``[m/d^2, k]``). Collective."""
    _check_kind(kind)
    return cm.peer_ring(runtime, kind, chunk_numel, dtype)


def loopback_ring(kind: str, d: int, chunk_numel: int, dtype: torch.dtype,
                  device) -> cm.Ring:
    """``d`` ranks' buffers in one card's memory, for a loopback launch."""
    _check_kind(kind)
    return cm.loopback_ring(kind, d, chunk_numel, dtype, device)


# -- checks and launch --------------------------------------------------------------


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"ring kind must be one of {list(KINDS)}, got {kind!r}")


def check_rows(k: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless K4/K5 take rows of ``k`` elements of
    ``dtype``: float32, float16 or bfloat16, a positive multiple of 16
    bytes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"K4/K5 take {[str(d) for d in _DTYPE_CODES]}, got {dtype}")
    size = _ITEMSIZE[dtype]
    if k < 1 or (k * size) % 16:
        raise ValueError(
            f"K4/K5 move 16-byte units: rows of {k} x {size} bytes are not a "
            f"positive multiple of 16"
        )


def check_operand(x: torch.Tensor) -> None:
    """Raise ``ValueError`` unless K4/K5 take ``x``: a non-empty 2-D tensor
    on the card or the CPU with rows ``check_rows`` takes."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"non-empty 2-D operands only, got {tuple(x.shape)}")
    check_rows(x.shape[1], x.dtype)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"cuda or cpu tensors only, got {x.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_collectives")
    u64p = ctypes.POINTER(ctypes.c_ulonglong)
    lib.ddlb_ring_collective.argtypes = [
        ctypes.c_int, ctypes.c_int, u64p, u64p, u64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p,
    ]
    lib.ddlb_ring_collective.restype = ctypes.c_int
    lib.ddlb_ring_collective_flag_bytes.restype = ctypes.c_int
    lib.ddlb_ring_collective_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_ring_collective_error_string.restype = ctypes.c_char_p
    if lib.ddlb_ring_collective_flag_bytes() != cm.FLAG_BYTES:
        raise RuntimeError("csrc/ring_collectives.cu's FLAG_BYTES is not the ring layout's")
    return lib


def _table(ptrs):
    return (ctypes.c_ulonglong * len(ptrs))(*ptrs)


@functools.lru_cache(maxsize=64)
def _ring_table(ptrs: tuple):
    """A ring's buffer table as the C entry point takes it (a ring's
    buffers never move)."""
    return _table(ptrs)


@functools.lru_cache(maxsize=64)
def _slot_stride_bytes(chunk_numel: int, dtype: torch.dtype) -> int:
    return cm._slot_stride(chunk_numel, dtype) * _ITEMSIZE[dtype]


def _launch(kind: str, ring: cm.Ring, a: Sequence[torch.Tensor],
            out: Sequence[torch.Tensor], chunk_numel: int) -> None:
    """One launch of K4 or K5 for the virtual ranks ``ring.rank0 ..`` of
    ``a`` and ``out``; a chunk is ``chunk_numel`` elements."""
    lib = _lib()
    vranks = len(a)
    if ring.rank0 + vranks > ring.d:
        raise ValueError(f"ranks {ring.rank0}..{ring.rank0 + vranks - 1} of a ring of {ring.d}")
    device = a[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ddlb_ring_collective(
            KINDS[kind], _DTYPE_CODES[ring.dtype],
            _table([t.data_ptr() for t in a]), _table([t.data_ptr() for t in out]),
            _ring_table(ring.ptrs), ring.rank0, vranks, ring.d,
            chunk_numel * _ITEMSIZE[ring.dtype] // 16,
            _slot_stride_bytes(ring.chunk_numel, ring.dtype),
            ring.epoch % 2**32, stream,
        )
    LAUNCHES[_COUNTER[kind]] += 1
    if rc != 0:
        raise RuntimeError(
            f"{_NAMES[kind]} launch failed: "
            f"{lib.ddlb_ring_collective_error_string(rc).decode()} (cudaError {rc})"
        )
    ring.epoch += 1


def _check_world_ring(ring: Optional[cm.Ring], runtime, what: str) -> None:
    if ring is None or ring.d != runtime.world_size or ring.rank0 != runtime.position:
        raise ValueError(f"{what} needs this world's peer ring (ops.ring_collectives.peer_ring)")


# -- K4: ring all-gather ----------------------------------------------------------------


def ring_all_gather(a_shard: torch.Tensor, runtime,
                    ring: Optional[cm.Ring] = None) -> torch.Tensor:
    """``a_shard [m/d, k] -> [m, k]``, every rank's shard in rank order,
    over the world's ring (kernel K4 on the card, on ``ring`` from
    ``peer_ring(runtime, 'all_gather', ...)``)."""
    check_operand(a_shard)
    if a_shard.device.type == "cpu":
        return ring_all_gather_plain(a_shard, runtime)
    _check_world_ring(ring, runtime, "K4")
    cm.check_launch(ring, "all_gather", (a_shard,), a_shard.numel())
    out = torch.empty((ring.d * a_shard.shape[0], a_shard.shape[1]),
                      dtype=a_shard.dtype, device=a_shard.device)
    _launch("all_gather", ring, [a_shard], [out], a_shard.numel())
    return out


def ring_all_gather_plain(a_shard: torch.Tensor, runtime) -> torch.Tensor:
    """K4's ring over ``Runtime.ring_shift``: each held chunk lands in its
    output rows while the next hop is in flight."""
    d, r = runtime.world_size, runtime.position
    m_loc = a_shard.shape[0]
    out = torch.empty((d * m_loc, a_shard.shape[1]), dtype=a_shard.dtype,
                      device=a_shard.device)
    held = a_shard.contiguous()
    for t in range(d):
        handles = []
        if t + 1 < d:
            (nxt,), handles = runtime.ring_shift(held)
        c = (r - t) % d
        out[c * m_loc:(c + 1) * m_loc] = held
        for h in handles:
            h.wait()
        if t + 1 < d:
            held = nxt
    return out


def ring_all_gather_virtual(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K4's ring run for ``d = len(shards)`` ranks in one process: rank
    ``r`` lands the chunk it holds at each step, ``shards[(r - t) % d]``.
    Returns every rank's ``[m, k]``."""
    d, m_loc = len(shards), shards[0].shape[0]
    outs = []
    for r in range(d):
        out = torch.empty((d * m_loc, shards[0].shape[1]), dtype=shards[0].dtype,
                          device=shards[0].device)
        for t in range(d):
            c = (r - t) % d
            out[c * m_loc:(c + 1) * m_loc] = shards[c]
        outs.append(out)
    return outs


def ring_all_gather_loopback(shards: Sequence[torch.Tensor],
                             ring: Optional[cm.Ring] = None) -> List[torch.Tensor]:
    """One K4 launch running ``d = len(shards)`` virtual ranks on one card
    (rank ``r`` holds ``shards[r]``). Returns every rank's ``[m, k]``.
    ``ring`` (from ``loopback_ring``) is made anew when not given."""
    for s in shards:
        check_operand(s)
        if s.shape != shards[0].shape or s.dtype != shards[0].dtype:
            raise ValueError("every shard has the same shape and dtype")
    d, (m_loc, k) = len(shards), shards[0].shape
    x = shards[0]
    if ring is None:
        ring = loopback_ring("all_gather", d, m_loc * k, x.dtype, x.device)
    if ring.d != d:
        raise ValueError(f"{d} shards on a ring of {ring.d}")
    cm.check_launch(ring, "all_gather", shards, m_loc * k)
    outs = [torch.empty((d * m_loc, k), dtype=x.dtype, device=x.device) for _ in range(d)]
    _launch("all_gather", ring, list(shards), outs, m_loc * k)
    return outs


# -- K5: ring reduce-scatter -------------------------------------------------------------


def _rows_per_chunk(a_local: torch.Tensor, d: int) -> int:
    if a_local.shape[0] % d:
        raise ValueError(f"local rows {a_local.shape[0]} not divisible by d={d}")
    return a_local.shape[0] // d


def ring_reduce_scatter(a_local: torch.Tensor, runtime,
                        ring: Optional[cm.Ring] = None) -> torch.Tensor:
    """``a_local [m/d, k]`` as d chunks ``[m/d^2, k]`` -> this rank's
    chunk summed over the world's ring, ``[m/d^2, k]`` (kernel K5 on the
    card, on ``ring`` from ``peer_ring(runtime, 'reduce_scatter', ...)``)."""
    check_operand(a_local)
    rows = _rows_per_chunk(a_local, runtime.world_size)
    if a_local.device.type == "cpu":
        return ring_reduce_scatter_plain(a_local, runtime)
    _check_world_ring(ring, runtime, "K5")
    chunk = rows * a_local.shape[1]
    cm.check_launch(ring, "reduce_scatter", (a_local,), chunk)
    out = torch.empty((rows, a_local.shape[1]), dtype=a_local.dtype, device=a_local.device)
    _launch("reduce_scatter", ring, [a_local], [out], chunk)
    return out


def ring_reduce_scatter_plain(a_local: torch.Tensor, runtime) -> torch.Tensor:
    """K5's ring over ``Runtime.ring_shift``: the accumulator's hop is in
    flight while the next chunk is sliced, then folded in."""
    d, r = runtime.world_size, runtime.position
    rows = _rows_per_chunk(a_local, d)
    acc, handles = None, []
    for t in range(d):
        c = (r + d - 1 - t) % d
        chunk = a_local[c * rows:(c + 1) * rows]
        if acc is None:
            acc = chunk.contiguous()
        else:
            for h in handles:
                h.wait()
            acc = cm.fold(chunk, received)
        if t + 1 < d:
            (received,), handles = runtime.ring_shift(acc)
    return acc


def ring_reduce_scatter_virtual(a_locals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K5's ring run for ``d = len(a_locals)`` ranks in one process, hop by
    hop: at step ``t`` rank ``r`` folds its chunk ``(r + d - 1 - t) % d``
    into the accumulator rank ``r - 1`` sent. Returns every rank's
    ``[m/d^2, k]``."""
    d = len(a_locals)
    rows = _rows_per_chunk(a_locals[0], d)
    accs = [None] * d
    for t in range(d):
        sent = list(accs)
        for r in range(d):
            c = (r + d - 1 - t) % d
            chunk = a_locals[r][c * rows:(c + 1) * rows]
            accs[r] = chunk.clone() if t == 0 else cm.fold(chunk, sent[(r - 1) % d])
    return accs


def ring_reduce_scatter_loopback(a_locals: Sequence[torch.Tensor],
                                 ring: Optional[cm.Ring] = None) -> List[torch.Tensor]:
    """One K5 launch running ``d = len(a_locals)`` virtual ranks on one
    card. Returns every rank's ``[m/d^2, k]``. ``ring`` (from
    ``loopback_ring``) is made anew when not given."""
    for x in a_locals:
        check_operand(x)
        if x.shape != a_locals[0].shape or x.dtype != a_locals[0].dtype:
            raise ValueError("every rank's operand has the same shape and dtype")
    d, x = len(a_locals), a_locals[0]
    rows = _rows_per_chunk(x, d)
    chunk = rows * x.shape[1]
    if ring is None:
        ring = loopback_ring("reduce_scatter", d, chunk, x.dtype, x.device)
    if ring.d != d:
        raise ValueError(f"{d} ranks on a ring of {ring.d}")
    cm.check_launch(ring, "reduce_scatter", a_locals, chunk)
    outs = [torch.empty((rows, x.shape[1]), dtype=x.dtype, device=x.device) for _ in range(d)]
    _launch("reduce_scatter", ring, list(a_locals), outs, chunk)
    return outs
