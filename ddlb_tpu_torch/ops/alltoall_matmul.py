"""K6: the fused MoE all-to-all expert GEMM, written by hand in CUDA C++.

Replaces ``ddlb_tpu/ops/alltoall_matmul.py``'s Pallas program
``alltoall_expert_matmul`` (``_a2a_matmul_kernel``): dispatch, the resident
expert's GEMM and the combine in one kernel a rank. Rank ``r`` holds tokens
``a_shard [m/d, k]`` in d contiguous routing groups of ``g = m/d^2`` (group
``e`` goes to expert ``e``, resident on rank ``e``) and its expert
``w_expert [k, n]``; it returns ``[m/d, n]`` in token order, group ``e``
through expert ``e``, the ``ep_alltoall`` contract. Each group's product
sums in float32 and rounds once to the operand dtype (``out_buf`` there).

Bound (one rank at ``scripts/config_ep_alltoall.json``'s 8192^3 bf16,
d = 4): the GEMM ``[2048, 8192] @ [8192, 8192]``, 0.275 TFLOP, 0.278 ms at
989 TFLOP/s; the wire, 25 MB each way, 0.056 ms at 450 GB/s.

Design (``csrc/alltoall_matmul.cu`` has the full note): a global entry
barrier over all ranks; group ``p`` is copied into rank ``p``'s dispatch
slot of this source, all at once (the slots are distinct, so no
credits); the GEMM multiplies the groups in arrival order ``(r + t) % d``,
each step waiting on its own slot's counter, and stores each result
straight into the combine region of the source's buffer; the landed
regions are copied into the output (the caller's output is not peer
memory: that copy is an ``[m/d, n]`` pass, and the result is never a view
of the buffers, which the next call reuses). The GEMM tile is chosen per
launch by dtype alone (``tile_for``; ``check_widths`` refuses rows that are
not a multiple of 16 bytes): bf16/fp16 run the Hopper
tile of ``csrc/hopper_gemm.cuh`` (one 384-thread block an SM, a TMA
producer warp, two ``wgmma`` consumer warpgroups whose epilogue is the
combine store; the producer warpgroup's three other warps do the copies,
so every SM runs the GEMM; at ``g = 512``, ``n = 8192`` a step is one wave
of 128 tiles); float32 runs K1's SIMT tile with dedicated put blocks.
The tensor maps (tokens, dispatch slots, expert) are encoded on the host
at each launch and passed by value. The buffers (``A2ABuffers``: flags,
d dispatch slots ``[g, k]``, d combine regions ``[g, n]``) are peer
memory (``Runtime.peer_buffer``), or one card's memory for ``d`` virtual
ranks in one launch (loopback).

Dispatch: a CPU tensor takes the plain version
(``alltoall_expert_matmul_plain``: ``chunked_fusion.ring_a2a_chunk``'s
d - 1 shift-by-t exchanges, ``Runtime.ring_shift(offset=t)``; K1's plain
product for each group; the mirrored exchanges back). A CUDA tensor
launches the kernel on the buffers the caller set up once, or raises.
``alltoall_expert_matmul_virtual`` runs the same arithmetic over ``d``
ranks in one process. K6 takes K1's dtypes (float32, float16, bfloat16)
with ``k`` and ``n`` rows of a multiple of 16 bytes. ``LAUNCHES["a2a"]``
counts kernel launches, ``TILES`` the launches by GEMM tile.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from ddlb_tpu_torch.ops import _build
from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.ops.chunked_fusion import ring_a2a_chunk

#: kernel launches since the counts were last reset (plain calls excluded)
LAUNCHES = {"a2a": 0}
#: the launches by GEMM tile, since the counts were last reset
TILES = {"wgmma": 0, "simt": 0}
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_TILE_CODES = cm._TILE_CODES
#: ranks one launch's table holds (one node of cards)
MAX_RANKS = 8
#: bytes of flag words at the head of each rank's buffer (the kernel's
#: FLAG_BYTES); the dispatch slots and combine regions follow
FLAG_BYTES = 4096


def reset_launches() -> None:
    LAUNCHES["a2a"] = 0
    for key in TILES:
        TILES[key] = 0


def tile_for(dtype: torch.dtype) -> str:
    """K6's GEMM tile for operands of ``dtype``: ``wgmma`` for bf16/fp16,
    ``simt`` for float32. The widths need no say: ``check_widths`` admits
    only rows of a multiple of 16 bytes (K6's copies move 16-byte units),
    which are TMA's widths too."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"K6 takes {[str(t) for t in _DTYPE_CODES]}, got {dtype}")
    return "simt" if dtype == torch.float32 else "wgmma"


# -- the buffers ---------------------------------------------------------------------


def buffer_bytes(d: int, g: int, k: int, n: int, dtype: torch.dtype) -> int:
    """Bytes of one rank's buffer: the flags, d dispatch slots ``[g, k]``,
    d combine regions ``[g, n]``."""
    size = torch.empty((), dtype=dtype).element_size()
    return FLAG_BYTES + d * g * (k + n) * size


class A2ABuffers:
    """One world's K6 buffers as a launch addresses them: ``ptrs[i]`` is rank
    ``i``'s buffer for groups of ``g`` tokens, ``k`` wide in and ``n`` wide
    out, of ``dtype``; ``rank0`` the rank of the launch's first virtual
    rank; ``epoch`` the number of launches made on them so far (the flags
    never reset; every rank must make the same launches). ``owner`` keeps
    the memory alive."""

    def __init__(self, ptrs: Sequence[int], rank0: int, g: int, k: int, n: int,
                 dtype: torch.dtype, owner) -> None:
        if not 1 <= len(ptrs) <= MAX_RANKS:
            raise ValueError(f"{len(ptrs)} ranks: K6 takes 1 to {MAX_RANKS}")
        self.ptrs, self.rank0 = tuple(ptrs), rank0
        self.d = len(self.ptrs)
        self.g, self.k, self.n, self.dtype, self.owner = g, k, n, dtype, owner
        self.epoch = 0


def peer_buffers(runtime, g: int, k: int, n: int, dtype: torch.dtype) -> A2ABuffers:
    """This world's K6 buffers in peer memory. Collective."""
    d = runtime.world_size
    buf = runtime.peer_buffer(buffer_bytes(d, g, k, n, dtype))
    return A2ABuffers(buf.ptrs, runtime.rank, g, k, n, dtype, buf)


def loopback_buffers(d: int, g: int, k: int, n: int, dtype: torch.dtype,
                     device) -> A2ABuffers:
    """``d`` ranks' buffers in one card's memory, for a loopback launch."""
    per = -(-buffer_bytes(d, g, k, n, dtype) // 256) * 256
    mem = torch.zeros(d * per, dtype=torch.uint8, device=device)
    base = mem.data_ptr()
    return A2ABuffers([base + i * per for i in range(d)], 0, g, k, n, dtype, mem)


# -- checks and launch ---------------------------------------------------------------


def check_operands(a: torch.Tensor, w: torch.Tensor, d: int) -> int:
    """Raise ``ValueError`` unless K6 takes ``a [d*g, k]`` and ``w [k, n]``;
    returns ``g``."""
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"2-D operands only, got {tuple(a.shape)} @ {tuple(w.shape)}")
    if a.shape[1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(w.shape)}")
    if a.dtype != w.dtype:
        raise ValueError(f"operand dtypes differ: {a.dtype} vs {w.dtype}")
    if a.device != w.device or a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"operands on {a.device} and {w.device}")
    if a.shape[0] % d or a.shape[0] == 0:
        raise ValueError(f"m/d={a.shape[0]} not a positive multiple of d={d}")
    check_widths(a.shape[1], w.shape[1], a.dtype)
    return a.shape[0] // d


def check_widths(k: int, n: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless K6 takes ``dtype`` with rows of ``k``
    elements in and ``n`` out: multiples of 16 bytes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"K6 takes {[str(t) for t in _DTYPE_CODES]}, got {dtype}")
    size = torch.empty((), dtype=dtype).element_size()
    if (k * size) % 16 or (n * size) % 16:
        raise ValueError(
            f"K6 moves 16-byte units: k={k} and n={n} times {size} bytes must "
            f"be multiples of 16"
        )


def _check_launch(bufs: A2ABuffers, tensors, g: int, k: int, n: int) -> None:
    if (bufs.g, bufs.k, bufs.n) != (g, k, n) or bufs.dtype != tensors[0].dtype:
        raise ValueError(
            f"buffers for g={bufs.g}, k={bufs.k}, n={bufs.n}, {bufs.dtype}; "
            f"operands of g={g}, k={k}, n={n}, {tensors[0].dtype}"
        )
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the kernel takes cuda tensors, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel takes contiguous, 16-byte aligned tensors")
    if max(max(t.shape) for t in tensors) > 2**31 - 1:
        raise ValueError("shape out of the kernel's range")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("alltoall_matmul")
    u64p = ctypes.POINTER(ctypes.c_ulonglong)
    lib.ddlb_a2a_matmul.argtypes = [
        ctypes.c_int, ctypes.c_int, u64p, u64p, u64p, u64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
    ]
    lib.ddlb_a2a_matmul.restype = ctypes.c_int
    lib.ddlb_a2a_blocks.argtypes = [ctypes.c_int] * 3
    lib.ddlb_a2a_blocks.restype = ctypes.c_int
    lib.ddlb_a2a_flag_bytes.restype = ctypes.c_int
    lib.ddlb_a2a_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_a2a_error_string.restype = ctypes.c_char_p
    if lib.ddlb_a2a_flag_bytes() != FLAG_BYTES:
        raise RuntimeError("csrc/alltoall_matmul.cu's FLAG_BYTES changed")
    return lib


def grid_blocks(dtype: torch.dtype, vranks: int) -> int:
    """Blocks a virtual rank gets in a K6 launch of ``vranks`` ranks of
    ``dtype`` (every block copies and multiplies in the Hopper tile). Needs
    the card."""
    tile = tile_for(dtype)
    got = _lib().ddlb_a2a_blocks(_DTYPE_CODES[dtype], _TILE_CODES[tile], vranks)
    if got < 0:
        raise RuntimeError(f"ddlb_a2a_blocks: {_lib().ddlb_a2a_error_string(-got).decode()}")
    return got


def _launch(bufs: A2ABuffers, a: Sequence[torch.Tensor], w: Sequence[torch.Tensor],
            out: Sequence[torch.Tensor]) -> None:
    """One K6 launch for the virtual ranks ``bufs.rank0 ..`` of ``a``,
    ``w`` and ``out``."""
    lib = _lib()
    vranks = len(a)
    if bufs.rank0 + vranks > bufs.d:
        raise ValueError(f"ranks {bufs.rank0}..{bufs.rank0 + vranks - 1} of {bufs.d}")

    def table(ptrs):
        return (ctypes.c_ulonglong * len(ptrs))(*ptrs)

    tile = tile_for(bufs.dtype)
    device = a[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ddlb_a2a_matmul(
            _DTYPE_CODES[bufs.dtype], _TILE_CODES[tile], table([t.data_ptr() for t in a]),
            table([t.data_ptr() for t in w]), table([t.data_ptr() for t in out]),
            table(bufs.ptrs), bufs.rank0, vranks, bufs.d, bufs.g, bufs.n, bufs.k,
            bufs.epoch % 2**32, stream,
        )
    LAUNCHES["a2a"] += 1
    TILES[tile] += 1
    if rc != 0:
        raise RuntimeError(
            f"K6 alltoall_expert_matmul launch failed on the {tile} tile: "
            f"{lib.ddlb_a2a_error_string(rc).decode()} (cudaError {rc})"
        )
    bufs.epoch += 1


# -- K6 and its plain versions ------------------------------------------------------


def alltoall_expert_matmul(a_shard: torch.Tensor, w_expert: torch.Tensor, runtime,
                           buffers: Optional[A2ABuffers] = None) -> torch.Tensor:
    """``a_shard [m/d, k]`` (d routing groups), this rank's expert
    ``w_expert [k, n]`` -> ``[m/d, n]`` in token order (kernel K6 on the
    card, on ``buffers`` from ``peer_buffers``)."""
    d = runtime.world_size
    g = check_operands(a_shard, w_expert, d)
    if a_shard.device.type == "cpu":
        return alltoall_expert_matmul_plain(a_shard, w_expert, runtime)
    if buffers is None or buffers.d != d or buffers.rank0 != runtime.rank:
        raise ValueError("K6 needs this world's peer buffers (ops.alltoall_matmul.peer_buffers)")
    k, n = w_expert.shape
    _check_launch(buffers, (a_shard, w_expert), g, k, n)
    out = torch.empty((d * g, n), dtype=a_shard.dtype, device=a_shard.device)
    _launch(buffers, [a_shard], [w_expert], [out])
    return out


def alltoall_expert_matmul_plain(a_shard: torch.Tensor, w_expert: torch.Tensor,
                                 runtime) -> torch.Tensor:
    """K6's exchange over ``Runtime.ring_shift``: the dispatch as d - 1
    shift-by-t exchanges, K1's plain product of each arrived group, the
    combine as the mirrored exchanges."""
    d = runtime.world_size
    g = check_operands(a_shard, w_expert, d)
    k, n = w_expert.shape
    arrived = ring_a2a_chunk(a_shard.reshape(d, g, k), runtime)
    done = torch.stack([k1.matmul_plain(arrived[s], w_expert) for s in range(d)])
    return ring_a2a_chunk(done, runtime).reshape(d * g, n)


def alltoall_expert_matmul_virtual(shards: Sequence[torch.Tensor],
                                   experts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K6 run for ``d = len(shards)`` ranks in one process: rank ``r``'s
    group ``e`` through expert ``e`` (K1's plain product), in token order.
    Returns every rank's ``[m/d, n]``."""
    d = len(shards)
    g = check_operands(shards[0], experts[0], d)
    return [
        torch.cat([k1.matmul_plain(a[e * g:(e + 1) * g], experts[e]) for e in range(d)])
        for a in shards
    ]


def alltoall_expert_matmul_loopback(shards: Sequence[torch.Tensor],
                                    experts: Sequence[torch.Tensor],
                                    buffers: Optional[A2ABuffers] = None
                                    ) -> List[torch.Tensor]:
    """One K6 launch running ``d = len(shards)`` virtual ranks on one card
    (rank ``r`` holds ``shards[r]`` and expert ``experts[r]``). Returns
    every rank's ``[m/d, n]``. ``buffers`` (from ``loopback_buffers``) are
    made anew when not given."""
    d = len(shards)
    if len(experts) != d:
        raise ValueError(f"{d} token shards and {len(experts)} experts")
    for a, w in zip(shards, experts):
        if a.shape != shards[0].shape or w.shape != experts[0].shape:
            raise ValueError("every rank's operands have the same shapes")
        g = check_operands(a, w, d)
    k, n = experts[0].shape
    x = shards[0]
    if buffers is None:
        buffers = loopback_buffers(d, g, k, n, x.dtype, x.device)
    if buffers.d != d:
        raise ValueError(f"{d} ranks on buffers of {buffers.d}")
    _check_launch(buffers, (*shards, *experts), g, k, n)
    outs = [torch.empty((d * g, n), dtype=x.dtype, device=x.device) for _ in range(d)]
    _launch(buffers, list(shards), list(experts), outs)
    return outs
