"""K2 and K3: the ring collective matmuls, written by hand in CUDA C++.

Replace ``ddlb_tpu/ops/collective_matmul.py``'s two Pallas programs, the
kernel-level re-creation of the upstream project's nvFuser p2p pipelines:

- K2 ``ring_ag_matmul`` (``_ag_matmul_kernel``): all-gather fused with the
  GEMM. ``a_shard [m/d, k] @ b [k, n] -> [m, n]``, the full product on
  every rank: at step ``t`` rank ``r`` GEMMs chunk ``(r - t) % d`` into
  its output rows while it forwards that chunk to rank ``r + 1``.
- K3 ``ring_matmul_rs`` (``_matmul_rs_kernel``): GEMM fused with a ring
  reduce-scatter. ``a_shard [m, k/d] @ b_shard [k/d, n] -> [m/d, n]``,
  this rank's rows of the sum: at step ``t`` rank ``r`` GEMMs the rows of
  chunk ``(r + d - 1 - t) % d``, adds the accumulator received from rank
  ``r - 1`` and forwards it. The accumulator travels in the operand dtype,
  as on the TPU (``acc_init`` there): each step rounds the GEMM once (the
  partial), then rounds ``partial + received`` once, both sums in
  float32.

Bound (one rank, 8192^3 bf16 at d = 4, the data sheet's peaks): K2's
GEMM is 2 * 8192^3 = 1.10 TFLOP (1.112 ms at 989 TFLOP/s) against 3
chunks of 32 MiB on the wire (0.224 ms at 450 GB/s); K3's is a quarter of
that (0.278 ms) against the same wire. Both are bound by the GEMM.

Design (``csrc/collective_matmul.cu`` has the full note): one cooperative
launch a rank, two slots of a chunk and monotonically growing flag
counters in peer memory (``Runtime.peer_buffer``: symmetric memory over
NVLink), credits from the right neighbour before a slot is reused, an
entry barrier with both neighbours and a drain of the last credits. The
GEMM tile of K2 and K3 is chosen per launch by dtype and shape alone
(``tile_for``):

- ``wgmma``, bf16/fp16 with ``k`` (K3: ``k/d``) and ``n`` rows of a
  multiple of 16 bytes (TMA's rules): ``csrc/hopper_gemm.cuh``, one
  384-thread block an SM, a TMA producer warp feeding a 4-stage ring of
  128x256x64 tiles to two ``wgmma`` consumer warpgroups. In K2 the
  producer warpgroup's three other warps are the puts, so every block
  puts its share of the chunk and every SM runs the GEMM; the TMA thread
  fences the async proxy after it acquires a slot a peer wrote, and a
  block's credit for a slot waits until every TMA load from it has
  landed. In K3 A is local, so the TMA thread loads every step's tiles
  without a flag and runs ahead of the ring; the consumers wait for the
  step's accumulator once, fold it with 16-byte loads and store the sum
  into the right neighbour's slot (the put), then signal and credit. The
  tensor maps (K2: the shard, the two slots, B; K3: A by chunk, B) are
  encoded on the host at each launch (a host-only call, no device work)
  and passed by value.
- ``wmma`` (16-bit, other widths) and ``simt`` (float32): K1's tiles,
  256 threads; K2's put blocks beside 128x128 GEMM blocks, K3's GEMM
  blocks folding in their epilogue.

A ring serves one tile: its counters grow by the putting blocks' count
each call, which differs between the tiles. The same device code runs
``d`` virtual ranks on one card (``loopback``: ``gridDim.y = d``, every
buffer in that card's memory), which is how one card checks the protocol.
Every ring of K2-K5 has one layout (``FLAG_BYTES`` of flags, then the two
slots); the flag area is sized for K5's per-block flags
(``ops/ring_collectives.py``), which K2 and K3 leave unused.

Dispatch: a CPU tensor takes the plain version (``ring_ag_matmul_plain``,
``ring_matmul_rs_plain``: the same ring over ``Runtime.ring_shift``, one
``batch_isend_irecv`` a hop, waited on just before its data is used). A
CUDA tensor launches the kernel on the ``Ring`` the caller set up once
(``peer_ring``), or raises; there is no fallback. ``ring_*_virtual`` run
the ring's arithmetic over a list of ``d`` shards in one process (the
loopback check and the CPU tests). ``LAUNCHES`` counts kernel launches,
``ag`` for K2 and ``rs`` for K3; ``TILES`` counts K2's launches by the
GEMM tile they ran and ``RS_TILES`` K3's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from ddlb_tpu_torch.ops import _build
from ddlb_tpu_torch.ops import matmul as k1

#: kernel launches since the counts were last reset (plain calls excluded)
LAUNCHES = {"ag": 0, "rs": 0}
#: K2's launches by GEMM tile, since the counts were last reset
TILES = {"wgmma": 0, "wmma": 0, "simt": 0}
#: K3's launches by GEMM tile, likewise
RS_TILES = {"wgmma": 0, "wmma": 0, "simt": 0}
_KINDS = {"ag": 0, "rs": 1}
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_TILE_CODES = {"simt": 0, "wmma": 1, "wgmma": 2}
#: ring ranks one launch's table holds (one node of cards)
MAX_RANKS = 8
#: bytes of flag words at the head of each rank's buffer (the kernels'
#: FLAG_BYTES, one size for every ring of K2-K5: the step counters in the
#: first 1 KB, K5's per-block flags after them); the two slots follow
FLAG_BYTES = 20480


def reset_launches() -> None:
    for counts in (LAUNCHES, TILES, RS_TILES):
        for key in counts:
            counts[key] = 0


def tile_for(dtype: torch.dtype, k: int, n: int) -> str:
    """The GEMM tile of K2 and K3 for operands of ``dtype``, ``[., k] @
    [k, n]`` (K3's ``k`` is a rank's ``k/d``):
    ``wgmma`` (the Hopper tile) for bf16/fp16 when ``k`` and ``n`` times
    the element size are multiples of 16 bytes (TMA's rule for a row),
    ``simt`` for float32, ``wmma`` for 16-bit rows of other widths."""
    check_dtype(dtype)
    if dtype == torch.float32:
        return "simt"
    size = torch.empty((), dtype=dtype).element_size()
    return "wgmma" if (k * size) % 16 == 0 and (n * size) % 16 == 0 else "wmma"


# -- the ring's buffers -----------------------------------------------------------


def _slot_stride(numel: int, dtype: torch.dtype) -> int:
    """Elements from slot 0 to slot 1: one chunk, rounded up to 16 bytes so
    that both slots take 16-byte stores."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-numel // per) * per


def buffer_bytes(chunk_numel: int, dtype: torch.dtype) -> int:
    """Bytes of one rank's buffer: the flags, then two slots of a chunk."""
    size = torch.empty((), dtype=dtype).element_size()
    return FLAG_BYTES + 2 * _slot_stride(chunk_numel, dtype) * size


class Ring:
    """One ring's buffers as a launch addresses them: ``ptrs[i]`` is ring
    position ``i``'s buffer (``Runtime.order``) (flags, then two slots of ``chunk_numel`` elements
    of ``dtype``), ``kind`` the one kernel it serves (``ag``, ``rs``; K4's
    and K5's ``all_gather``, ``reduce_scatter`` in ``ops/ring_collectives.py``,
    which share the layout), ``rank0`` the ring rank of the launch's first virtual
    rank, ``epoch`` the number of launches made on it so far (the flags
    never reset; every rank must make the same launches). ``owner`` keeps
    the memory alive."""

    def __init__(self, kind: str, ptrs: Sequence[int], rank0: int,
                 chunk_numel: int, dtype: torch.dtype, owner) -> None:
        if not 1 <= len(ptrs) <= MAX_RANKS:
            raise ValueError(f"a ring of {len(ptrs)} ranks: the ring kernels take 1 to {MAX_RANKS}")
        self.kind, self.ptrs, self.rank0 = kind, tuple(ptrs), rank0
        self.d = len(self.ptrs)
        self.chunk_numel, self.dtype, self.owner = chunk_numel, dtype, owner
        self.epoch = 0
        #: the GEMM tile of the launches on this ring (set by the first)
        self.tile: Optional[str] = None


def peer_ring(runtime, kind: str, chunk_numel: int, dtype: torch.dtype) -> Ring:
    """The ring of this rank's world in peer memory, for kernel ``kind``
    (``ag``: a chunk is ``[m/d, k]``; ``rs``: ``[m/d, n]``). Collective."""
    buf = runtime.peer_buffer(buffer_bytes(chunk_numel, dtype))
    return Ring(kind, buf.ptrs, runtime.position, chunk_numel, dtype, buf)


def loopback_ring(kind: str, d: int, chunk_numel: int, dtype: torch.dtype,
                  device) -> Ring:
    """``d`` ranks' buffers in one card's memory, for a loopback launch."""
    per = -(-buffer_bytes(chunk_numel, dtype) // 256) * 256
    mem = torch.zeros(d * per, dtype=torch.uint8, device=device)
    base = mem.data_ptr()
    return Ring(kind, [base + i * per for i in range(d)], 0, chunk_numel, dtype, mem)


# -- checks and launch --------------------------------------------------------------


def check_dtype(dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless K2/K3 compute in ``dtype`` (K1's)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"K2/K3 take {[str(d) for d in _DTYPE_CODES]}, got {dtype}"
        )


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"2-D operands only, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    check_dtype(a.dtype)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"cuda or cpu tensors only, got {a.device}")


def check_launch(ring: Ring, kind: str, tensors, chunk_numel: int) -> None:
    """Raise ``ValueError`` unless a launch of kernel ``kind`` may run on
    ``ring`` with ``tensors`` and chunks of ``chunk_numel`` elements (the
    ring kernels K2-K5 share it)."""
    if ring.kind != kind:
        raise ValueError(f"a '{ring.kind}' ring passed to the '{kind}' kernel")
    if ring.dtype != tensors[0].dtype:
        raise ValueError(f"ring of {ring.dtype}, operands of {tensors[0].dtype}")
    if chunk_numel > ring.chunk_numel:
        raise ValueError(
            f"a chunk of {chunk_numel} elements does not fit the ring's "
            f"{ring.chunk_numel}"
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
    lib = _build.load("collective_matmul")
    u64p = ctypes.POINTER(ctypes.c_ulonglong)
    lib.ddlb_ring_matmul.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p, u64p, u64p, u64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p,
    ]
    lib.ddlb_ring_matmul.restype = ctypes.c_int
    lib.ddlb_ring_blocks.argtypes = [ctypes.c_int] * 4
    lib.ddlb_ring_blocks.restype = ctypes.c_int
    lib.ddlb_ring_flag_bytes.restype = ctypes.c_int
    lib.ddlb_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_error_string.restype = ctypes.c_char_p
    if lib.ddlb_ring_flag_bytes() != FLAG_BYTES:
        raise RuntimeError("csrc/collective_matmul.cu's FLAG_BYTES changed")
    return lib


def grid_blocks(kind: str, dtype: torch.dtype, k: int, n: int, vranks: int) -> int:
    """Blocks a virtual rank gets in a launch of ``vranks`` ranks of ``kind``
    at these widths: every block puts in the Hopper tile (and in K3 on any
    tile), so the ring's counters grow by it each call. Needs the card."""
    tile = tile_for(dtype, k, n)
    got = _lib().ddlb_ring_blocks(_KINDS[kind], _DTYPE_CODES[dtype], _TILE_CODES[tile], vranks)
    if got < 0:
        raise RuntimeError(f"ddlb_ring_blocks: {_lib().ddlb_error_string(-got).decode()}")
    return got


def _launch(kind: str, ring: Ring, a: Sequence[torch.Tensor],
            b: Sequence[torch.Tensor], out: Sequence[torch.Tensor],
            m_loc: int, n: int, k: int) -> None:
    """One launch of K2 (``ag``) or K3 (``rs``) for the virtual ranks
    ``ring.rank0 ..`` of ``a``, ``b`` and ``out``."""
    vranks = len(a)
    if ring.rank0 + vranks > ring.d:
        raise ValueError(f"ranks {ring.rank0}..{ring.rank0 + vranks - 1} of a ring of {ring.d}")
    tile = tile_for(ring.dtype, k, n)
    if ring.tile not in (None, tile):
        raise ValueError(
            f"a ring of the '{ring.tile}' tile launched on the '{tile}' tile: its "
            f"counters grow by that tile's blocks; make a ring for these widths"
        )
    lib = _lib()

    def table(ptrs):
        return (ctypes.c_ulonglong * len(ptrs))(*ptrs)

    device = a[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ddlb_ring_matmul(
            _KINDS[kind], _DTYPE_CODES[ring.dtype], _TILE_CODES[tile],
            table([t.data_ptr() for t in a]), table([t.data_ptr() for t in b]),
            table([t.data_ptr() for t in out]), table(ring.ptrs),
            ring.rank0, vranks, ring.d, m_loc, n, k,
            _slot_stride(ring.chunk_numel, ring.dtype), ring.epoch % 2**32,
            stream,
        )
    LAUNCHES[kind] += 1
    (TILES if kind == "ag" else RS_TILES)[tile] += 1
    if rc != 0:
        raise RuntimeError(
            f"K{2 if kind == 'ag' else 3} ring_{kind} launch failed on the {tile} tile: "
            f"{lib.ddlb_error_string(rc).decode()} (cudaError {rc})"
        )
    ring.tile = tile
    ring.epoch += 1


# -- K2: all-gather + GEMM ------------------------------------------------------------


def ring_ag_matmul(a_shard: torch.Tensor, b: torch.Tensor, runtime,
                   ring: Optional[Ring] = None) -> torch.Tensor:
    """``a_shard [m/d, k] @ b [k, n] -> [m, n]`` over the world's ring
    (kernel K2 on the card, on ``ring`` from ``peer_ring``).

    On the card, bf16/fp16 operands with rows of a multiple of 16 bytes run
    the Hopper tile (``tile_for``): every block is a TMA producer, three
    put warps and two ``wgmma`` consumer warpgroups, so the chunk's
    forwarding shares each SM with its GEMM instead of taking SMs of its
    own. Other operands run K1's tiles beside dedicated put blocks."""
    _check_operands(a_shard, b)
    if a_shard.device.type == "cpu":
        return ring_ag_matmul_plain(a_shard, b, runtime)
    if ring is None or ring.d != runtime.world_size or ring.rank0 != runtime.position:
        raise ValueError("K2 needs this world's peer ring (ops.collective_matmul.peer_ring)")
    (m_loc, k), n = a_shard.shape, b.shape[1]
    check_launch(ring, "ag", (a_shard, b), m_loc * k)
    out = torch.empty((ring.d * m_loc, n), dtype=a_shard.dtype, device=a_shard.device)
    _launch("ag", ring, [a_shard], [b], [out], m_loc, n, k)
    return out


def ring_ag_matmul_plain(a_shard: torch.Tensor, b: torch.Tensor,
                         runtime) -> torch.Tensor:
    """K2's ring over ``Runtime.ring_shift``: each chunk's GEMM (K1's
    plain version) runs while the next hop is in flight."""
    d, r = runtime.world_size, runtime.position
    m_loc = a_shard.shape[0]
    out = torch.empty((d * m_loc, b.shape[1]), dtype=a_shard.dtype, device=a_shard.device)
    held = a_shard.contiguous()
    for t in range(d):
        handles = []
        if t + 1 < d:
            (nxt,), handles = runtime.ring_shift(held)
        c = (r - t) % d
        out[c * m_loc:(c + 1) * m_loc] = k1.matmul_plain(held, b)
        for h in handles:
            h.wait()
        if t + 1 < d:
            held = nxt
    return out


def ring_ag_matmul_virtual(shards: Sequence[torch.Tensor],
                           b: torch.Tensor) -> List[torch.Tensor]:
    """K2's ring run for ``d = len(shards)`` ranks in one process: rank
    ``r`` GEMMs the chunk it holds at each step, ``shards[(r - t) % d]``.
    Returns every rank's ``[m, n]``."""
    d, m_loc = len(shards), shards[0].shape[0]
    outs = []
    for r in range(d):
        out = torch.empty((d * m_loc, b.shape[1]), dtype=b.dtype, device=b.device)
        for t in range(d):
            c = (r - t) % d
            out[c * m_loc:(c + 1) * m_loc] = k1.matmul_plain(shards[c], b)
        outs.append(out)
    return outs


def ring_ag_matmul_loopback(shards: Sequence[torch.Tensor], b: torch.Tensor,
                            ring: Optional[Ring] = None) -> List[torch.Tensor]:
    """One K2 launch running ``d = len(shards)`` virtual ranks on one card
    (rank ``r`` holds ``shards[r]``; every rank reads the same ``b``).
    Returns every rank's ``[m, n]``. ``ring`` (from ``loopback_ring``) is
    made anew when not given."""
    for s in shards:
        _check_operands(s, b)
    d, (m_loc, k), n = len(shards), shards[0].shape, b.shape[1]
    if ring is None:
        ring = loopback_ring("ag", d, m_loc * k, b.dtype, b.device)
    if ring.d != d:
        raise ValueError(f"{d} shards on a ring of {ring.d}")
    check_launch(ring, "ag", (*shards, b), m_loc * k)
    if any(s.shape != shards[0].shape for s in shards):
        raise ValueError("every shard has the same shape")
    outs = [torch.empty((d * m_loc, n), dtype=b.dtype, device=b.device) for _ in range(d)]
    _launch("ag", ring, list(shards), [b] * d, outs, m_loc, n, k)
    return outs


# -- K3: GEMM + reduce-scatter ----------------------------------------------------------


def ring_matmul_rs(a_shard: torch.Tensor, b_shard: torch.Tensor, runtime,
                   ring: Optional[Ring] = None) -> torch.Tensor:
    """``a_shard [m, k/d] @ b_shard [k/d, n] -> [m/d, n]``, this rank's rows
    of the sum over the world's ring (kernel K3 on the card, on ``ring``
    from ``peer_ring``).

    On the card, bf16/fp16 operands with rows of a multiple of 16 bytes run
    the Hopper tile (``tile_for``): the TMA producer loads every step's
    tiles ahead of the ring, and the ``wgmma`` consumers fold the received
    accumulator into each tile and store it into the right neighbour's
    slot. Other operands run K1's tiles."""
    _check_operands(a_shard, b_shard)
    d = runtime.world_size
    if a_shard.shape[0] % d:
        raise ValueError(f"m={a_shard.shape[0]} not divisible by d={d}")
    if a_shard.device.type == "cpu":
        return ring_matmul_rs_plain(a_shard, b_shard, runtime)
    if ring is None or ring.d != d or ring.rank0 != runtime.position:
        raise ValueError("K3 needs this world's peer ring (ops.collective_matmul.peer_ring)")
    (m, kd), n = a_shard.shape, b_shard.shape[1]
    m_loc = m // d
    check_launch(ring, "rs", (a_shard, b_shard), m_loc * n)
    out = torch.empty((m_loc, n), dtype=a_shard.dtype, device=a_shard.device)
    _launch("rs", ring, [a_shard], [b_shard], [out], m_loc, n, kd)
    return out


def fold(partial: torch.Tensor, received: torch.Tensor) -> torch.Tensor:
    """One hop's accumulation: the sum in float32, rounded once to the
    operand dtype (the accumulator's dtype on the wire; K3's and K5's)."""
    return (partial.float() + received.float()).to(partial.dtype)


def ring_matmul_rs_plain(a_shard: torch.Tensor, b_shard: torch.Tensor,
                         runtime) -> torch.Tensor:
    """K3's ring over ``Runtime.ring_shift``: the next chunk's partial is
    computed while the accumulator's hop is in flight, then folded in."""
    d, r = runtime.world_size, runtime.position
    m_loc = a_shard.shape[0] // d
    acc, handles = None, []
    for t in range(d):
        c = (r + d - 1 - t) % d
        partial = k1.matmul_plain(a_shard[c * m_loc:(c + 1) * m_loc], b_shard)
        if acc is None:
            acc = partial
        else:
            for h in handles:
                h.wait()
            acc = fold(partial, received)
        if t + 1 < d:
            (received,), handles = runtime.ring_shift(acc)
    return acc


def ring_matmul_rs_virtual(a_shards: Sequence[torch.Tensor],
                           b_shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K3's ring run for ``d = len(a_shards)`` ranks in one process, hop by
    hop: at step ``t`` rank ``r`` folds its partial of chunk
    ``(r + d - 1 - t) % d`` into the accumulator rank ``r - 1`` sent.
    Returns every rank's ``[m/d, n]``."""
    d = len(a_shards)
    m_loc = a_shards[0].shape[0] // d
    accs = [None] * d
    for t in range(d):
        sent = list(accs)
        for r in range(d):
            c = (r + d - 1 - t) % d
            partial = k1.matmul_plain(a_shards[r][c * m_loc:(c + 1) * m_loc], b_shards[r])
            accs[r] = partial if t == 0 else fold(partial, sent[(r - 1) % d])
    return accs


def ring_matmul_rs_loopback(a_shards: Sequence[torch.Tensor],
                            b_shards: Sequence[torch.Tensor],
                            ring: Optional[Ring] = None) -> List[torch.Tensor]:
    """One K3 launch running ``d = len(a_shards)`` virtual ranks on one
    card. Returns every rank's ``[m/d, n]``. ``ring`` (from
    ``loopback_ring``) is made anew when not given."""
    d = len(a_shards)
    for a, b in zip(a_shards, b_shards, strict=True):
        _check_operands(a, b)
        if a.shape != a_shards[0].shape or b.shape != b_shards[0].shape:
            raise ValueError("every rank's operands have the same shapes")
    (m, kd), n = a_shards[0].shape, b_shards[0].shape[1]
    if m % d:
        raise ValueError(f"m={m} not divisible by d={d}")
    m_loc = m // d
    if ring is None:
        ring = loopback_ring("rs", d, m_loc * n, a_shards[0].dtype, a_shards[0].device)
    if ring.d != d:
        raise ValueError(f"{d} ranks on a ring of {ring.d}")
    check_launch(ring, "rs", (*a_shards, *b_shards), m_loc * n)
    outs = [torch.empty((m_loc, n), dtype=a_shards[0].dtype, device=a_shards[0].device)
            for _ in range(d)]
    _launch("rs", ring, list(a_shards), list(b_shards), outs, m_loc, n, kd)
    return outs


# -- tolerances ---------------------------------------------------------------------


def _spacing(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The distance between neighbouring ``dtype`` values at ``|x|``."""
    finfo = torch.finfo(dtype)
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(finfo.tiny)))) * finfo.eps


def ring_matmul_rs_gap_bound(a_shards: Sequence[torch.Tensor],
                             b_shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise bound on ``|K3 - ring_matmul_rs_virtual|`` for every
    rank's output.

    Each hop's GEMM sums the same products in float32 in another order
    (at most ``2 * (k/d) * 2**-23 * (|A| @ |B|)`` apart, K1's
    ``plain_gap_bound``); rounding two values that differ by ``delta``
    gives results at most ``delta`` plus one spacing of the larger apart.
    So the gap grows along the ring, hop by hop, by the GEMM gap, the
    partial's rounding and the fold's rounding, taken at the plain
    version's magnitudes widened by the gap so far.
    """
    d = len(a_shards)
    m_loc, kd = a_shards[0].shape[0] // d, a_shards[0].shape[1]
    dtype = a_shards[0].dtype
    bounds = []
    for r in range(d):  # rank r's output is chunk r, folded by r+1, ..., r
        gap, acc = None, None
        for t in range(d):
            j = (r + 1 + t) % d
            rows = a_shards[j][r * m_loc:(r + 1) * m_loc].float()
            b = b_shards[j].float()
            gemm_gap = 2.0 * kd * 2.0**-23 * (rows.abs() @ b.abs())
            partial = (rows @ b).to(dtype).float()
            hop = gemm_gap + _spacing(partial.abs() + gemm_gap, dtype)
            if acc is None:
                gap, acc = hop, partial
            else:
                acc = (partial + acc).to(dtype).float()
                gap = gap + hop
                gap = gap + _spacing(acc.abs() + gap, dtype)
        bounds.append(gap)
    return bounds
