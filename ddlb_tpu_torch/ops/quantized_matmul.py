"""int8 quantization and the int8 GEMM; K7 written by hand in CUDA C++.

The port of the JAX package's ``ops/quantized_matmul.py``:

- ``quantize_rowwise`` / ``quantize_colwise`` / ``quantize_weight_stack``
  (:35-69): symmetric int8 along one axis, ``x ~ q * s`` with ``q`` in
  [-127, 127] and a float32 scale per row, column or trailing matrix
  column, with the all-zero guard ``s >= 1e-30``. Plain torch ops, the
  same float32 arithmetic as the JAX package's compiled functions (its
  members and its model call them under ``jit``): XLA turns ``max|x| /
  127`` into a product with the float32 constant 1/127, and so does the
  port; ``round`` is half-to-even in both. Called eagerly, JAX divides,
  and a scale can differ from the compiled one in its last bit: its
  ``init_params`` quantizes the ``int8_weights`` experts that way, and
  ``quantize_weight_stack(w, eager=True)`` does the same. The weight
  roles (``quantize_colwise``, ``quantize_weight_stack``) return their
  int8 values column-major (``column_major``: each ``[k, n]`` matrix with
  k contiguous), the layout K7's Hopper tiles and the library's int8 GEMM
  read: the same values, quantized from a transposed float32 copy, so no
  transpose of the int8 result is ever made or timed.
- ``quantization_atol`` (:72-86): the validation tolerance of the
  quantized members.
- ``int8_matmul`` (:89-98): the counterpart of XLA's int8 dot, a library
  call (``torch._int_mm``, int32 out) followed by the epilogue
  ``acc.float() * sa * sb`` and the cast. The members' ``kernel=xla``
  rows use it; on the card ``torch._int_mm`` is cuBLASLt's int8 path,
  which takes its own operand layouts and shapes and raises on others.
- ``int8_matmul_kernel``: K7, the counterpart of ``int8_matmul_pallas``
  (:175, ``_int8_kernel`` :154). The same function, ``aq [m, k]`` int8
  times ``bq [k, n]`` int8 summed exactly in int32, then ``(float)acc *
  sa[m, 1] * sb[1, n]`` in float32, cast once (round to nearest) to
  bfloat16 or float16, or stored as float32. ``bq`` may be row-major or
  column-major; the wrapper reads its strides. The kernels
  (``csrc/quantized_matmul.cu``) and their design note: at 8192^3 the
  int8 tensor cores bound it (2mnk / 1979 TOP/s = 0.556 ms); at the
  decode MLP's 8 rows the bytes of ``bq`` do (5 us at 3.35 TB/s).
  ``tile_for`` picks one of three tiles, each counted in ``TILES``:

  - ``wgmma``: a column-major ``bq`` at TMA's widths (``k`` a multiple of
    16, 16-byte aligned bases), ``m > SMALL_M``. The Hopper GEMM tile of
    ``csrc/hopper_gemm.cuh`` in int8: a persistent block an SM over 128 x
    256 output tiles, a TMA producer warp, two consumer warpgroups on
    ``wgmma.m64n256k32.s32.s8.s8`` (s8 ``wgmma`` reads both operands
    K-major, hence the column-major weight).
  - ``small_m``: the same operands at ``m <= SMALL_M`` (decode). The
    operands swap (``C^T = B^T A^T``): 64 weight rows a block are
    ``wgmma``'s 64-row operand, the few activation rows its N = 8..64;
    ``k`` is split so that about four blocks an SM stream the weight, the
    splits' int32 sums added exactly in a zeroed workspace (one a device
    and stream, left zero by every launch) and dequantized once by the
    last block of a tile.
  - ``mma``: any other widths and either layout (``k % 16 != 0``, an
    unaligned base, a row-major ``bq``): 128x128 block tiles of
    ``mma.sync`` m16n8k32 s8 fragments staged by ``cp.async``.

  Any ``m, n >= 1`` and ``k >= 0``; ``k`` is capped where 127^2 * k could
  leave int32. It is built by ``nvcc`` for ``sm_90a`` at first use
  (``_build.py``) and called through ``ctypes`` on PyTorch's current
  stream.
- ``int8_ste_matmul`` (:101-151): the training path's product, K7
  forward and the straight-through float32 backward.
- ``int8_matmul_plain``: K7's plain version, the int8 values multiplied
  in float64 (exact: every partial sum is an integer below 2**53), then
  the same epilogue. It runs on both devices.

The epilogue has no addition, so nothing in it contracts to an FMA: K7,
its plain version, ``int8_matmul`` and both JAX functions round the same
values the same way and agree bit for bit.

Dispatch: ``int8_matmul_kernel`` on a CPU tensor takes
``int8_matmul_plain``; on a CUDA tensor it launches the kernel
``tile_for`` names or raises, with no fallback from one tile to another.
``LAUNCHES`` counts kernel launches and ``TILES`` counts them by tile.

``int8_matmul_kernel`` and ``int8_ste_matmul`` are the ``torch.library``
operators ``ddlb::int8_matmul`` and ``ddlb::int8_ste_matmul`` (the
straight-through backward registered on the second), each with a fake
implementation that gives the output's shape and dtype and a DTensor
sharding rule: so ``torch.compile(fullgraph=True)`` traces the int8 MLP
and a program on DTensors (the ``compiled`` members) runs it. The
operator's body is the dispatch above, so a compiled graph counts its
launches as eager code does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ddlb_tpu_torch.ops import _build

#: kernel launches since the count was last reset (plain calls excluded)
LAUNCHES = 0
#: the launches by tile since the counts were last reset
TILES = {"wgmma": 0, "small_m": 0, "mma": 0}

#: int8 symmetric range: values quantize to [-127, 127] (-128 unused, so
#: the grid is symmetric and |q * s| <= max|x|)
_QMAX = 127.0
#: 1/127 rounded to float32 (0.00787401572): XLA's form of ``/ 127``
_INV_QMAX = float(torch.tensor(1.0 / _QMAX, dtype=torch.float32))
#: all-zero slice guard on the scale
_MIN_SCALE = 1e-30

#: output dtype -> the C entry point's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_TILE_CODES = {"mma": 0, "wgmma": 1, "small_m": 2}
#: the most rows the small_m tile takes (its widest N)
SMALL_M = 64
#: the longest contraction whose int32 sum cannot overflow: 127^2 * k < 2^31
MAX_K = (2**31 - 1) // (127 * 127)
#: rows an mma launch covers: 128-row block tiles on a grid y extent of
#: 65535 (the wgmma kernel's grid is one-dimensional, small_m's rows few)
_MAX_ROWS = 128 * 65535


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``TILES``."""
    global LAUNCHES
    LAUNCHES = 0
    for key in TILES:
        TILES[key] = 0


def layout_of(bq: torch.Tensor) -> str:
    """``col`` for a column-major ``[k, n]`` weight (k contiguous: the
    layout K7's Hopper tiles read), ``row`` for a row-major one; raises on
    any other strides. A matrix both layouts describe (one row or one
    column) counts as ``col``."""
    if bq.t().is_contiguous():
        return "col"
    if bq.is_contiguous():
        return "row"
    raise ValueError(
        f"int8_matmul takes a contiguous row-major or column-major weight, got "
        f"strides {bq.stride()}"
    )


def tile_for(m: int, n: int, k: int, layout: str, *bases: int) -> str:
    """K7's tile for ``[m, k] @ [k, n]`` with a ``layout`` (``row`` or
    ``col``) weight: ``small_m`` (m <= ``SMALL_M``) or ``wgmma`` when the
    weight is column-major, ``k`` a positive multiple of 16 and every base
    address in ``bases`` 16-byte aligned (TMA's rules); ``mma`` otherwise."""
    if layout not in ("row", "col"):
        raise ValueError(f"layout must be 'row' or 'col', got {layout!r}")
    tma = layout == "col" and k > 0 and k % 16 == 0 and all(b % 16 == 0 for b in bases)
    if not tma:
        return "mma"
    return "small_m" if m <= SMALL_M else "wgmma"


def column_major(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each trailing ``[k, n]`` matrix column-major (k
    contiguous), the matrices packed one after another: the same values,
    copied only when ``x`` is laid out otherwise."""
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quantize(x: torch.Tensor, dim: int, eager: bool = False):
    """Symmetric quantization along ``dim``: ``x ~ q * s``, q int8; the
    scale ``max|x| * (1/127)``, or ``max|x| / 127`` when ``eager``."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    s = amax / _QMAX if eager else amax * _INV_QMAX
    s = torch.clamp_min(s, _MIN_SCALE)
    q = torch.clamp(torch.round(xf / s), -_QMAX, _QMAX).to(torch.int8)
    return q, s


def quantize_rowwise(x: torch.Tensor):
    """Per-row quantization of the left operand: ``(q [m, k] int8, s [m,
    1] float32)``."""
    return _quantize(x, 1)


def _quantize_columns(x: torch.Tensor, eager: bool = False):
    """Per-column quantization of every trailing ``[k, n]`` matrix of ``x``,
    computed on a transposed float32 copy (the one pass that turns ``x``
    into float32), so that ``q`` comes out column-major."""
    xt = torch.empty(
        (*x.shape[:-2], x.shape[-1], x.shape[-2]), dtype=torch.float32, device=x.device
    )
    xt.copy_(x.transpose(-1, -2))
    q, s = _quantize(xt, -1, eager)
    return q.transpose(-1, -2), s.transpose(-1, -2)


def quantize_colwise(x: torch.Tensor):
    """Per-column quantization of the right operand: ``(q [k, n] int8
    column-major, s [1, n] float32)``."""
    return _quantize_columns(x)


def quantize_weight_stack(w: torch.Tensor, *, eager: bool = False):
    """Per-output-feature quantization of stacked weights ``[..., k, n]``:
    ``(q [..., k, n] int8, s [..., 1, n] float32)``, each trailing matrix
    as ``quantize_colwise`` would (column-major); ``eager`` as the JAX
    function called outside ``jit``."""
    return _quantize_columns(w, eager)


def quantization_atol(k: int) -> float:
    """Validation tolerance of an int8-quantized GEMM over the contract's
    seeded uniform [-1, 1] operands: ``sqrt(k) / 32`` (the JAX package's
    error model: about 2.4x the measured maximum at 8192^3)."""
    return math.sqrt(k) / 32.0


def _epilogue(acc: torch.Tensor, sa, sb, out_dtype) -> torch.Tensor:
    """``acc.float() * sa * sb`` in that order, cast once."""
    return (acc.float() * sa * sb).to(out_dtype)


def int8_matmul(aq, bq, sa, sb, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(aq * sa) @ (bq * sb)`` through the library's int8 GEMM
    (``torch._int_mm``) and the dequantizing epilogue."""
    return _epilogue(torch._int_mm(aq, bq), sa, sb, out_dtype)


def int8_matmul_plain(aq, bq, sa, sb, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7's plain version: the int8 product in float64 (exact), then the
    same epilogue."""
    return _epilogue(aq.double() @ bq.double(), sa, sb, out_dtype)


def _check(aq, bq, sa, sb, out_dtype) -> None:
    if aq.dim() != 2 or bq.dim() != 2:
        raise ValueError(f"int8_matmul takes 2-D operands, got {aq.shape} @ {bq.shape}")
    (m, k), n = aq.shape, bq.shape[1]
    if bq.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(aq.shape)} @ {tuple(bq.shape)}")
    if aq.dtype != torch.int8 or bq.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got {aq.dtype}, {bq.dtype}")
    if sa.dtype != torch.float32 or sb.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {sa.dtype}, {sb.dtype}")
    if tuple(sa.shape) != (m, 1) or tuple(sb.shape) != (1, n):
        raise ValueError(
            f"scales must be [{m}, 1] and [1, {n}], got {tuple(sa.shape)}, "
            f"{tuple(sb.shape)}"
        )
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(
            f"K7 int8_matmul writes {[str(d) for d in _DTYPE_CODES]}, got {out_dtype}"
        )
    if len({aq.device, bq.device, sa.device, sb.device}) != 1:
        raise ValueError(
            f"operands on {aq.device}, {bq.device}, {sa.device}, {sb.device}"
        )


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load("quantized_matmul")
    lib.ddlb_int8_matmul.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.ddlb_int8_matmul.restype = ctypes.c_int
    lib.ddlb_int8_work_ints.argtypes = [ctypes.c_int]
    lib.ddlb_int8_work_ints.restype = ctypes.c_longlong
    lib.ddlb_int8_small_m_max.restype = ctypes.c_int
    lib.ddlb_int8_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_int8_error_string.restype = ctypes.c_char_p
    if lib.ddlb_int8_small_m_max() != SMALL_M:
        raise RuntimeError("csrc/quantized_matmul.cu's small-m cut is not SMALL_M")
    return lib


#: small_m's split-k workspaces, one a (device, stream): int32 zeros that
#: every launch leaves zero
_WORKSPACES = {}


def _workspace(lib, device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed int32 workspace of small_m launches at width ``n`` on
    ``stream``, grown when a wider launch needs more."""
    need = lib.ddlb_int8_work_ints(n)
    key = (device.index, stream)
    work = _WORKSPACES.get(key)
    if work is None or work.numel() < need:
        work = torch.zeros(need, dtype=torch.int32, device=device)
        _WORKSPACES[key] = work
    return work


def _launch(aq, bq, sa, sb, out_dtype) -> torch.Tensor:
    """K7 itself: the plain version on a CPU tensor, the kernel
    ``tile_for`` names on a CUDA tensor (or a raise)."""
    global LAUNCHES
    _check(aq, bq, sa, sb, out_dtype)
    if aq.device.type == "cpu":
        return int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)
    if aq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got {aq.device}")
    if not all(t.is_contiguous() for t in (aq, sa, sb)):
        raise ValueError("int8_matmul takes a row-major contiguous aq and contiguous scales")
    layout = layout_of(bq)
    (m, k), n = aq.shape, bq.shape[1]
    if k > MAX_K:
        raise ValueError(f"k={k} > {MAX_K}: the int32 sum could overflow")
    tile = tile_for(m, n, k, layout, aq.data_ptr(), bq.data_ptr())
    if n > 2**31 - 1 or (tile == "mma" and m > _MAX_ROWS):
        raise ValueError(f"int8_matmul shape out of the {tile} kernel's range: {m}, {n}, {k}")
    out = torch.empty((m, n), dtype=out_dtype, device=aq.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(aq.device):
        stream = torch.cuda.current_stream(aq.device).cuda_stream
        work = _workspace(lib, aq.device, stream, n).data_ptr() if tile == "small_m" else None
        rc = lib.ddlb_int8_matmul(
            _DTYPE_CODES[out_dtype],
            _TILE_CODES[tile],
            int(layout == "col"),
            aq.data_ptr(),
            bq.data_ptr(),
            sa.data_ptr(),
            sb.data_ptr(),
            out.data_ptr(),
            m,
            n,
            k,
            work,
            stream,
        )
    LAUNCHES += 1
    TILES[tile] += 1
    if rc != 0:
        raise RuntimeError(
            f"K7 int8_matmul ({tile}) launch failed: "
            f"{lib.ddlb_int8_error_string(rc).decode()} (cudaError {rc})"
        )
    return out


# Both products are operators of the ``ddlb`` library (``torch.library``), so
# that Dynamo traces them as one opaque node each (a ``ctypes`` call cannot
# be traced) and DTensor dispatches them by the sharding rules below. The
# ``needs_exact_strides`` tag has Inductor hand them their inputs with the
# strides eager code gives them: the column-major weight column-major, the
# activation row-major and unpadded.
_EXACT = (torch.Tag.needs_exact_strides,)


@torch.library.custom_op("ddlb::int8_matmul", mutates_args=(), tags=_EXACT)
def _int8_matmul_op(aq: torch.Tensor, bq: torch.Tensor, sa: torch.Tensor,
                    sb: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return _launch(aq, bq, sa, sb, out_dtype)


@_int8_matmul_op.register_fake
def _(aq, bq, sa, sb, out_dtype):
    _check(aq, bq, sa, sb, out_dtype)
    return aq.new_empty((aq.shape[0], bq.shape[1]), dtype=out_dtype)


def int8_matmul_kernel(aq, bq, sa, sb, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``aq [m, k] @ bq [k, n]`` int8 with the scale epilogue (kernel K7);
    ``bq`` row-major or column-major. The operator ``ddlb::int8_matmul``."""
    return torch.ops.ddlb.int8_matmul(aq, bq, sa, sb, out_dtype)


@torch.library.custom_op("ddlb::int8_ste_matmul", mutates_args=(), tags=_EXACT)
def _int8_ste_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    (qx, sx), (qw, sw) = quantize_rowwise(x), quantize_colwise(w)
    return _launch(qx, qw, sx, sw, torch.float32)


@_int8_ste_op.register_fake
def _(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_ste_matmul takes [m, k] @ [k, n], got {x.shape} @ {w.shape}")
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32)


def _ste_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ste_backward(ctx, g):
    # the float32 cotangent contracts against the original operands at
    # full width; only the results are rounded to the operand dtypes
    x, w = ctx.saved_tensors
    gf = g.float()
    return (gf @ w.float().t()).to(x.dtype), (x.float().t() @ gf).to(w.dtype)


_int8_ste_op.register_autograd(_ste_backward, setup_context=_ste_context)


def int8_ste_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [m, k] @ w [k, n]`` on the int8 path, differentiable by the
    straight-through estimator (``int8_ste_matmul``, :101-151), as the
    operator ``ddlb::int8_ste_matmul``. Forward: ``x`` quantized per row,
    ``w`` per column, the int8 GEMM (K7 on the card) with its epilogue,
    float32 out. Backward: the gradients flow as if the quantizer were the
    identity, the float32 cotangent contracted against the original
    operands and only the results cast to their dtypes."""
    return torch.ops.ddlb.int8_ste_matmul(x, w)


# DTensor's sharding rules of the two operators, per mesh dimension: every
# operand replicated, or the rows of the activation (and of its per-row
# scale) sharded with the weight replicated. Per-row quantization and the
# per-row epilogue are local to a row, so a row block computes alone; a
# sharded weight is gathered first.


@register_sharding(torch.ops.ddlb.int8_matmul.default)
def _(aq, bq, sa, sb, out_dtype):
    return [([Replicate()], [Replicate(), Replicate(), Replicate(), Replicate(), None]),
            ([Shard(0)], [Shard(0), Replicate(), Shard(0), Replicate(), None])]


@register_sharding(torch.ops.ddlb.int8_ste_matmul.default)
def _(x, w):
    return [([Replicate()], [Replicate(), Replicate()]),
            ([Shard(0)], [Shard(0), Replicate()])]
