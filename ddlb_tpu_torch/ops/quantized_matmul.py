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
  ``quantize_weight_stack(w, eager=True)`` does the same.
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
  bfloat16 or float16, or stored as float32. The kernel
  (``csrc/quantized_matmul.cu``) and its design note: at 8192^3 the int8
  tensor cores bound it (2mnk / 1979 TOP/s = 0.556 ms); at the decode
  MLP's 8 rows the bytes of ``bq`` do (a few microseconds at 3.35 TB/s).
  128x128 block tiles walk k in steps of 64 bytes, staged by ``cp.async``
  two deep, into ``mma.sync`` m16n8k32 s8 fragments with int32
  accumulators; ``bq`` keeps its row-major layout and each thread turns a
  4x4 byte block of it into four k-major B fragments with ``__byte_perm``.
  Any ``m, n >= 1`` and ``k >= 0`` (ragged edges zero-filled); ``k`` is
  capped where 127^2 * k could leave int32. It is built by ``nvcc`` for
  ``sm_90a`` at first use (``_build.py``) and called through ``ctypes`` on
  PyTorch's current stream.
- ``int8_ste_matmul`` (:101-151): the training path's product, K7
  forward and the straight-through float32 backward, as an autograd
  Function.
- ``int8_matmul_plain``: K7's plain version, the int8 values multiplied
  in float64 (exact: every partial sum is an integer below 2**53), then
  the same epilogue. It runs on both devices.

The epilogue has no addition, so nothing in it contracts to an FMA: K7,
its plain version, ``int8_matmul`` and both JAX functions round the same
values the same way and agree bit for bit.

Dispatch: ``int8_matmul_kernel`` on a CPU tensor takes
``int8_matmul_plain``; on a CUDA tensor it launches the kernel or raises,
with no fallback. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ddlb_tpu_torch.ops import _build

#: kernel launches since the count was last reset (plain calls excluded)
LAUNCHES = 0

#: int8 symmetric range: values quantize to [-127, 127] (-128 unused, so
#: the grid is symmetric and |q * s| <= max|x|)
_QMAX = 127.0
#: 1/127 rounded to float32 (0.00787401572): XLA's form of ``/ 127``
_INV_QMAX = float(torch.tensor(1.0 / _QMAX, dtype=torch.float32))
#: all-zero slice guard on the scale
_MIN_SCALE = 1e-30

#: output dtype -> the C entry point's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the longest contraction whose int32 sum cannot overflow: 127^2 * k < 2^31
MAX_K = (2**31 - 1) // (127 * 127)
#: rows a launch covers: 128-row block tiles on a grid y extent of 65535
_MAX_ROWS = 128 * 65535


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


def quantize_colwise(x: torch.Tensor):
    """Per-column quantization of the right operand: ``(q [k, n] int8, s
    [1, n] float32)``."""
    return _quantize(x, 0)


def quantize_weight_stack(w: torch.Tensor, *, eager: bool = False):
    """Per-output-feature quantization of stacked weights ``[..., k, n]``:
    ``(q [..., k, n] int8, s [..., 1, n] float32)``, each trailing matrix
    as ``quantize_colwise`` would; ``eager`` as the JAX function called
    outside ``jit``."""
    return _quantize(w, -2, eager)


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
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.ddlb_int8_matmul.restype = ctypes.c_int
    lib.ddlb_int8_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_int8_error_string.restype = ctypes.c_char_p
    return lib


def int8_matmul_kernel(aq, bq, sa, sb, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``aq [m, k] @ bq [k, n]`` int8 with the scale epilogue (kernel K7)."""
    global LAUNCHES
    _check(aq, bq, sa, sb, out_dtype)
    if aq.device.type == "cpu":
        return int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)
    if aq.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got {aq.device}")
    if not all(t.is_contiguous() for t in (aq, bq, sa, sb)):
        raise ValueError("int8_matmul takes row-major contiguous operands and scales")
    (m, k), n = aq.shape, bq.shape[1]
    if k > MAX_K:
        raise ValueError(f"k={k} > {MAX_K}: the int32 sum could overflow")
    if m > _MAX_ROWS or n > 2**31 - 1:
        raise ValueError(f"int8_matmul shape out of the kernel's range: {m}, {n}, {k}")
    out = torch.empty((m, n), dtype=out_dtype, device=aq.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(aq.device):
        stream = torch.cuda.current_stream(aq.device).cuda_stream
        rc = lib.ddlb_int8_matmul(
            _DTYPE_CODES[out_dtype],
            aq.data_ptr(),
            bq.data_ptr(),
            sa.data_ptr(),
            sb.data_ptr(),
            out.data_ptr(),
            m,
            n,
            k,
            stream,
        )
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(
            f"K7 int8_matmul launch failed: "
            f"{lib.ddlb_int8_error_string(rc).decode()} (cudaError {rc})"
        )
    return out


class _Int8STEMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        (qx, sx), (qw, sw) = quantize_rowwise(x), quantize_colwise(w)
        return int8_matmul_kernel(qx, qw, sx, sw, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        # the float32 cotangent contracts against the original operands at
        # full width; only the results are rounded to the operand dtypes
        x, w = ctx.saved_tensors
        gf = g.float()
        return (gf @ w.float().t()).to(x.dtype), (x.float().t() @ gf).to(w.dtype)


def int8_ste_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [m, k] @ w [k, n]`` on the int8 path, differentiable by the
    straight-through estimator (``int8_ste_matmul``, :101-151). Forward:
    ``x`` quantized per row, ``w`` per column, the int8 GEMM (K7 on the
    card) with its epilogue, float32 out. Backward: the gradients flow as
    if the quantizer were the identity, the float32 cotangent contracted
    against the original operands and only the results cast to their
    dtypes."""
    return _Int8STEMatmul.apply(x, w)
