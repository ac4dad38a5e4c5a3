"""K1: the tiled GEMM, written by hand in CUDA C++ for Hopper.

Replaces ``ddlb_tpu/ops/matmul.py::matmul`` (``_matmul_kernel``), the
Pallas MXU kernel that the hand-kernel members of both tensor-parallel
families call. ``matmul(a, b)`` computes ``a[m, k] @ b[k, n] -> [m, n]`` in
the operand dtype with the sum kept in float32, for bfloat16, float16 and
float32; other dtypes raise ``ValueError``.

The kernel (``csrc/matmul.cu``) and its design note: at the main path's
8192^3 bf16 the bf16 tensor cores bound it (2*m*n*k / 989 TFLOP/s = 1.11
ms), not the 3 x 128 MiB of operands. bf16/fp16 run 128x128x32 block tiles
staged through shared memory by ``cp.async`` into ``wmma`` 16x16x16
fragments with f32 accumulators; float32 runs a tiled SIMT kernel in true
f32 (no TF32). It is built by ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ``ctypes`` on PyTorch's current stream.

Dispatch: a CPU tensor takes ``matmul_plain``, the plain PyTorch version of
the same function (used by the CPU tests and, on the card, by
``chip_smoke.py`` as the kernel's yardstick of correctness). A CUDA tensor
launches the kernel or raises; there is no fallback. ``LAUNCHES`` counts
kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ddlb_tpu_torch.ops import _build

#: kernel launches since the count was last reset (plain calls excluded)
LAUNCHES = 0

#: operand dtype -> the C entry point's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT_MAX = 2**31 - 1
#: rows a launch covers: 128-row block tiles on a grid y extent of 65535
_MAX_ROWS = 128 * 65535


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the product in float32, rounded once to the
    operand dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def plain_gap_bound(
    a: torch.Tensor, b: torch.Tensor, got: torch.Tensor, want: torch.Tensor
) -> torch.Tensor:
    """Elementwise bound on ``|matmul(a, b) - matmul_plain(a, b)|``.

    Both sides sum the same k products in float32, in different orders;
    for bf16/fp16 operands each product is exact in float32. Two such sums
    differ by at most ``2 * k * 2**-23 * (|a| @ |b|)`` (recursive
    summation, one float32 spacing per addition, since tensor-core
    accumulation may truncate rather than round). Each side then rounds
    once to the output dtype, which adds at most one spacing of that dtype
    at the larger of ``|got|`` and ``|want|``.
    """
    finfo = torch.finfo(got.dtype)
    scale = torch.maximum(got.float().abs(), want.float().abs())
    spacing = torch.exp2(torch.floor(torch.log2(scale.clamp_min(finfo.tiny))))
    magnitude = a.abs().float() @ b.abs().float()
    return spacing * finfo.eps + 2.0 * a.shape[1] * 2.0**-23 * magnitude


def check_dtype(dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless K1 computes in ``dtype``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"K1 matmul takes {[str(d) for d in _DTYPE_CODES]}, got {dtype}"
        )


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {a.shape} @ {b.shape}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    check_dtype(a.dtype)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load("matmul")
    lib.ddlb_matmul.argtypes = [
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.ddlb_matmul.restype = ctypes.c_int
    lib.ddlb_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_error_string.restype = ctypes.c_char_p
    return lib


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[m, k] @ b[k, n]`` with float32 accumulation (kernel K1)."""
    global LAUNCHES
    _check(a, b)
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes row-major contiguous operands")
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) > _INT_MAX or m > _MAX_ROWS:
        raise ValueError(f"matmul shape out of the kernel's range: {m}, {n}, {k}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.ddlb_matmul(
            _DTYPE_CODES[a.dtype],
            a.data_ptr(),
            b.data_ptr(),
            out.data_ptr(),
            m,
            n,
            k,
            stream,
        )
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(
            f"K1 matmul launch failed: {lib.ddlb_error_string(rc).decode()} "
            f"(cudaError {rc})"
        )
    return out
