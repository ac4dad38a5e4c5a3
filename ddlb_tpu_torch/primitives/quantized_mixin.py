"""Shared surface of the int8 ``quantized`` GEMM members.

The port of the JAX package's ``primitives/quantized_mixin.py``: one
option schema, dtype gate and GEMM selector for the ``quantized`` member
of every GEMM family (``tp_columnwise``, ``tp_rowwise``, ``dp_allreduce``,
``ep_alltoall``), so the schema cannot drift between them. The families
differ only in how scales travel with their collectives, which stays in
each member.

Options keep the JAX names: ``kernel=xla`` multiplies with the library's
int8 GEMM (``ops.quantized_matmul.int8_matmul``, ``torch._int_mm``),
``kernel=pallas`` with the hand-written K7 (``int8_matmul_kernel``);
``quantize=static`` quantizes the activation operand once at set-up,
``dynamic`` inside every measured step. The JAX package's ``block_m``,
``block_n``, ``block_k`` and ``tune`` size its Pallas kernel's TPU tiles;
K7's tiles are fixed in its source, so those options raise.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops import quantized_matmul as qm
from ddlb_tpu_torch.primitives.base import torch_dtype

#: operand dtypes the int8 path accepts: quantization replaces the float
#: values, so only the float dtypes are meaningful inputs
QUANTIZABLE_DTYPES = ("float32", "float16", "bfloat16")
#: the JAX member's TPU tile knobs, which have no counterpart here
_TPU_TILE_OPTIONS = ("block_m", "block_n", "block_k", "tune")


def reject_tpu_tiles(options, member: str, why: str) -> None:
    """Raise on the JAX members' TPU tile options, which the port's fixed
    kernel tiles leave without a counterpart."""
    tile = sorted(set(options) & set(_TPU_TILE_OPTIONS))
    if tile:
        raise ValueError(
            f"Option(s) {tile} of {member} size the JAX package's TPU tiles "
            f"and are not ported to ddlb_tpu_torch: {why}"
        )


class QuantizedGEMMMixin:
    #: the GEMMs run at the int8 rate: the cost model prices them there
    COST_DTYPE = "int8"

    DEFAULT_OPTIONS = {"kernel": "xla", "quantize": "static"}
    ALLOWED_VALUES = {
        "kernel": ["xla", "pallas"],
        "quantize": ["static", "dynamic"],
    }

    def __init__(self, *args, **options) -> None:
        reject_tpu_tiles(options, "the quantized member",
                         "K7's tiles are fixed in csrc/quantized_matmul.cu")
        super().__init__(*args, **options)

    def _check_quantized_options(self) -> None:
        if self.dtype not in QUANTIZABLE_DTYPES:
            raise ValueError(
                "quantized implementation supports floating operand dtypes "
                f"{QUANTIZABLE_DTYPES} only (got {self.dtype})"
            )

    def _int8_gemm(self):
        """The int8 GEMM of this member's ``kernel`` option, writing the
        operand dtype."""
        out_dtype = torch_dtype(self.dtype)
        fn = (
            qm.int8_matmul_kernel
            if self.options["kernel"] == "pallas"
            else qm.int8_matmul
        )

        def gemm(aq, bq, sa, sb):
            return fn(aq, bq, sa, sb, out_dtype=out_dtype)

        return gemm

    def _weight_layout(self, bq: torch.Tensor) -> torch.Tensor:
        """The quantized weight as this member's GEMM reads it, laid out
        once at set-up so that no transpose is timed: column-major (k
        contiguous) for both kernels, the layout of K7's Hopper tiles and
        of cuBLASLt's int8 GEMM, so the ``xla`` and ``pallas`` rows read
        the same bytes. ``quantize_colwise`` already returns it."""
        return qm.column_major(bq)
