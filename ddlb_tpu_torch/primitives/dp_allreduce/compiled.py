"""Compiler-partitioned GEMM+AR: DTensor picks the collective, Inductor
schedules it.

The counterpart of the JAX package's ``dp_allreduce/xla_gspmd.py``: the
``tp_rowwise`` operand layout (the contraction sharded over 'tp'), with
the product asked for replicated, so the partial sums meet in one
all-reduce.
"""

from __future__ import annotations

from torch.distributed.tensor import Replicate

from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin
from ddlb_tpu_torch.primitives.dp_allreduce.base import DPAllReduce


class CompiledDPAllReduce(CompiledOptionsMixin, DPAllReduce):
    def _input_setup(self) -> None:
        super()._input_setup()
        self._compile_gemm({"tp": 1}, {"tp": 0}, Replicate())
