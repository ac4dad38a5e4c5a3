"""Compiler-partitioned AG+GEMM: DTensor picks the collective, Inductor
schedules it.

The counterpart of the JAX package's ``tp_columnwise/xla_gspmd.py``: the
global product ``A @ B`` with ``A`` row-sharded over 'tp' and ``B``
replicated, asked for replicated. DTensor's sharding propagation runs the
GEMM on each rank's rows (``Shard(0) @ Replicate -> Shard(0)``) and
all-gathers the product: one all-gather, of C, not of A. The options are
the compiler knobs of ``compile_options``.
"""

from __future__ import annotations

from torch.distributed.tensor import Replicate

from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin
from ddlb_tpu_torch.primitives.tp_columnwise.base import TPColumnwise


class CompiledTPColumnwise(CompiledOptionsMixin, TPColumnwise):
    def _input_setup(self) -> None:
        super()._input_setup()
        self._compile_gemm({"tp": 0}, {}, Replicate())
