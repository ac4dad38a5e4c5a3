"""Compiler-partitioned GEMM+RS: DTensor picks the collective, Inductor
schedules it.

The counterpart of the JAX package's ``tp_rowwise/xla_gspmd.py``: ``A``
column-sharded and ``B`` row-sharded over 'tp', so the local product is a
partial sum (``Partial``); asking for rows sharded over 'tp' makes the
sum a reduce-scatter. ``collective_matmul=force`` lets Inductor's async
tensor parallelism fuse the GEMM with it (``compile_options``).
"""

from __future__ import annotations

from torch.distributed.tensor import Shard

from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin
from ddlb_tpu_torch.primitives.tp_rowwise.base import TPRowwise


class CompiledTPRowwise(CompiledOptionsMixin, TPRowwise):
    def _input_setup(self) -> None:
        super()._input_setup()
        self._compile_gemm({"tp": 1}, {"tp": 0}, Shard(0))
