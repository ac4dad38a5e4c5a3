"""Explicit-collective GEMM+RS: the partial GEMM (``torch.matmul``), then a
``torch.distributed`` reduce-scatter over output rows.

The upstream project's ``pytorch`` member and the counterpart of the JAX
package's ``jax_spmd`` (``psum_scatter`` there). The output rows end up
sharded along M: the sequence-parallel layout.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.tp_rowwise.base import TPRowwise


class PyTorchTPRowwise(TPRowwise):
    DEFAULT_OPTIONS = {}
    ALLOWED_VALUES = {}

    #: the GEMM the step calls; the hand-kernel member swaps in K1
    gemm = staticmethod(torch_matmul)

    def _input_setup(self) -> None:
        super()._input_setup()
        scatter, gemm = self.runtime.reduce_scatter_rows, self.gemm

        def step(a_shard, b_shard):
            return scatter(gemm(a_shard, b_shard))  # [m, n] -> [m/d, n]

        self._fn = step
