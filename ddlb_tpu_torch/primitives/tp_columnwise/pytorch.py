"""Explicit-collective AG+GEMM: ``torch.distributed`` all-gather plus
``torch.matmul``.

The upstream project's own ``pytorch`` member, and the counterpart of the
JAX package's ``jax_spmd``:
- ``order='AG_before'``: all-gather A, then the full GEMM on every rank;
- ``order='AG_after'``: the local ``[m/d, n]`` GEMM, then all-gather the
  outputs.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.tp_columnwise.base import TPColumnwise


class PyTorchTPColumnwise(TPColumnwise):
    DEFAULT_OPTIONS = {"order": "AG_before"}
    ALLOWED_VALUES = {"order": ["AG_before", "AG_after"]}

    #: the GEMM the step calls; the hand-kernel member swaps in K1
    gemm = staticmethod(torch_matmul)

    def _input_setup(self) -> None:
        super()._input_setup()
        gather, gemm = self.runtime.all_gather_rows, self.gemm
        if self.options["order"] == "AG_before":

            def step(a_shard, b):
                return gemm(gather(a_shard), b)

        else:

            def step(a_shard, b):
                return gather(gemm(a_shard, b))

        self._fn = step
