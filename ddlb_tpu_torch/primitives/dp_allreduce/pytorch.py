"""Explicit-collective GEMM+AR: the partial gradient GEMM
(``torch.matmul``), then ``torch.distributed`` collectives.

The counterpart of the JAX package's ``dp_allreduce/jax_spmd.py``.
``strategy`` picks the collective decomposition:
- ``all_reduce``: one sum all-reduce (NCCL's on the card);
- ``rs_ag``: a reduce-scatter of the rows, then an all-gather of them,
  the two-phase form, kept separate so a sweep can race it against the
  fused collective. Requires ``m % d == 0``.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.dp_allreduce.base import DPAllReduce


class PyTorchDPAllReduce(DPAllReduce):
    DEFAULT_OPTIONS = {"strategy": "all_reduce"}
    ALLOWED_VALUES = {"strategy": ["all_reduce", "rs_ag"]}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        if (
            self.options["strategy"] == "rs_ag"
            and self.m % self.num_partitions != 0
        ):
            raise ValueError(
                f"m={self.m} must be divisible by partitions="
                f"{self.num_partitions} for strategy=rs_ag"
            )

    def _input_setup(self) -> None:
        super()._input_setup()
        rt = self.runtime
        if self.options["strategy"] == "all_reduce":

            def step(a_shard, b_shard):
                return rt.all_reduce(torch_matmul(a_shard, b_shard))

        else:

            def step(a_shard, b_shard):
                partial = torch_matmul(a_shard, b_shard)  # [m, n] partial
                return rt.all_gather_rows(rt.reduce_scatter_rows(partial))

        self._fn = step
