"""DPAllReduce: the data-parallel gradient GEMM + all-reduce primitive.

The counterpart of the JAX package's ``dp_allreduce/base.py``: the weight
gradient ``dW = X^T dY`` contracted over the sharded batch, mapped onto
the ``(m, n, k)`` contract with ``tp_rowwise``'s operand layout. Rank r of
d holds the column block ``A[:, r*k/d:(r+1)*k/d]`` (``[m, k/d]``) and the
row block ``B[r*k/d:(r+1)*k/d, :]`` (``[k/d, n]``); each computes its
partial ``[m, n]`` product and an all-reduce sums the partials, leaving
the full gradient replicated on every rank. Requires ``k % d == 0``.
Validation holds each rank's whole ``[m, n]`` to the single-device
product under the reference rule (k is the full contraction length).
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.base import Primitive


class DPAllReduce(Primitive):
    """ABC for data-parallel GEMM+AR implementations."""

    primitive_name = "dp_allreduce"

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.k % d != 0:
            raise ValueError(f"k={self.k} must be divisible by partitions={d}")

    def _input_setup(self) -> None:
        a_host, b_host = self._host_operands()
        kd = self.k // self.num_partitions
        cols = slice(self.rank * kd, (self.rank + 1) * kd)
        self.a = self._place(a_host[:, cols])
        self.b = self._place(b_host[cols])

    def validate(self, result: torch.Tensor) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare(result, self._expected_full())
