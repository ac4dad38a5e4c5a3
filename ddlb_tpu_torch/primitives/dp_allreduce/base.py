"""DPAllReduce: the data-parallel gradient GEMM + all-reduce primitive.

The counterpart of the JAX package's ``dp_allreduce/base.py``: the weight
gradient ``dW = X^T dY`` contracted over the sharded batch, mapped onto
the ``(m, n, k)`` contract with ``tp_rowwise``'s operand layout. Rank r of
d (its ring position) holds the column block ``A[:, r*k/d:(r+1)*k/d]`` (``[m, k/d]``) and the
row block ``B[r*k/d:(r+1)*k/d, :]`` (``[k/d, n]``); each computes its
partial ``[m, n]`` product and an all-reduce sums the partials, leaving
the full gradient replicated on every rank. Requires ``k % d == 0``.
Validation holds each rank's whole ``[m, n]`` to the single-device
product under the reference rule (k is the full contraction length).
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import Primitive


class DPAllReduce(Primitive):
    """ABC for data-parallel GEMM+AR implementations."""

    primitive_name = "dp_allreduce"

    #: the ici/dcn transport axis (the JAX base's): the ring's layout,
    #: ``Runtime.order_ring``
    BASE_OPTIONS = {"transport": "ici"}
    BASE_ALLOWED = {"transport": ["ici", "dcn"]}

    def wire_bytes(self) -> float:
        """Per-rank ring bytes of the family's collective, the all-reduce
        of the ``[m, n]`` gradient: ``2 * (m*n/d) * (d-1)`` elements at the
        JAX package's wire item size (``compute_only`` overrides it to 0)."""
        d = self.num_partitions
        if d <= 1:
            return 0.0
        return float(2.0 * (self.m * self.n // d) * wire_itemsize(self.dtype) * (d - 1))

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
