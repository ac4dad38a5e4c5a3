"""TPRowwise: GEMM + reduce-scatter (sequence-parallel) primitive.

The rank at ring position r of d holds the column block ``A[:, r*k/d:(r+1)*k/d]`` (``[m, k/d]``)
and the row block ``B[r*k/d:(r+1)*k/d, :]`` (``[k/d, n]``). Each rank
computes a partial ``[m, n]`` product; a reduce-scatter sums the partials
and leaves rank r with row block r of the sum (``[m/d, n]``). Requires
``k % d == 0`` and ``m % d == 0``. The counterpart of the JAX package's
``tp_rowwise/base.py``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.base import Primitive


class TPRowwise(Primitive):
    """ABC for GEMM+RS implementations."""

    primitive_name = "tp_rowwise"

    #: the ici/dcn transport axis (the JAX base's): the ring's layout,
    #: ``Runtime.order_ring``
    BASE_OPTIONS = {"transport": "ici"}
    BASE_ALLOWED = {"transport": ["ici", "dcn"]}

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.k % d != 0:
            raise ValueError(f"k={self.k} must be divisible by partitions={d}")
        if self.m % d != 0:
            raise ValueError(f"m={self.m} must be divisible by partitions={d}")

    def _input_setup(self) -> None:
        a_host, b_host = self._host_operands()
        kd = self.k // self.num_partitions
        cols = slice(self.rank * kd, (self.rank + 1) * kd)
        self.a = self._place(a_host[:, cols])
        self.b = self._place(b_host[cols])

    def validate(self, result: torch.Tensor) -> bool:
        """Each rank checks its own ``[m/d, n]`` row slice."""
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare_rows(result, self._expected_full())
