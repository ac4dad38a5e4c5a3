"""TPColumnwise: all-gather + GEMM tensor-parallel primitive.

The rank at ring position r of d holds the row block ``A[r*m/d:(r+1)*m/d, :]`` (``[m/d, k]``) and
all of ``B`` (``[k, n]``); every rank ends with the full ``[m, n]``
product. Requires ``m % d == 0``. The counterpart of the JAX package's
``tp_columnwise/base.py``, where the same split is a ``PartitionSpec``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.base import Primitive


class TPColumnwise(Primitive):
    """ABC for AG+GEMM implementations."""

    primitive_name = "tp_columnwise"

    #: the ici/dcn transport axis (the JAX base's): the ring's layout,
    #: ``Runtime.order_ring``
    BASE_OPTIONS = {"transport": "ici"}
    BASE_ALLOWED = {"transport": ["ici", "dcn"]}

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.m % d != 0:
            raise ValueError(f"m={self.m} must be divisible by partitions={d}")

    def _input_setup(self) -> None:
        a_host, b_host = self._host_operands()
        rows = self.m // self.num_partitions
        self.a = self._place(a_host[self.rank * rows:(self.rank + 1) * rows])
        self.b = self._place(b_host)

    def validate(self, result: torch.Tensor) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare(result, self._expected_full())
