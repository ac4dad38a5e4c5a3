"""Compute-only roofline implementations (no communication).

``size='sharded'`` runs only one rank's ``[m/d, k] @ [k, n]`` GEMM (the
compute share of one partition; validation skipped, as in the JAX
package), ``size='unsharded'`` the full product on one device.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.tp_columnwise.base import TPColumnwise


class ComputeOnlyTPColumnwise(TPColumnwise):
    DEFAULT_OPTIONS = {"size": "sharded"}
    ALLOWED_VALUES = {"size": ["sharded", "unsharded"]}

    def wire_bytes(self) -> float:
        """No collective runs: nothing on the wire."""
        return 0.0

    def _input_setup(self) -> None:
        a_host, b_host = self._host_operands()
        if self.options["size"] == "sharded":
            # the local shard only, as rank 0 holds it
            a_host = a_host[: self.m // self.num_partitions]
        self.a = self._place(a_host)
        self.b = self._place(b_host)
        self._fn = torch_matmul

    def validate(self, result: torch.Tensor) -> bool:
        if self.options["size"] == "sharded":
            return True
        return super().validate(result)
