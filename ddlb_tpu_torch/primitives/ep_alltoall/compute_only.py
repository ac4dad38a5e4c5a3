"""Compute-only rooflines for the expert-parallel primitive.

- ``sharded``: one rank's expert GEMM ``[m/d, k] @ [k, n]`` (the first
  m/d tokens through expert 0, validation skipped: a lone expert's output
  is not the routed answer);
- ``unsharded``: the full routed product on one device, validated.

The counterpart of the JAX package's ``ep_alltoall/compute_only.py``;
the size schema and the validation come from ``ComputeOnlyKSharded``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.base import ComputeOnlyKSharded, torch_matmul
from ddlb_tpu_torch.primitives.ep_alltoall.base import EPAllToAll


class ComputeOnlyEPAllToAll(ComputeOnlyKSharded, EPAllToAll):
    def _input_setup(self) -> None:
        a_host, w_host = self._host_tokens_experts()
        d, g = self.num_partitions, self.group_tokens
        if self.options["size"] == "sharded":
            self.a = self._place(a_host[: self.m // d])
            self.w = self._place(w_host[0])
            self._fn = torch_matmul
            return
        self.a = self._place(a_host.reshape(d, d, g, self.k))
        self.w = self._place(w_host)
        # the JAX member upcasts the operands and sums in the wide dtype
        acc = torch.float64 if self.dtype in ("float64", "int32", "int64") else torch.float32
        m, n = self.m, self.n

        def routed(a4, w):
            out = torch.einsum("pegk,ekn->pegn", a4.to(acc), w.to(acc))
            return out.to(a4.dtype).reshape(m, n)

        self._fn = routed
