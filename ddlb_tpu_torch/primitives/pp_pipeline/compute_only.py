"""Compute-only rooflines of the pipeline chain (no communication).

The counterpart of the JAX package's ``pp_pipeline/compute_only.py``:

- ``sharded``: one stage's GEMM ``[m, k] @ [k, n]`` on one device, the
  chain's share of one rank (validation skipped: it is not the chain);
- ``unsharded``: the whole S-stage chain on one device, validated against
  the chain oracle.

Each product is ``torch.matmul`` in the row's dtype (float32 sums), as
the JAX member's ``jnp.matmul`` with a float32 accumulator rounded back.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.pp_pipeline.base import PPPipeline


def chain(a: torch.Tensor, w: torch.Tensor, stages=None) -> torch.Tensor:
    """``a @ w[s0] @ w[s1] @ ...`` over the stack indices ``stages`` (all
    of them in order by default), each product in ``a``'s dtype."""
    y = a
    for j in range(w.shape[0]) if stages is None else stages:
        y = torch_matmul(y, w[j])
    return y


class ComputeOnlyPPPipeline(PPPipeline):
    #: no collective runs: the cost model drops the comm term
    COST_SCHEDULE = "compute_only"

    def wire_bytes(self) -> float:
        """No collective runs: nothing on the wire."""
        return 0.0

    DEFAULT_OPTIONS = {"size": "sharded"}
    ALLOWED_VALUES = {"size": ["sharded", "unsharded"]}

    def _input_setup(self) -> None:
        a_host, w_host = self._host_chain_operands()
        self.a = self._place(a_host)
        self.w = self._place(w_host[:1] if self.options["size"] == "sharded" else w_host)
        self._fn = chain

    def validate(self, result: torch.Tensor) -> bool:
        if self.options["size"] == "sharded":
            return True  # one stage's product, not the chain
        return super().validate(result)
