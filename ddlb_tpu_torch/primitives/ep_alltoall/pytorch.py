"""Explicit-collective MoE dispatch and combine: ``torch.distributed``
all-to-alls around the resident expert's GEMM (``torch.matmul``).

The counterpart of the JAX package's ``ep_alltoall/jax_spmd.py``: group e
of this rank's tokens rides the dispatch to rank e (block s of what
arrives is source s's group), the resident expert multiplies all of it,
and the mirrored exchange returns block s to source s, so block e of the
result is this rank's group e through expert e, in token order.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.ep_alltoall.base import EPAllToAll


class PyTorchEPAllToAll(EPAllToAll):
    def _input_setup(self) -> None:
        super()._input_setup()
        a2a = self.runtime.all_to_all_rows

        def step(a_loc, w_loc):
            return a2a(torch_matmul(a2a(a_loc), w_loc))

        self._fn = step
