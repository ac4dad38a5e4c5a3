"""AG+GEMM with the hand-written Hopper GEMM (K1) as the compute path.

The counterpart of the JAX package's ``pallas`` member with
``algorithm=xla_collective``: the same collective as the ``pytorch``
member (an NCCL all-gather on the card), with ``ops.matmul.matmul`` in
place of ``torch.matmul``, and the same ``order`` option. K1 takes
bfloat16, float16 and float32; other dtypes raise ``ValueError`` at
construction.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.tp_columnwise.pytorch import PyTorchTPColumnwise


class CudaTPColumnwise(PyTorchTPColumnwise):
    gemm = staticmethod(k1.matmul)

    def _check_shapes(self) -> None:
        k1.check_dtype(torch_dtype(self.dtype))
        super()._check_shapes()
