"""GEMM+RS with the hand-written Hopper GEMM (K1) for the partial product.

The counterpart of the JAX package's ``pallas`` member with
``algorithm=xla_collective``: K1 computes the ``[m, k/d] @ [k/d, n]``
partial, then the same reduce-scatter as the ``pytorch`` member. K1 takes
bfloat16, float16 and float32; other dtypes raise ``ValueError`` at
construction.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.tp_rowwise.pytorch import PyTorchTPRowwise


class CudaTPRowwise(PyTorchTPRowwise):
    gemm = staticmethod(k1.matmul)

    def _check_shapes(self) -> None:
        k1.check_dtype(torch_dtype(self.dtype))
        super()._check_shapes()
