"""ddlb_tpu_torch: the PyTorch and CUDA port of ddlb_tpu for NVIDIA Hopper.

The sweep runner and the tensor-parallel GEMM primitives (``tp_columnwise``,
``tp_rowwise``) over ``torch.distributed`` (NCCL on the card, gloo on the
CPU), with the tiled GEMM written by hand in CUDA C++ for ``sm_90a``
(``ops/matmul.py``, ``csrc/matmul.cu``). Entry points run on the card
unless the caller passes ``device="cpu"``. The JAX package ``ddlb_tpu`` is
the reference this port is tested against; nothing here imports it.
"""

from __future__ import annotations

__version__ = "0.1.0"
