"""ddlb_tpu_torch: the PyTorch and CUDA port of ddlb_tpu for NVIDIA Hopper.

The sweep runner, the tensor-parallel GEMM primitives (``tp_columnwise``,
``tp_rowwise``), the context-parallel attention primitive
(``cp_ring_attention``) and the serving model with its primitive
(``models/``, ``transformer_decode``) over ``torch.distributed`` (NCCL on
the card, gloo on the CPU), with the kernels written by hand in CUDA C++
for ``sm_90a``: the tiled GEMM (``ops/matmul.py``, ``csrc/matmul.cu``),
the flash attention forward and carried-chunk fold
(``ops/flash_attention.py``, ``csrc/flash_attention.cu``) and the
single-token decode attention over a contiguous or paged KV cache
(``ops/decode_attention.py``, ``csrc/decode_attention.cu``). Entry points run on the card unless the
caller passes ``device="cpu"``. The JAX package ``ddlb_tpu`` is the
reference this port is tested against; nothing here imports it.
"""

from __future__ import annotations

__version__ = "0.3.0"
