"""GEMM+RS with the hand-written Hopper kernels as the compute/comm path.

The counterpart of the JAX package's ``pallas`` member, with its two
algorithms:

- ``xla_collective``: K1 computes the ``[m, k/d] @ [k/d, n]`` partial,
  then the same reduce-scatter as the ``pytorch`` member.
- ``ring_rdma``: the whole primitive as one kernel, K3
  (``ops.collective_matmul.ring_matmul_rs``): partial-sum accumulators
  travel the ring through NVLink peer memory, in the operand dtype, while
  the same launch GEMMs the next chunk. Its peer buffers are allocated
  once, at set-up (a collective).

The option rules are the tp_columnwise ``cuda`` member's (``detect_races``
only ``false``, only under ``ring_rdma``; the TPU tile options raise).
K1 and K3 take bfloat16, float16 and float32; other dtypes raise
``ValueError`` at construction. On a CPU tensor both algorithms run their
kernels' plain versions.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.quantized_mixin import reject_tpu_tiles
from ddlb_tpu_torch.primitives.tp_columnwise.cuda_impl import (
    ALGORITHMS,
    check_algorithm_options,
)
from ddlb_tpu_torch.primitives.tp_rowwise.pytorch import PyTorchTPRowwise


class CudaTPRowwise(PyTorchTPRowwise):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"algorithm": "xla_collective", "detect_races": False}
    ALLOWED_VALUES = {"algorithm": ALGORITHMS, "detect_races": [True, False]}
    gemm = staticmethod(k1.matmul)

    def __init__(self, *args, **options) -> None:
        reject_tpu_tiles(options, "the cuda member", "K1's and K3's tiles are fixed "
                         "in csrc/matmul.cu and csrc/collective_matmul.cu")
        super().__init__(*args, **options)

    def _check_shapes(self) -> None:
        k1.check_dtype(torch_dtype(self.dtype))
        super()._check_shapes()
        check_algorithm_options(self)

    def _input_setup(self) -> None:
        super()._input_setup()
        if self.options["algorithm"] != "ring_rdma":
            return
        runtime = self.runtime
        ring = None
        if self.a.device.type == "cuda":
            m_loc = self.m // self.num_partitions
            ring = cm.peer_ring(runtime, "rs", m_loc * self.n, self.a.dtype)

        def step(a_shard, b_shard):
            return cm.ring_matmul_rs(a_shard, b_shard, runtime, ring)

        self._fn = step
