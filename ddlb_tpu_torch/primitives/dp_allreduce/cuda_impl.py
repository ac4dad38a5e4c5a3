"""GEMM+AR with the hand-written Hopper kernels as the compute/comm path.

The counterpart of the JAX package's ``pallas`` member
(``dp_allreduce/pallas_impl.py``), with its two algorithms:

- ``xla_collective``: K1 (``ops.matmul.matmul``) computes the
  ``[m, k/d] @ [k/d, n]`` partial gradient, then one NCCL all-reduce sums
  the replicas.
- ``ring_rdma``: the all-reduce as reduce-scatter + all-gather with the
  GEMM+RS phase fused into one kernel, K3
  (``ops.collective_matmul.ring_matmul_rs``: partial sums travel the ring
  through NVLink peer memory, in the operand dtype, while the same launch
  GEMMs the next chunk), then an NCCL all-gather of the ``[m/d, n]``
  reduced rows restores the replicated gradient. The JAX member gathers
  with ``lax.all_gather`` too, not with the ring kernel K4. Requires
  ``m % d == 0``; the peer ring is allocated once, at set-up (a
  collective).

The option rules are the tp ``cuda`` members' (``detect_races`` only
``false`` and only under ``ring_rdma``; the TPU tile options raise). K1 and
K3 take bfloat16, float16 and float32; other dtypes raise ``ValueError``
at construction. On a CPU tensor both algorithms run their kernels' plain
versions.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.dp_allreduce.base import DPAllReduce
from ddlb_tpu_torch.primitives.quantized_mixin import reject_tpu_tiles
from ddlb_tpu_torch.primitives.tp_columnwise.cuda_impl import (
    ALGORITHMS,
    check_algorithm_options,
)


class CudaDPAllReduce(DPAllReduce):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"algorithm": "xla_collective", "detect_races": False}
    ALLOWED_VALUES = {"algorithm": ALGORITHMS, "detect_races": [True, False]}

    def __init__(self, *args, **options) -> None:
        reject_tpu_tiles(options, "the cuda member", "K1's and K3's tiles are fixed "
                         "in csrc/matmul.cu and csrc/collective_matmul.cu")
        super().__init__(*args, **options)

    def _check_shapes(self) -> None:
        k1.check_dtype(torch_dtype(self.dtype))
        super()._check_shapes()
        d = self.num_partitions
        if self.options["algorithm"] == "ring_rdma" and self.m % d != 0:
            raise ValueError(
                f"m={self.m} must be divisible by partitions={d} for "
                f"algorithm=ring_rdma"
            )
        check_algorithm_options(self)

    def _input_setup(self) -> None:
        super()._input_setup()
        rt = self.runtime
        if self.options["algorithm"] == "xla_collective":

            def step(a_shard, b_shard):
                return rt.all_reduce(k1.matmul(a_shard, b_shard))

        else:
            ring = None
            if self.a.device.type == "cuda":
                rows = self.m // self.num_partitions
                ring = cm.peer_ring(rt, "rs", rows * self.n, self.a.dtype)

            def step(a_shard, b_shard):
                # [m/d, n]: this replica's gradient rows, summed over the ring
                return rt.all_gather_rows(cm.ring_matmul_rs(a_shard, b_shard, rt, ring))

        self._fn = step
