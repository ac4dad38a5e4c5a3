"""AG+GEMM with the hand-written Hopper kernels as the compute/comm path.

The counterpart of the JAX package's ``pallas`` member, with its two
algorithms:

- ``xla_collective``: the same collective as the ``pytorch`` member (an
  NCCL all-gather on the card) with K1 (``ops.matmul.matmul``) in place of
  ``torch.matmul``, and the same ``order`` option.
- ``ring_rdma``: the whole primitive as one kernel, K2
  (``ops.collective_matmul.ring_ag_matmul``): chunks travel the ring
  through NVLink peer memory while the same launch GEMMs them. Its peer
  buffers are allocated once, at set-up (a collective).

As the JAX member, an option that the chosen algorithm ignores is
rejected when set: ``order`` under ``ring_rdma``, ``detect_races`` under
``xla_collective``. ``detect_races`` is the Pallas interpreter's race
detector and has no CUDA counterpart: it stays in the schema and only
``false`` is taken. The JAX member's ``block_m``, ``block_n``,
``block_k`` and ``tune`` size its TPU tiles; K1's and K2's tiles are fixed
in their sources, so those options raise. K1 and K2 take bfloat16,
float16 and float32; other dtypes raise ``ValueError`` at construction.
On a CPU tensor both algorithms run their kernels' plain versions.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.quantized_mixin import reject_tpu_tiles
from ddlb_tpu_torch.primitives.tp_columnwise.pytorch import PyTorchTPColumnwise

ALGORITHMS = ["xla_collective", "ring_rdma"]


def check_algorithm_options(member) -> None:
    """The JAX ``pallas`` members' dead-option rule, and ``detect_races``:
    ``order`` has no effect under a kernel algorithm (``ring_rdma``,
    ``a2a_rdma``), ``detect_races`` none under ``xla_collective``."""
    overridden = member._options_manager.overridden
    kernel = member.options["algorithm"] != "xla_collective"
    dead = ({"order"} if kernel else {"detect_races"}) & overridden
    if dead:
        raise ValueError(
            f"Option(s) {sorted(dead)} have no effect with "
            f"algorithm={member.options['algorithm']!r}"
        )
    if member.options["detect_races"]:
        raise ValueError(
            "detect_races=true is the Pallas interpreter's race detector and "
            "has no CUDA counterpart in ddlb_tpu_torch"
        )


class CudaTPColumnwise(PyTorchTPColumnwise):
    DEFAULT_OPTIONS = {
        "algorithm": "xla_collective",
        "order": "AG_before",
        "detect_races": False,
    }
    ALLOWED_VALUES = {
        "algorithm": ALGORITHMS,
        "order": ["AG_before", "AG_after"],
        "detect_races": [True, False],
    }
    gemm = staticmethod(k1.matmul)

    def __init__(self, *args, **options) -> None:
        reject_tpu_tiles(options, "the cuda member", "K1's and K2's tiles are fixed "
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
            ring = cm.peer_ring(runtime, "ag", self.a.numel(), self.a.dtype)

        def step(a_shard, b):
            return cm.ring_ag_matmul(a_shard, b, runtime, ring)

        self._fn = step
