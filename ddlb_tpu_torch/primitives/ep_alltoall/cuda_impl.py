"""MoE dispatch, expert GEMM and combine with the hand-written Hopper
kernels.

The counterpart of the JAX package's ``pallas`` member
(``ep_alltoall/pallas_impl.py``), with its two algorithms:

- ``xla_collective``: an NCCL all-to-all dispatches the tokens, K1
  (``ops.matmul.matmul``, float32 sums rounded once to the operand dtype)
  multiplies the ``[d*g, k]`` tokens that landed by the resident expert,
  and the mirrored all-to-all returns them in token order.
- ``a2a_rdma``: the whole primitive as one kernel a rank, K6
  (``ops.alltoall_matmul.alltoall_expert_matmul``): the dispatch puts go
  out at once through NVLink peer memory, the expert's GEMMs run in
  arrival order, and each finished group goes straight home. Its buffers
  are allocated once, at set-up (a collective).

The option rules are the tp ``cuda`` members' (``detect_races`` only
``false`` and only under ``a2a_rdma``; the TPU tile options raise). K1 and
K6 take bfloat16, float16 and float32 (K6 with ``k`` and ``n`` rows of a
multiple of 16 bytes); anything else raises ``ValueError`` at
construction. On a CPU tensor both algorithms run their kernels' plain
versions.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import alltoall_matmul as am
from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.ep_alltoall.base import EPAllToAll
from ddlb_tpu_torch.primitives.quantized_mixin import reject_tpu_tiles
from ddlb_tpu_torch.primitives.tp_columnwise.cuda_impl import check_algorithm_options


class CudaEPAllToAll(EPAllToAll):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"algorithm": "xla_collective", "detect_races": False}
    ALLOWED_VALUES = {
        "algorithm": ["xla_collective", "a2a_rdma"],
        "detect_races": [True, False],
    }

    def __init__(self, *args, **options) -> None:
        reject_tpu_tiles(options, "the cuda member", "K1's and K6's tiles are fixed "
                         "in csrc/matmul.cu and csrc/alltoall_matmul.cu")
        super().__init__(*args, **options)

    def _check_shapes(self) -> None:
        dtype = torch_dtype(self.dtype)
        k1.check_dtype(dtype)
        super()._check_shapes()
        check_algorithm_options(self)
        if self.options["algorithm"] == "a2a_rdma":
            am.check_widths(self.k, self.n, dtype)

    def _input_setup(self) -> None:
        super()._input_setup()
        rt = self.runtime
        if self.options["algorithm"] == "xla_collective":
            a2a = rt.all_to_all_rows

            def step(a_loc, w_loc):
                return a2a(k1.matmul(a2a(a_loc), w_loc))

        else:
            buffers = None
            if self.a.device.type == "cuda":
                buffers = am.peer_buffers(rt, self.group_tokens, self.k, self.n,
                                          self.a.dtype)

            def step(a_loc, w_loc):
                return am.alltoall_expert_matmul(a_loc, w_loc, rt, buffers)

        self._fn = step
