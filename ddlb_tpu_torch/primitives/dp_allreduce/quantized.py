"""GEMM+AR on the int8 path: the quantized gradient GEMM.

The port of the JAX package's ``dp_allreduce/quantized.py``. As in the
rowwise member, each rank quantizes its own k-shards (A's per row, B's
per column), so its int8 partial dequantizes to the operand dtype locally
and the all-reduce sums that dtype: the summation across replicas stays
in the wide dtype, as int8 training recipes keep gradient accumulation.
In the gradient step both operands are fresh every iteration, so
``quantize=dynamic`` quantizes both shards inside the step; ``static``
quantizes both at set-up. Validation: the replicated ``[m, n]`` against
the unquantized float32 product at ``quantization_atol(k)``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops.quantized_matmul import (
    quantization_atol,
    quantize_colwise,
    quantize_rowwise,
)
from ddlb_tpu_torch.primitives.dp_allreduce.base import DPAllReduce
from ddlb_tpu_torch.primitives.quantized_mixin import QuantizedGEMMMixin


class QuantizedDPAllReduce(QuantizedGEMMMixin, DPAllReduce):
    def _check_shapes(self) -> None:
        super()._check_shapes()
        self._check_quantized_options()

    def _input_setup(self) -> None:
        super()._input_setup()
        gemm, all_reduce = self._int8_gemm(), self.runtime.all_reduce
        layout = self._weight_layout

        def partial_ar(aq, sa, bq, sb):
            return all_reduce(gemm(aq, bq, sa, sb))  # replicated gradient

        if self.options["quantize"] == "static":
            self.aq, self.sa = quantize_rowwise(self.a)
            bq, self.sb = quantize_colwise(self.b)
            self.bq = layout(bq)
            self._fn = partial_ar
            self._args = (self.aq, self.sa, self.bq, self.sb)
        else:

            def step(a_shard, b_shard):
                aq, sa = quantize_rowwise(a_shard)
                bq, sb = quantize_colwise(b_shard)
                return partial_ar(aq, sa, layout(bq), sb)

            self._fn = step
            self._args = (self.a, self.b)

    @property
    def _call_args(self):
        return self._args

    def validate(self, result: torch.Tensor) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare(
            result, self._expected_full(), atol=quantization_atol(self.k)
        )
