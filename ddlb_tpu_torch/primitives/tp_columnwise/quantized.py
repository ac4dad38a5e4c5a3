"""AG+GEMM on the int8 path: quantize, gather int8, dequantizing epilogue.

The port of the JAX package's ``tp_columnwise/quantized.py``. B plays the
weight: it is quantized per column once at set-up. ``quantize=static``
quantizes this rank's ``[m/d, k]`` shard of A per row at set-up too, and
the measured step all-gathers the int8 shard and its float32 ``[m/d, 1]``
scales, then runs the int8 GEMM; ``dynamic`` quantizes the local shard
inside every step (one extra pass over A). The gathered operand travels as
int8, half the bytes of the bf16 members' gather, with the scales beside
it. ``kernel`` picks the GEMM (``quantized_mixin``). Validation holds the
result to the unquantized float32 product at ``quantization_atol(k)``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops.quantized_matmul import (
    quantization_atol,
    quantize_colwise,
    quantize_rowwise,
)
from ddlb_tpu_torch.primitives.quantized_mixin import QuantizedGEMMMixin
from ddlb_tpu_torch.primitives.tp_columnwise.base import TPColumnwise


class QuantizedTPColumnwise(QuantizedGEMMMixin, TPColumnwise):
    def _check_shapes(self) -> None:
        super()._check_shapes()
        self._check_quantized_options()

    def _input_setup(self) -> None:
        super()._input_setup()
        gemm, gather = self._int8_gemm(), self.runtime.all_gather_rows
        bq, self.sb = quantize_colwise(self.b)
        self.bq = self._weight_layout(bq)
        if self.options["quantize"] == "static":
            self.aq, self.sa = quantize_rowwise(self.a)

            def step(aq_shard, sa_shard, bq, sb):
                return gemm(gather(aq_shard), bq, gather(sa_shard), sb)

            self._args = (self.aq, self.sa, self.bq, self.sb)
        else:

            def step(a_shard, bq, sb):
                q, s = quantize_rowwise(a_shard)
                return gemm(gather(q), bq, gather(s), sb)

            self._args = (self.a, self.bq, self.sb)
        self._fn = step

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
