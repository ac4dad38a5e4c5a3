"""GEMM+RS on the int8 path (sequence parallel, quantized compute).

The port of the JAX package's ``tp_rowwise/quantized.py``. Each rank
quantizes its own k-shards: A's ``[m, k/d]`` per row, B's ``[k/d, n]``
per column (the weight, at set-up). Partial products of different ranks
carry different scales and cannot be summed in int32, so each rank's
int8 GEMM dequantizes its partial to the operand dtype, and the
reduce-scatter sums those in the operand dtype: the same bytes as the
bf16 members. ``quantize=static`` quantizes A's shard at set-up,
``dynamic`` inside every step. Validation: this rank's ``[m/d, n]`` rows
against the unquantized float32 product at ``quantization_atol(k)`` (d
partials of k/d quantized terms have one full-k GEMM's noise).
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops.quantized_matmul import (
    quantization_atol,
    quantize_colwise,
    quantize_rowwise,
)
from ddlb_tpu_torch.primitives.quantized_mixin import QuantizedGEMMMixin
from ddlb_tpu_torch.primitives.tp_rowwise.base import TPRowwise


class QuantizedTPRowwise(QuantizedGEMMMixin, TPRowwise):
    def _check_shapes(self) -> None:
        super()._check_shapes()
        self._check_quantized_options()

    def _input_setup(self) -> None:
        super()._input_setup()
        gemm, scatter = self._int8_gemm(), self.runtime.reduce_scatter_rows
        bq, self.sb = quantize_colwise(self.b)
        self.bq = self._weight_layout(bq)

        def partial_rs(aq, sa, bq, sb):
            return scatter(gemm(aq, bq, sa, sb))  # [m, n] -> [m/d, n]

        if self.options["quantize"] == "static":
            self.aq, self.sa = quantize_rowwise(self.a)
            self._fn = partial_rs
            self._args = (self.aq, self.sa, self.bq, self.sb)
        else:

            def step(a_shard, bq, sb):
                aq, sa = quantize_rowwise(a_shard)
                return partial_rs(aq, sa, bq, sb)

            self._fn = step
            self._args = (self.a, self.bq, self.sb)

    @property
    def _call_args(self):
        return self._args

    def validate(self, result: torch.Tensor) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare_rows(
            result, self._expected_full(), atol=quantization_atol(self.k)
        )
