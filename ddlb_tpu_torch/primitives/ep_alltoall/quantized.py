"""MoE dispatch and combine on the int8 path: int8 token dispatch and a
quantized expert GEMM.

The port of the JAX package's ``ep_alltoall/quantized.py``. Tokens are
quantized per row before the dispatch, so the exchange moves int8, half
the bf16 bytes, and each token's float32 scale rides a second all-to-all
beside it (both split on the token axis), so the dequantization after the
expert GEMM is exact wherever a token lands. The resident expert's weight
is quantized per column once at set-up (``quantize_weight_stack``, the
weight role); the GEMM sees the ``m/d`` tokens that land on this rank.
The combine returns the operand dtype. ``quantize=static`` quantizes the
token shard at set-up, ``dynamic`` inside every step. Validation: this
rank's rows against the routed float32 product at
``quantization_atol(k)``.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops.quantized_matmul import (
    quantization_atol,
    quantize_rowwise,
    quantize_weight_stack,
)
from ddlb_tpu_torch.primitives.ep_alltoall.base import EPAllToAll
from ddlb_tpu_torch.primitives.quantized_mixin import QuantizedGEMMMixin


class QuantizedEPAllToAll(QuantizedGEMMMixin, EPAllToAll):
    def _check_shapes(self) -> None:
        super()._check_shapes()
        self._check_quantized_options()

    def _input_setup(self) -> None:
        super()._input_setup()
        gemm, a2a = self._int8_gemm(), self.runtime.all_to_all_rows
        wq, self.ws = quantize_weight_stack(self.w)
        self.wq = self._weight_layout(wq)

        def dispatch_gemm_combine(aq, sa, wq, ws):
            """int8 tokens and their scales ride the dispatch together."""
            return a2a(gemm(a2a(aq), wq, a2a(sa), ws))

        if self.options["quantize"] == "static":
            self.aq, self.sa = quantize_rowwise(self.a)
            self._fn = dispatch_gemm_combine
            self._args = (self.aq, self.sa, self.wq, self.ws)
        else:

            def step(a_loc, wq, ws):
                aq, sa = quantize_rowwise(a_loc)
                return dispatch_gemm_combine(aq, sa, wq, ws)

            self._fn = step
            self._args = (self.a, self.wq, self.ws)

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
