"""Context-parallel attention with the flash forward kernel as compute.

K/V are gathered across the ranks (``all_gather_rows``, skipped at world
1) and the local query block runs ``ops.flash_attention.flash_attention``
at its global ``row_offset = r*m/d``. At world 1 the offset is the literal
0 and ``sq == skv``, so the triangle case (K8a) runs; with a window that
does not cover the sequence, or at d > 1, the rectangle (K8b). bfloat16,
float16 and float32 only (the kernels' dtypes); head_dim 128 on the card.
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import flash_attention as fa
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.cp_ring_attention.base import CPRingAttention


class FlashCPRingAttention(CPRingAttention):
    DEFAULT_OPTIONS = {}
    ALLOWED_VALUES = {}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        fa.check_kernel_dtype(torch_dtype(self.dtype))

    def _build_step(self):
        d, gather = self.num_partitions, self.runtime.all_gather_rows
        offset = self.rank * self.s_loc
        kw = dict(scale=self.scale, window=self.options["window"])

        def step(q, k, v):
            if d > 1:
                k, v = gather(k), gather(v)
            return fa.flash_attention(q, k, v, row_offset=offset, **kw)

        return step
