"""Ring attention with the carried-chunk flash kernel (K9) as the per-hop
compute.

K/V chunks circulate as in the ``ring`` member (``Runtime.ring_shift``,
the next hop posted before the current chunk is folded), and each rank
folds the chunk it holds into a carried (acc, m, l) with
``ops.flash_attention.flash_attention_chunk``, then normalises with
``finalize_flash_carry``. With ``skip_masked_blocks`` (the default) the
hop index classifies each chunk: ``diagonal`` (relative mask) at t = 0,
strictly ``past`` (no mask) after, or ``offset`` after when a window needs
the band mask on past chunks too; chunks outside the live band are not
folded. Without it every hop folds with the ``offset`` mask. bfloat16,
float16 and float32 only (the kernel's dtypes).
"""

from __future__ import annotations

from ddlb_tpu_torch.ops import flash_attention as fa
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.cp_ring_attention.base import CPRingAttention


class RingFlashCPRingAttention(CPRingAttention):
    DEFAULT_OPTIONS = {"skip_masked_blocks": True}
    ALLOWED_VALUES = {"skip_masked_blocks": [True, False]}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        fa.check_kernel_dtype(torch_dtype(self.dtype))

    def _build_step(self):
        my, s_loc, h, dh = self.rank, self.s_loc, self.num_heads, self.k
        scale, window = self.scale, self.options["window"]
        skip = self.options["skip_masked_blocks"]
        later = "offset" if window else "past"

        def step(q, k, v):
            carry = fa.init_flash_carry(s_loc, h, dh, q.device)
            for t, src, k_blk, v_blk in self._ring_chunks(k, v):
                if skip and not fa.ring_chunk_live(src, my, s_loc, window):
                    continue
                carry = fa.flash_attention_chunk(
                    q, k_blk, v_blk, carry, scale=scale,
                    row_offset=my * s_loc, col_offset=src * s_loc,
                    causal=("diagonal" if t == 0 else later) if skip else "offset",
                    window=window,
                )
            return fa.finalize_flash_carry(carry, q.dtype)

        return step
