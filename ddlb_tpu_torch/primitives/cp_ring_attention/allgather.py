"""All-gather comparator for context-parallel attention.

K and V are gathered whole (``all_gather_rows``: NCCL on the card, gloo on
the CPU) before any math, then the plain ``causal_attention`` runs the
local query block against the full sequence at ``row_offset = r*m/d``,
materialising ``[h, m/d, m]`` scores: the simple, bandwidth-hungry
yardstick the ring members are measured against.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.cp_ring_attention.base import (
    CPRingAttention,
    causal_attention,
)


class AllGatherCPRingAttention(CPRingAttention):
    DEFAULT_OPTIONS = {}
    ALLOWED_VALUES = {}

    def _build_step(self):
        gather, scale = self.runtime.all_gather_rows, self.scale
        offset, window = self.rank * self.s_loc, self.options["window"]

        def step(q, k, v):
            return causal_attention(
                q, gather(k), gather(v), scale, row_offset=offset,
                window=window,
            )

        return step
