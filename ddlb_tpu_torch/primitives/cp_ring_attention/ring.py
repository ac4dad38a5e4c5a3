"""Ring attention in plain PyTorch: K/V blocks circulate, the softmax
accumulates online.

Q stays put (sequence-sharded); the K/V blocks hop the ring
(``Runtime.ring_shift``: ``batch_isend_irecv`` to rank r+1, from rank r-1)
while each rank folds the block it holds into a running (max, sum, output)
accumulator, so the transfer of block t+1 overlaps the math of block t
and no rank holds the full sequence. ``skip_masked_blocks`` skips the fold
of blocks entirely outside the live band (strictly in the future, or
entirely behind the window): the test is on Python integers, so it needs
no device sync.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.ops.flash_attention import ring_chunk_live
from ddlb_tpu_torch.primitives.cp_ring_attention.base import (
    NEG_INF,
    CPRingAttention,
)


class RingCPRingAttention(CPRingAttention):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"skip_masked_blocks": True}
    ALLOWED_VALUES = {"skip_masked_blocks": [True, False]}

    def _build_step(self):
        my, s_loc, h, dh = self.rank, self.s_loc, self.num_heads, self.k
        group = self.num_heads // self.kv_heads
        scale, window = self.scale, self.options["window"]
        skip = self.options["skip_masked_blocks"]
        rows = torch.arange(s_loc, device=self.device)[:, None]
        cols = torch.arange(s_loc, device=self.device)[None, :]

        def fold(qh, k_blk, v_blk, src, o, m_run, l_run):
            kh = k_blk.transpose(0, 1).float()
            vh = v_blk.transpose(0, 1).float()
            if group > 1:
                # GQA: the ring carried the small kv-head block; expand
                # only at fold time
                kh = kh.repeat_interleave(group, dim=0)
                vh = vh.repeat_interleave(group, dim=0)
            s = qh @ kh.transpose(1, 2)
            # causal mask on global positions (and, windowed, the band)
            mask = (my * s_loc + rows) >= (src * s_loc + cols)
            if window:
                mask &= (src * s_loc + cols) > (my * s_loc + rows - window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_new = l_run * alpha + p.sum(-1)
            o_new = o * alpha[..., None] + p @ vh
            return o_new, m_new, l_new

        def step(q, k, v):
            qh = q.transpose(0, 1).float() * scale  # [h, s_loc, dh]
            o = torch.zeros((h, s_loc, dh), dtype=torch.float32, device=q.device)
            m_run = torch.full((h, s_loc), NEG_INF, device=q.device)
            l_run = torch.zeros((h, s_loc), device=q.device)
            for _, src, k_blk, v_blk in self._ring_chunks(k, v):
                if not skip or ring_chunk_live(src, my, s_loc, window):
                    o, m_run, l_run = fold(qh, k_blk, v_blk, src, o, m_run, l_run)
            out = o / l_run[..., None]
            return out.transpose(0, 1).to(q.dtype)

        return step
