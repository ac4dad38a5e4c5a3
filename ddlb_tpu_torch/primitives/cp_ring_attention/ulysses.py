"""Ulysses-style context parallelism: all-to-all heads <-> sequence.

An all-to-all turns the sequence-sharded ``[m/d, h, k]`` Q/K/V into
head-sharded ``[m, h/d, k]`` tensors (``Runtime.all_to_all_heads_seq``, on
``all_to_all_single``); each rank runs full-sequence causal attention over
its own heads, and the inverse all-to-all restores sequence sharding.
Requires ``num_heads % d == 0`` and ``n_kv_heads % d == 0``.

``compute``: ``einsum`` (the plain ``causal_attention``) or ``flash`` (the
flash forward at ``row_offset = 0``: the triangle case K8a, or K8b with a
window that does not cover the sequence).
"""

from __future__ import annotations

import functools

from ddlb_tpu_torch.ops import flash_attention as fa
from ddlb_tpu_torch.primitives.base import torch_dtype
from ddlb_tpu_torch.primitives.cp_ring_attention.base import (
    CPRingAttention,
    causal_attention,
)


class UlyssesCPRingAttention(CPRingAttention):
    DEFAULT_OPTIONS = {"compute": "einsum"}
    ALLOWED_VALUES = {"compute": ["einsum", "flash"]}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        d = self.num_partitions
        if self.num_heads % d != 0:
            raise ValueError(
                f"num_heads={self.num_heads} must be divisible by "
                f"partitions={d} for ulysses"
            )
        if self.kv_heads % d != 0:
            raise ValueError(
                f"n_kv_heads={self.kv_heads} must be divisible by "
                f"partitions={d} for ulysses (the K/V all-to-all shards "
                f"kv heads)"
            )
        if self.options["compute"] == "flash":
            fa.check_kernel_dtype(torch_dtype(self.dtype))

    def _build_step(self):
        to_heads = self.runtime.all_to_all_heads_seq
        to_seq = self.runtime.all_to_all_seq_heads
        window = self.options["window"]
        if self.options["compute"] == "flash":
            attend = functools.partial(
                fa.flash_attention, scale=self.scale, row_offset=0,
                window=window,
            )
        else:
            attend = functools.partial(
                causal_attention, scale=self.scale, window=window
            )

        def step(q, k, v):
            # the full sequence is local now: causal attention at offset 0
            return to_seq(attend(to_heads(q), to_heads(k), to_heads(v)))

        return step
