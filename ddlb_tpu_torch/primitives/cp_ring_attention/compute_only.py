"""Compute-only roofline for context-parallel attention (no communication).

``size='unsharded'`` runs full causal attention on one device (the upper
bound); ``size='sharded'`` runs only the diagonal block, the first
``m/d`` rows of Q against the same rows of K/V, as rank 0 holds them (one
partition's compute share; validation skipped, since the off-diagonal
context is missing by construction). The math is the plain
``causal_attention``, as in the JAX package.
"""

from __future__ import annotations

import functools

from ddlb_tpu_torch.primitives.cp_ring_attention.base import (
    CPRingAttention,
    causal_attention,
)


class ComputeOnlyCPRingAttention(CPRingAttention):
    DEFAULT_OPTIONS = {"size": "sharded"}
    ALLOWED_VALUES = {"size": ["sharded", "unsharded"]}

    def _input_setup(self) -> None:
        q, k, v = self._host_qkv()
        if self.options["size"] == "sharded":
            q, k, v = q[: self.s_loc], k[: self.s_loc], v[: self.s_loc]
        self.q, self.kv_k, self.kv_v = (self._place(x) for x in (q, k, v))
        self._fn = functools.partial(
            causal_attention, scale=self.scale, window=self.options["window"]
        )

    def validate(self, result) -> bool:
        if self.options["size"] == "sharded":
            return True
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare(result, self._expected_full())
