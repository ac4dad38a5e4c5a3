"""EPAllToAll: expert-parallel dispatch, expert GEMM, combine.

The counterpart of the JAX package's ``ep_alltoall/base.py``: the MoE
communication pattern as a primitive. With d ranks there are d experts,
expert e resident on rank e with weight ``W_e [k, n]``. The tokens ``A [m,
k]`` are row-sharded ``[m/d, k]``; each rank's tokens split into d
contiguous groups of ``m/d^2`` and group e goes to expert e by an
all-to-all, the resident expert applies its GEMM, and a mirrored
all-to-all returns the outputs in token order, ``[m/d, n]`` a rank
(capacity-balanced deterministic routing, the standard MoE
micro-benchmark). Requires ``m % d^2 == 0``. Tokens and experts come from
the JAX package's numpy draws (``_host_tokens_experts``), so both build
the same operands. Validation holds this rank's rows to the routed
single-device product (``_expected_full``) under the reference rule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ddlb_tpu_torch.primitives.base import _EXPECTED_MEMO, Primitive, seeded_draw


class EPAllToAll(Primitive):
    """ABC for expert-parallel all-to-all + expert-GEMM implementations."""

    primitive_name = "ep_alltoall"

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.m % (d * d) != 0:
            raise ValueError(
                f"m={self.m} must be divisible by partitions^2={d * d} "
                f"(d contiguous token groups per partition)"
            )

    @property
    def group_tokens(self) -> int:
        """Tokens per (partition, expert) routing group."""
        d = self.num_partitions
        return self.m // (d * d)

    def _host_tokens_experts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Seeded tokens ``[m, k]`` and expert weights ``[d, k, n]``, the
        same on every rank and in the JAX package (copies of the draw
        ``seeded_draw`` keeps)."""
        def draw():
            rng = np.random.default_rng(self.seed)
            gen = np.float64 if self.dtype == "float64" else np.float32
            a = rng.uniform(-1.0, 1.0, (self.m, self.k)).astype(gen)
            w = rng.uniform(
                -1.0, 1.0, (self.num_partitions, self.k, self.n)
            ).astype(gen)
            if self.dtype in ("int32", "int64"):
                a = np.rint(a * 3).astype(self.dtype)
                w = np.rint(w * 3).astype(self.dtype)
            return a, w

        key = ("tokens_experts", self.num_partitions, self.seed, self.m, self.n,
               self.k, self.dtype)
        return seeded_draw(key, draw)

    def _input_setup(self) -> None:
        a_host, w_host = self._host_tokens_experts()
        rows = self.m // self.num_partitions
        self.a = self._place(a_host[self.rank * rows:(self.rank + 1) * rows])
        self.w = self._place(w_host[self.rank])  # this rank's expert [k, n]

    @property
    def _call_args(self):
        return (self.a, self.w)

    def _expected_full(self) -> np.ndarray:
        """Single-device routed product: group e of every partition's
        tokens through expert e, one host GEMM per (partition, expert)
        block; memoised (one entry per process)."""
        d, g = self.num_partitions, self.group_tokens
        key = (self.primitive_name, d, self.seed, self.m, self.n, self.k, self.dtype)
        if key not in _EXPECTED_MEMO:
            _EXPECTED_MEMO.clear()
            a, w = self._host_tokens_experts()
            acc = np.float64 if self.dtype == "float64" else np.float32
            a4 = a.reshape(d, d, g, self.k).astype(acc)
            w = w.astype(acc)
            out = np.empty((d, d, g, self.n), acc)
            for p in range(d):
                for e in range(d):
                    out[p, e] = a4[p, e] @ w[e]
            _EXPECTED_MEMO[key] = out.reshape(self.m, self.n)
        return _EXPECTED_MEMO[key]

    def validate(self, result: torch.Tensor) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare_rows(result, self._expected_full())
