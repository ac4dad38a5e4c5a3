"""PPPipeline: the pipeline-parallel staged GEMM chain.

The counterpart of the JAX package's ``pp_pipeline/base.py``: ``y = x @
W_0 @ W_1 @ ... @ W_{S-1}`` with ``x [m, k]`` on every rank (the chain
enters at stage 0), stage ``p``'s weight ``W_p [k, n]`` on rank ``p`` (so
``k == n``: stages compose), and the output ``[m, n]`` on every rank. The
weights are drawn uniform on [-1, 1] and scaled by ``sqrt(3/k)`` so that
activations stay of order one through the chain. FLOPs ``2 m k n S``.

Validation holds every rank's output to the chain in float32 (float64 for
a float64 row), each stage's product rounded to the row's dtype as the
members round it, at the reference rule scaled by the depth:
``validation_atol(dtype, k) * S``. The oracle runs on the rank's device
(TF32 off) and is kept per process, one chain at a time. ``transport``
(ici/dcn) lays the ring out (``Runtime.order_ring``): stage ``p`` lives on
the rank at ring position ``p``, and the hops walk the positions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import (
    Primitive,
    matmul_precision_scope,
    seeded_draw,
    torch_dtype,
    validation_atol,
)

#: the one chain output kept per process, by (seed, m, k, n, stages, dtype)
_CHAIN_MEMO: Dict[tuple, np.ndarray] = {}


class PPPipeline(Primitive):
    """ABC for pipeline-parallel staged-GEMM implementations."""

    primitive_name = "pp_pipeline"

    BASE_OPTIONS = {"transport": "ici"}
    BASE_ALLOWED = {"transport": ["ici", "dcn"]}

    def _check_shapes(self) -> None:
        if self.k != self.n:
            raise ValueError(f"pp_pipeline stages compose: k={self.k} must equal n={self.n}")
        if self.dtype in ("int32", "int64"):
            raise ValueError("pp_pipeline requires a floating dtype (scaled stage weights)")

    @property
    def num_stages(self) -> int:
        return self.num_partitions

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.num_stages

    def wire_bytes(self) -> float:
        """A rank's activation-hop bytes (the JAX family's floor, :67):
        every microbatch's ``[., n]`` activation crosses each stage
        boundary once, ``m * n`` elements a rank whatever the microbatch
        count. ``compute_only``, ``pytorch`` and ``schedules`` override
        it."""
        if self.num_partitions <= 1:
            return 0.0
        return float(self.m * self.n * wire_itemsize(self.dtype))

    def _host_chain_operands(self) -> Tuple[np.ndarray, np.ndarray]:
        """Seeded tokens ``[m, k]`` and stage weights ``[S, k, n]``, the JAX
        package's draws (:77-87); copies of the draw ``seeded_draw`` keeps."""
        def draw():
            rng = np.random.default_rng(self.seed)
            gen = np.float64 if self.dtype == "float64" else np.float32
            a = rng.uniform(-1.0, 1.0, (self.m, self.k)).astype(gen)
            scale = np.sqrt(3.0 / self.k).astype(gen)
            w = (rng.uniform(-1.0, 1.0, (self.num_stages, self.k, self.n))
                 * scale).astype(gen)
            return a, w

        return seeded_draw(("pp_chain", self.seed, self.m, self.k, self.n,
                            self.num_stages, self.dtype), draw)

    def _input_setup(self) -> None:
        a_host, w_host = self._host_chain_operands()
        self.a = self._place(a_host)
        self.w = self._place(w_host[self.rank])

    @property
    def _call_args(self):
        return (self.a, self.w)

    def _expected_full(self) -> np.ndarray:
        """The chain in float32/float64 from the operands rounded to the
        row's dtype, each stage's product rounded to it too (JAX
        :109-127); memoised."""
        key = (self.seed, self.m, self.k, self.n, self.num_stages, self.dtype)
        if key not in _CHAIN_MEMO:
            _CHAIN_MEMO.clear()
            dt = torch_dtype(self.dtype)
            acc = torch.float64 if self.dtype == "float64" else torch.float32
            a, w = (self._place(x).to(acc) for x in self._host_chain_operands())
            with torch.no_grad(), matmul_precision_scope("float32"):
                y = a
                for j in range(self.num_stages):
                    y = (y @ w[j]).to(dt).to(acc)
            _CHAIN_MEMO[key] = y.cpu().numpy()
            del a, w, y
        return _CHAIN_MEMO[key]

    def _atol(self) -> float:
        return validation_atol(self.dtype, self.k) * self.num_stages

    def validate(self, result) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare(result, self._expected_full(), atol=self._atol())
