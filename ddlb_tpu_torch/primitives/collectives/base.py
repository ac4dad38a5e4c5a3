"""Collectives: the pure communication micro-benchmark family.

The counterpart of the JAX package's ``collectives/base.py``: one
collective op per row, timed under the same runner and validation
contract as every other family, so the wire term can be read on its own
(nccl-tests' role in this framework). The payload is ``A [m, k]`` (``n``
is unused: keep it small), row-sharded ``[m/d, k]`` a rank, and each op's
result is defined on that global array:

- ``all_gather``: the shards -> the full ``[m, k]`` on every rank;
- ``all_reduce``: the elementwise sum of the d shards, ``[m/d, k]`` on
  every rank;
- ``reduce_scatter``: each shard as d chunks ``[m/d^2, k]``; chunk ``j``
  summed over the ranks lands on rank ``j``;
- ``all_to_all``: rank ``i``'s chunk ``j`` becomes rank ``j``'s chunk
  ``i``;
- ``ppermute``: rank ``i``'s shard moves to rank ``i + 1``.

``m % d == 0``; the ops that chunk a shard (``reduce_scatter``,
``all_to_all``, ``all_reduce``) need ``m % d^2 == 0``. ``transport``
(ici/dcn) orders the ring (``Runtime.order_ring``): the global array's
row block ``p`` lies on the rank at ring position ``p``.

Metric: the runner's Throughput column is ``flops() / 1e9 / ms``, and
``flops()`` returns ``1000 * wire_bytes()``, so the column reads a rank's
ring wire traffic in GB/s (nccl-tests' bus bandwidth, restated for a
ring); the rows say so in their ``unit`` column
(``registry.throughput_unit``). ``wire_bytes`` counts elements at the JAX
package's wire item sizes (``perfmodel.cost.wire_itemsize``: float64
counts 4, as its arrays are float32 there), so both packages report the
same figure.

Validation: each rank's result against its slice of the oracle
(``_expected_tensor``: the op on the seeded payload, in float32, computed
where the result lies, since a payload at ``config_collectives.json``'s
m = 65536 is a gigabyte): pure data movement exactly (atol 1e-6);
reductions sum d terms, so ``atol = (1e-2 half | 1e-5 else) * d``.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import Primitive, place

log = logging.getLogger(__name__)

COLLECTIVE_OPS = (
    "all_gather",
    "all_reduce",
    "reduce_scatter",
    "all_to_all",
    "ppermute",
)
#: ops whose result is a permutation or copy of the input (exact) vs
#: d-term reductions (tolerance scales with d)
_EXACT_OPS = ("all_gather", "all_to_all", "ppermute")
#: ops that chunk each shard into d sub-chunks, requiring m % d^2 == 0
_CHUNKED_OPS = ("reduce_scatter", "all_to_all", "all_reduce")
#: ops whose result is the same on every rank
_REPLICATED_OPS = ("all_gather", "all_reduce")

#: the one payload kept per process (``Collectives._payload``), and its copy
#: on the device that last validated
_PAYLOAD_MEMO: Dict[tuple, np.ndarray] = {}
_DEVICE_MEMO: Dict[tuple, torch.Tensor] = {}


class Collectives(Primitive):
    """ABC for pure-collective implementations."""

    primitive_name = "collectives"

    BASE_OPTIONS = {"op": "all_gather", "transport": "ici"}
    BASE_ALLOWED = {"op": list(COLLECTIVE_OPS), "transport": ["ici", "dcn"]}

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.m % d != 0:
            raise ValueError(f"m={self.m} must be divisible by partitions={d}")
        if self.options["op"] in _CHUNKED_OPS and (self.m // d) % d != 0:
            raise ValueError(
                f"m={self.m} must be divisible by partitions^2={d * d} "
                f"for op={self.options['op']}"
            )

    def _input_setup(self) -> None:
        rows = self.m // self.num_partitions
        self.a = self._place(self._payload()[self.rank * rows:(self.rank + 1) * rows])

    def _payload(self) -> np.ndarray:
        """The seeded ``[m, k]`` payload (``_host_operands``' A) rounded to
        the operand dtype as it is placed, held in float32 (float64 for a
        float64 row); one entry kept per process, since every row of a
        sweep at one shape draws the same payload and the large shapes'
        draw takes seconds."""
        key = (self.seed, self.m, self.k, self.dtype)
        if key not in _PAYLOAD_MEMO:
            _PAYLOAD_MEMO.clear()
            _DEVICE_MEMO.clear()
            a_host, _ = self._host_operands()
            wide = torch.float64 if self.dtype == "float64" else torch.float32
            _PAYLOAD_MEMO[key] = place(a_host, self.dtype, "cpu").to(wide).numpy()
        return _PAYLOAD_MEMO[key]

    @property
    def _call_args(self):
        return (self.a,)

    # -- metric ---------------------------------------------------------------

    def wire_bytes(self) -> float:
        """Bytes one rank sends over the interconnect under a ring algorithm
        for this op (the bus-bandwidth numerator)."""
        d = self.num_partitions
        shard = (self.m // d) * self.k * wire_itemsize(self.dtype)
        if d == 1:
            return 0.0
        op = self.options["op"]
        if op == "all_gather":
            return shard * (d - 1)
        if op in ("reduce_scatter", "all_to_all"):
            return (shard / d) * (d - 1)
        if op == "all_reduce":
            return 2.0 * (shard / d) * (d - 1)
        return float(shard)  # ppermute: one hop

    def flops(self) -> float:
        # 1000 * bytes makes the runner's flops / 1e9 / ms a rank's wire GB/s
        return 1000.0 * self.wire_bytes()

    # -- validation -----------------------------------------------------------

    def _expected_tensor(self, device) -> torch.Tensor:
        """The oracle: the op's global result (see the module docstring) on
        the payload, in float32 (float64 for a float64 row), computed on
        ``device`` from the payload's copy there (kept with the payload)."""
        key = (self.seed, self.m, self.k, self.dtype, str(device))
        payload = self._payload()
        if key not in _DEVICE_MEMO:
            _DEVICE_MEMO.clear()
            _DEVICE_MEMO[key] = torch.from_numpy(payload).to(device)
        a = _DEVICE_MEMO[key]
        d, op = self.num_partitions, self.options["op"]
        if op == "all_gather":
            return a
        if op == "all_reduce":
            return a.reshape(d, self.m // d, self.k).sum(0)
        if op == "ppermute":
            return torch.roll(a, self.m // d, dims=0)
        chunks = a.reshape(d, d, self.m // (d * d), self.k)
        if op == "reduce_scatter":
            return chunks.sum(0).reshape(self.m // d, self.k)
        return chunks.transpose(0, 1).reshape(self.m, self.k)  # all_to_all

    def _expected(self) -> np.ndarray:
        """The host oracle: ``_expected_tensor`` on the CPU."""
        return self._expected_tensor("cpu").numpy()

    def _atol(self) -> float:
        if self.options["op"] in _EXACT_OPS:
            return 1e-6
        base = 1e-2 if self.dtype in ("float16", "bfloat16") else 1e-5
        return base * self.num_partitions

    def validate(self, result: torch.Tensor) -> bool:
        """This rank's result against its slice of the oracle at rtol 0 and
        ``_atol``: the whole of it for the replicated ops, its row block for
        the others. The comparison runs where the result lies (an
        ``[m, k]`` payload can be gigabytes)."""
        if result is None:
            return False
        self.runtime.synchronize()
        want = self._expected_tensor(result.device)
        if self.options["op"] not in _REPLICATED_OPS:
            rows = want.shape[0] // self.num_partitions
            want = want[self.rank * rows:(self.rank + 1) * rows]
        return _compare_here(self, result, want, self._atol())


def _compare_here(impl, result: torch.Tensor, want: torch.Tensor, atol: float) -> bool:
    """``|result - want| <= atol`` everywhere (rtol 0, NaN fails), computed
    on ``want``'s device; logs the worst error when it fails, as
    ``Primitive._compare`` does."""
    if result.shape != want.shape:
        log.warning("validation FAILED for %s rank %d: shape %s vs %s",
                    type(impl).__name__, impl.rank, tuple(result.shape), tuple(want.shape))
        return False
    err = (result.to(want.dtype) - want).abs()
    if bool((err <= atol).all()):
        return True
    log.warning("validation FAILED for %s rank %d: max|err|=%.3e > atol=%.3e",
                type(impl).__name__, impl.rank, float(err.nan_to_num(float("inf")).max()),
                atol)
    return False
