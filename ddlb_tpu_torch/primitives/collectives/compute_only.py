"""Memory-copy roofline for the collectives family.

The counterpart of the JAX package's ``collectives/compute_only.py``: the
no-communication bound of a pure collective is a device memory copy of
the payload. ``size=sharded`` copies one rank's ``[m/d, k]`` shard,
``unsharded`` the full ``[m, k]``. The copy is a fresh tensor each call
(``torch.clone``, never an alias; the JAX member's ``x + 0``). No wire
runs (``wire_bytes() == 0``); the Throughput column (GB/s) counts the
payload bytes once (``hbm_bytes()``), though the copy reads and writes
them. Validation is exact.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.primitives.collectives.base import Collectives, wire_itemsize


class ComputeOnlyCollectives(Collectives):
    DEFAULT_OPTIONS = {"size": "sharded"}
    ALLOWED_VALUES = {"size": ["sharded", "unsharded"]}

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.m % d != 0:
            raise ValueError(f"m={self.m} must be divisible by partitions={d}")

    def _rows(self) -> int:
        sharded = self.options["size"] == "sharded"
        return self.m // self.num_partitions if sharded else self.m

    def _input_setup(self) -> None:
        self.a = self._place(self._payload()[: self._rows()])
        self._fn = torch.clone

    def wire_bytes(self) -> float:
        return 0.0

    def hbm_bytes(self) -> float:
        """Payload bytes of the measured copy: the numerator of this
        member's GB/s."""
        return float(self._rows() * self.k * wire_itemsize(self.dtype))

    def flops(self) -> float:
        return 1000.0 * self.hbm_bytes()

    def validate(self, result: torch.Tensor) -> bool:
        if result is None:
            return False
        self.runtime.synchronize()
        return bool(
            result.data_ptr() != self.a.data_ptr() and torch.equal(result, self.a)
        )
