"""Compute-only roofline for GEMM+RS (no communication); the k-sharded
logic is shared in ``primitives.base.ComputeOnlyKSharded``."""

from __future__ import annotations

from ddlb_tpu_torch.primitives.base import ComputeOnlyKSharded
from ddlb_tpu_torch.primitives.tp_rowwise.base import TPRowwise


class ComputeOnlyTPRowwise(ComputeOnlyKSharded, TPRowwise):
    pass
