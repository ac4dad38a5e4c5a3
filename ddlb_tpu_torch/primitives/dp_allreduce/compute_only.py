"""Compute-only roofline for GEMM+AR (no communication); the k-sharded
logic is shared in ``primitives.base.ComputeOnlyKSharded``."""

from __future__ import annotations

from ddlb_tpu_torch.primitives.base import ComputeOnlyKSharded
from ddlb_tpu_torch.primitives.dp_allreduce.base import DPAllReduce


class ComputeOnlyDPAllReduce(ComputeOnlyKSharded, DPAllReduce):
    pass
