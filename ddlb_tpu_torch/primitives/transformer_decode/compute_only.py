"""Single-device serving roofline: the same step with no collective.

The counterpart of the JAX package's ``transformer_decode/compute_only``:
the identical cache path on a ``(1, 1)`` mesh local to the rank (the whole
batch, every head and the one expert), bounding what the sharded step
could do if every collective were free.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.transformer_decode.spmd import SPMDTransformerDecode


class ComputeOnlyTransformerDecode(SPMDTransformerDecode):
    def _mesh_factors(self):
        if self.options["dp"] or self.options["tp"]:
            raise ValueError(
                "compute_only ignores dp/tp: it always runs the 1x1 mesh"
            )
        return 1, 1
