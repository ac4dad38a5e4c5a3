"""Pure collectives with the striped composition pinned.

The counterpart of the JAX package's ``collectives/jax_spmd_striped.py``:
``pytorch_hier`` with ``composition='striped'`` and ``op='all_reduce'`` as
its defaults, so a sweep ranks the per-torus-axis rings beside flat and
hierarchical (see ``pytorch_hier``).
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.collectives.pytorch_hier import PyTorchHierCollectives


class PyTorchStripedCollectives(PyTorchHierCollectives):
    DEFAULT_OPTIONS = {
        **PyTorchHierCollectives.DEFAULT_OPTIONS,
        "op": "all_reduce",
        "composition": "striped",
    }
