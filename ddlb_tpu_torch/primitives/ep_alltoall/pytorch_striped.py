"""MoE dispatch and combine with the striped composition pinned.

The counterpart of the JAX package's ``ep_alltoall/jax_spmd_striped.py``:
``pytorch_hier`` with ``composition='striped'`` as its default, so a sweep
ranks the three-level per-torus-axis exchange beside flat and
hierarchical.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.ep_alltoall.pytorch_hier import PyTorchHierEPAllToAll


class PyTorchStripedEPAllToAll(PyTorchHierEPAllToAll):
    DEFAULT_OPTIONS = {
        **PyTorchHierEPAllToAll.DEFAULT_OPTIONS,
        "composition": "striped",
    }
