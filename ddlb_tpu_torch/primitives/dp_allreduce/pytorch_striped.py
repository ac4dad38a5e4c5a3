"""Data-parallel gradient all-reduce with the striped composition pinned.

The counterpart of the JAX package's ``dp_allreduce/jax_spmd_striped.py``:
``pytorch_hier`` with ``composition='striped'`` as its default, so a sweep
ranks the per-torus-axis rings beside flat and hierarchical.
"""

from __future__ import annotations

from ddlb_tpu_torch.primitives.dp_allreduce.pytorch_hier import PyTorchHierDPAllReduce


class PyTorchStripedDPAllReduce(PyTorchHierDPAllReduce):
    DEFAULT_OPTIONS = {
        **PyTorchHierDPAllReduce.DEFAULT_OPTIONS,
        "composition": "striped",
    }
