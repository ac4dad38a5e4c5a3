"""Topology-adaptive data-parallel gradient all-reduce: hierarchical and
striped.

The counterpart of the JAX package's ``dp_allreduce/jax_spmd_hier.py``:
the family's partial-gradient GEMM (``torch.matmul``, as JAX's plain
``a_shard @ b_shard``), then the all-reduce decomposed by the topology
instead of one flat ring:

- ``hierarchical``: RS over the cards of a node, AR of the 1/ici block
  across nodes, AG over the node (``Runtime.axis_groups("two_level")``),
  so the links between nodes carry 1/intra of the gradient;
- ``striped``: the gradient's rows split into one stripe per torus axis of
  a node (``Runtime.axis_groups("torus")``), each stripe's scatter/gather
  sandwich leading with a different axis
  (``collectives.pytorch_hier.striped_all_reduce``);
- ``flat``: the parent's single all-reduce; ``auto`` resolves in
  ``primitives.topo_compose`` and the row's ``composition`` column says
  what ran.

``wire_bytes()`` prices the composition's closed form over the full
``[m, n]`` gradient.
"""

from __future__ import annotations

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.collectives.pytorch_hier import striped_all_reduce
from ddlb_tpu_torch.primitives.dp_allreduce.pytorch import PyTorchDPAllReduce
from ddlb_tpu_torch.primitives.topo_compose import COMPOSITIONS, ComposedMember


class PyTorchHierDPAllReduce(ComposedMember, PyTorchDPAllReduce):
    DEFAULT_OPTIONS = {**PyTorchDPAllReduce.DEFAULT_OPTIONS, "composition": "hierarchical"}
    ALLOWED_VALUES = {
        **PyTorchDPAllReduce.ALLOWED_VALUES,
        "composition": list(COMPOSITIONS) + ["auto"],
    }

    def _collective_payloads(self):
        # every replica all-reduces the full [m, n] partial gradient
        return [("all_reduce", float(self.m * self.n * wire_itemsize(self.dtype)))]

    def _check_shapes(self) -> None:
        super()._check_shapes()
        comp = self._resolved_composition()
        if comp == "flat":
            return
        self._check_composed()
        intra, _inter = self._two_level()
        rows = intra * (self._stripe_count() if comp == "striped" else 1)
        if self.m % rows:
            raise ValueError(
                f"m={self.m} must divide into the composition's scatter "
                f"pieces ({rows}) for composition={comp!r}"
            )

    def _input_setup(self) -> None:
        comp = self._resolved_composition()
        super()._input_setup()  # the operand blocks; flat: the parent's step
        _intra, inter = self._two_level()
        if comp == "hierarchical":
            g = self.runtime.axis_groups("two_level")

            def step(a_shard, b_shard):
                part = g.reduce_scatter_rows(torch_matmul(a_shard, b_shard), "ici")
                return g.all_gather_rows(g.all_reduce(part, "dcn"), "ici")

            self._fn = step
        elif comp == "striped":
            t, axes = self.runtime.axis_groups("torus"), self._stripe_axes()

            def step(a_shard, b_shard):
                return striped_all_reduce(t, axes, torch_matmul(a_shard, b_shard), inter)

            self._fn = step
