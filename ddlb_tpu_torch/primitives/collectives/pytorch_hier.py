"""Topology-adaptive collectives: the two-level and striped compositions.

The counterpart of the JAX package's ``collectives/jax_spmd_hier.py``.
Each op splits into phases over the world's two-level view
(``Runtime.axis_groups("two_level")``: ``dcn``, the nodes, and ``ici``,
the cards of a node), the phases ``perfmodel.cost.hierarchical_phases``
prices:

- ``all_reduce``: RS-ici, AR-dcn on 1/ici of the payload, AG-ici;
- ``all_gather``: AG-dcn, AG-ici, then a block reorder (the two gathers
  leave (ici, dcn)-major blocks; the global array is (dcn, ici)-major);
- ``reduce_scatter``: a chunk pre-permute, RS-ici, RS-dcn, so chunk
  ``s*ici + j`` lands on card ``j`` of node ``s``;
- ``all_to_all``: A2A-dcn, a transpose, A2A-ici (to the node, then to the
  card), and a transpose back to source order.

``composition`` picks the decomposition: ``flat`` is the parent's one
ring (its ``strategy`` applies), ``hierarchical`` the phases above,
``striped`` (``pytorch_striped`` pins it) the all-reduce split into one
stripe per torus axis of a node with more than one card
(``Runtime.axis_groups("torus")``), each stripe's scatter/gather sandwich
leading with a different axis; ``auto`` resolves in
``primitives.topo_compose``. The resolved choice is the row's
``composition`` column. The phases are ``torch.distributed`` calls on
the view's groups (NCCL on the card), issued one after another; on one
node the ``dcn`` axis has one member and its phases are skipped.
``wire_bytes()`` is the composition's closed form.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.collectives.pytorch import PyTorchCollectives
from ddlb_tpu_torch.primitives.topo_compose import COMPOSITIONS, ComposedMember

#: ops the two-level decomposition covers (a ppermute is one hop)
_DECOMPOSABLE_OPS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")


def owned(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x``, copied when it shares memory with ``src``: the in-place sum
    must not write into a member's operand."""
    if x.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        return x.clone()
    return x


def striped_all_reduce(t, axes, x: torch.Tensor, inter: int) -> torch.Tensor:
    """The striped all-reduce of ``x``'s rows on the torus view ``t``: one
    stripe a torus axis of ``axes``, stripe ``w`` reduce-scattering over the
    axes rotated by ``w``, summing over ``dcn`` across nodes, and gathering
    back in the mirrored order, so its rows come back in order; every
    stripe is whole on every rank, and their rows stack into the sum."""
    stripes = len(axes)
    piece = x.shape[0] // stripes
    outs = []
    for w in range(stripes):
        part = x[w * piece:(w + 1) * piece]
        order = axes[w:] + axes[:w]
        for ax in order:
            part = t.reduce_scatter_rows(part, ax)
        if inter > 1:
            part = t.all_reduce(owned(part, x), "dcn")
        for ax in reversed(order):
            part = t.all_gather_rows(part, ax)
        outs.append(part)
    return outs[0] if stripes == 1 else torch.cat(outs)


class PyTorchHierCollectives(ComposedMember, PyTorchCollectives):
    DEFAULT_OPTIONS = {**PyTorchCollectives.DEFAULT_OPTIONS, "composition": "hierarchical"}
    ALLOWED_VALUES = {
        **PyTorchCollectives.ALLOWED_VALUES,
        "composition": list(COMPOSITIONS) + ["auto"],
    }

    def _collective_payloads(self):
        shard = (self.m // self.num_partitions) * self.k * wire_itemsize(self.dtype)
        return [(self.options["op"], float(shard))]

    def _check_shapes(self) -> None:
        super()._check_shapes()
        comp = self._resolved_composition()
        if comp == "flat":
            return
        op = self.options["op"]
        if op not in _DECOMPOSABLE_OPS:
            raise ValueError(
                f"composition={comp!r} decomposes {_DECOMPOSABLE_OPS}; "
                f"op={op!r} is a single hop"
            )
        self._check_composed()
        if comp == "striped":
            if op != "all_reduce":
                raise ValueError(
                    "composition='striped' stripes all_reduce only (the "
                    "scatter/gather sandwich splits exactly); use "
                    "hierarchical for the other shapes"
                )
            intra, _inter = self._two_level()
            stripes = self._stripe_count()
            shard_m = self.m // self.num_partitions
            if shard_m % (stripes * intra):
                raise ValueError(
                    f"m={self.m}: the per-rank shard ({shard_m} rows) must "
                    f"divide into {stripes} stripes x {intra} in-node "
                    f"scatter pieces"
                )

    def _input_setup(self) -> None:
        comp = self._resolved_composition()
        super()._input_setup()  # the payload's row block; flat: the parent's step
        if comp == "striped":
            t, axes = self.runtime.axis_groups("torus"), self._stripe_axes()
            _intra, inter = self._two_level()
            self._fn = lambda a_shard: striped_all_reduce(t, axes, a_shard, inter)
        elif comp == "hierarchical":
            self._fn = self._hier_step()

    def _hier_step(self):
        """The op's phases on the two-level view. The rank of card ``j`` of
        node ``s`` holds row block ``s*ici + j``, and each op leaves its
        blocks where the flat op's global result puts them."""
        g = self.runtime.axis_groups("two_level")
        op, k = self.options["op"], self.k
        intra, inter = self._two_level()
        shard_m = self.m // self.num_partitions
        q = shard_m // self.num_partitions

        if op == "all_reduce":
            def step(a_shard):
                part = g.reduce_scatter_rows(a_shard, "ici")
                part = g.all_reduce(owned(part, a_shard), "dcn")
                return g.all_gather_rows(part, "ici")
        elif op == "all_gather":
            def step(a_shard):
                x = g.all_gather_rows(g.all_gather_rows(a_shard, "dcn"), "ici")
                # (ici, dcn)-major blocks -> the (dcn, ici)-major global array
                return x.reshape(intra, inter, shard_m, k).transpose(0, 1).reshape(self.m, k)
        elif op == "reduce_scatter":
            def step(a_shard):
                # RS-ici piece j, then RS-dcn piece s, leave chunk s*ici + j
                x = a_shard.reshape(inter, intra, q, k).transpose(0, 1).reshape(shard_m, k)
                return g.reduce_scatter_rows(g.reduce_scatter_rows(x, "ici"), "dcn")
        else:  # all_to_all: chunks in destination order, (node, card)-major
            def step(a_shard):
                x = g.all_to_all_rows(a_shard.reshape(inter, intra, q, k), "dcn")
                x = g.all_to_all_rows(x.transpose(0, 1).contiguous(), "ici")
                return x.transpose(0, 1).reshape(shard_m, k)
        return step
