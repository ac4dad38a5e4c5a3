"""Topology-adaptive MoE dispatch and combine: hierarchical and striped
all-to-alls.

The counterpart of the JAX package's ``ep_alltoall/jax_spmd_hier.py``: the
family's two exchanges decomposed by the topology instead of one flat
all-to-all, around the resident expert's GEMM (``torch.matmul``, as JAX's
``jnp.matmul``):

- ``hierarchical``: each exchange is an A2A across nodes, then one inside
  the node (``Runtime.axis_groups("two_level")``): a token group goes to
  its node, then to its card, with a transpose between that brings the
  next level's index to the front and one after that restores source
  order;
- ``striped``: the exchange takes three levels, across nodes and then each
  torus axis of a node on its own (``Runtime.axis_groups("torus")``), and
  the token groups split into one stripe per torus axis with more than
  one card, each stripe running dispatch, expert GEMM and combine end to
  end (the GEMM is per token, so the stripes are independent);
- ``flat``: the parent's exchanges; ``auto`` resolves in
  ``primitives.topo_compose`` and the row's ``composition`` column says
  what ran.

``wire_bytes()`` prices the dispatch (``[m/d, k]``) and the combine
(``[m/d, n]``) through the composition's closed form.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.ep_alltoall.pytorch import PyTorchEPAllToAll
from ddlb_tpu_torch.primitives.topo_compose import COMPOSITIONS, ComposedMember


class PyTorchHierEPAllToAll(ComposedMember, PyTorchEPAllToAll):
    DEFAULT_OPTIONS = {**PyTorchEPAllToAll.DEFAULT_OPTIONS, "composition": "hierarchical"}
    ALLOWED_VALUES = {
        **PyTorchEPAllToAll.ALLOWED_VALUES,
        "composition": list(COMPOSITIONS) + ["auto"],
    }

    def _collective_payloads(self):
        isz, shard = wire_itemsize(self.dtype), self.m // self.num_partitions
        return [
            ("all_to_all", float(shard * self.k * isz)),  # dispatch
            ("all_to_all", float(shard * self.n * isz)),  # combine
        ]

    def _check_shapes(self) -> None:
        super()._check_shapes()
        comp = self._resolved_composition()
        if comp == "flat":
            return
        self._check_composed()
        if comp == "striped" and self.group_tokens % self._stripe_count():
            raise ValueError(
                f"m={self.m}: {self.group_tokens} tokens per routing group "
                f"must divide into {self._stripe_count()} stripes"
            )

    def _input_setup(self) -> None:
        comp = self._resolved_composition()
        super()._input_setup()  # tokens and expert; flat: the parent's step
        if comp == "hierarchical":
            self._fn = self._hier_step()
        elif comp == "striped":
            self._fn = self._striped_step()

    def _hier_step(self):
        """Token groups are in destination order and rank = node * ici +
        card, so the ``[d, g]`` group axis reshapes to ``[dcn, ici, g]``;
        each all-to-all routes one level."""
        g = self.runtime.axis_groups("two_level")
        d, gt, k, n = self.num_partitions, self.group_tokens, self.k, self.n
        intra, inter = self._two_level()

        def exchange(x):
            # [inter, intra, g, f] in destination order -> source order
            x = g.all_to_all_rows(x, "dcn")
            x = g.all_to_all_rows(x.transpose(0, 1).contiguous(), "ici")
            return x.transpose(0, 1)

        def step(a_loc, w_loc):
            x = exchange(a_loc.reshape(inter, intra, gt, k))
            y = torch_matmul(x.reshape(d * gt, k), w_loc).reshape(inter, intra, gt, n)
            return exchange(y).reshape(d * gt, n)

        return step

    def _striped_step(self):
        """Rank = node * sx * sy + u * sy + v, so the group axis reshapes to
        ``[dcn, sx, sy, g]``; each all-to-all routes one level, bringing its
        destination index to the front first, and the last permute restores
        rank order. The stripes split ``g``."""
        t = self.runtime.axis_groups("torus")
        d, gt, k, n = self.num_partitions, self.group_tokens, self.k, self.n
        sx, sy = self._torus()
        _intra, inter = self._two_level()
        stripes = self._stripe_count()
        gs = gt // stripes

        def exchange(x):
            # [inter, sx, sy, gs, f] in destination order -> source order
            x = t.all_to_all_rows(x, "dcn")
            x = t.all_to_all_rows(x.transpose(0, 1).contiguous(), "sx")
            x = t.all_to_all_rows(x.permute(2, 1, 0, 3, 4).contiguous(), "sy")
            # [sy(src), dcn(src), sx(src)] -> rank order [dcn, sx, sy]
            return x.permute(1, 2, 0, 3, 4)

        def step(a_loc, w_loc):
            tok = a_loc.reshape(d, gt, k)
            outs = []
            for w in range(stripes):
                sub = tok[:, w * gs:(w + 1) * gs].reshape(inter, sx, sy, gs, k)
                x = exchange(sub)
                y = torch_matmul(x.reshape(d * gs, k), w_loc)
                outs.append(exchange(y.reshape(inter, sx, sy, gs, n)).reshape(d, gs, n))
            full = outs[0] if stripes == 1 else torch.cat(outs, dim=1)
            return full.reshape(d * gt, n)

        return step
