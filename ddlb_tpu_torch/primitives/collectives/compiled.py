"""Compiler-partitioned collectives: DTensor infers each op from the
placements, Inductor schedules it.

The counterpart of the JAX package's ``collectives/xla_gspmd.py``: no
collective is written; each op is the global computation on the payload
``[m, k]`` (row-sharded over 'tp') whose placement in and out makes
DTensor issue it:

- ``all_gather``: the identity, asked for replicated;
- ``all_reduce``: the sum over the shard-stacked axis, replicated;
- ``reduce_scatter``: the same sum, row-sharded;
- ``all_to_all``: the block transpose of the (rank, chunk) axes, sharded
  in and out;
- ``ppermute``: the global roll by one shard, sharded in and out.

The mesh is in rank order, so under a reordered ring
(``Runtime.order_ring``) the blocks are permuted around the program as
around an NCCL call: the chunks of a scatter or an all-to-all are taken
in rank order at set-up, gathered blocks come back in rank order and are
permuted into position order, and the roll becomes the gather of each
rank's block from the rank one position behind it.
What DTensor issues is the measurement, even where it is not the op's
own collective: the roll becomes an all-gather, and on gloo (no DTensor
all-to-all there) the block transpose becomes an all-gather and a chunk
(``README.md``, "PyTorch/CUDA port", lists what each op issues).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ddlb_tpu_torch.primitives.collectives.base import Collectives
from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin, local
from ddlb_tpu_torch.runtime import placements


def global_op(op: str, d: int, m: int, k: int, order=None):
    """``(fn, out)``: op ``op``'s global computation on the ``[m, k]``
    payload over ``d`` ranks and the placement its result is asked for
    (``all_to_all``'s rows as ``[d, m/d, k]``). ``order`` (position ->
    rank) reorders ``ppermute``'s ring; None is the identity."""
    if op == "all_gather":
        return (lambda a: a), Replicate()
    if op == "all_reduce":
        return (lambda a: a.reshape(d, m // d, k).sum(0)), Replicate()
    if op == "reduce_scatter":
        return (lambda a: a.reshape(d, m // d, k).sum(0)), Shard(0)
    if op == "all_to_all":
        # the swapped axes are asked for sharded on the new rank axis before
        # the chunks merge into rows (the JAX package's output sharding,
        # placed where DTensor needs it: it cannot merge a sharded inner
        # axis); the result is [d, m/d, k], each rank's block its rows
        return (lambda a: a.reshape(d, d, m // (d * d), k).transpose(0, 1)
                .redistribute(a.device_mesh, [Shard(0)]).flatten(1, 2)), Shard(0)
    if order is None or list(order) == list(range(d)):
        return (lambda a: torch.roll(a, m // d, dims=0)), Shard(0)  # ppermute
    # rank i takes the block of the rank one ring position behind it
    src = [order[(order.index(i) - 1) % d] for i in range(d)]
    return (lambda a: a.reshape(d, m // d, k)[torch.tensor(src, device=a.device)]
            .reshape(m, k)), Shard(0)


class CompiledCollectives(CompiledOptionsMixin, Collectives):
    def _input_setup(self) -> None:
        super()._input_setup()
        rt, op = self.runtime, self.options["op"]
        if op in ("reduce_scatter", "all_to_all"):
            self.a = rt.blocks_by_rank(self.a)
        mesh = rt.device_mesh(("tp",), (self.num_partitions,))
        self.a = DTensor.from_local(self.a, mesh, placements(mesh, {"tp": 0}),
                                    run_check=False)
        fn, out = global_op(op, self.num_partitions, self.m, self.k, rt.order)
        compiled = self._compile(lambda a: fn(a).redistribute(mesh, [out]), mesh)
        if op in ("all_gather", "all_to_all"):
            self._fn = lambda a: rt.blocks_by_position(local(compiled(a)).reshape(-1, self.k))
        else:
            self._fn = lambda a: local(compiled(a)).reshape(-1, self.k)
