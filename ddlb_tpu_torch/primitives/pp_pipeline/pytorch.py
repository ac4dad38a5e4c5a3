"""GPipe-schedule chain over explicit ring hops.

The counterpart of the JAX package's ``pp_pipeline/jax_spmd.py``: the
forward schedule written out by hand, one hop to the next rank a tick
(``Runtime.ring_shift``, one ``batch_isend_irecv``). Stage 0 injects
microbatch ``t`` at tick ``t``; stage ``p`` runs microbatch ``t - p`` at
tick ``t`` (``x_in @ w``, in the row's dtype with float32 sums) and hands
the result on, so the GPipe bubble of ``mb + d - 1`` ticks for ``mb``
microbatches shows in the wall clock. A stage that holds no microbatch
computes nothing that tick but still posts its hops (zeros): every rank
posts the same hops in the same order.

The output reaches every rank over a drain ring: each microbatch born at
the last stage (rank ``d - 1``) starts round the ring behind the
activations, so all but its last ``d - 2`` hops hide under the pipeline;
``ticks = max(mb + d - 1, mb + 2d - 3)``. Both rings carry the row's
dtype, as the JAX member's wires do (its float32 on-chip state was a
compile workaround of XLA on the CPU, and the values it holds are rounded
to the dtype anyway).
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import torch_matmul
from ddlb_tpu_torch.primitives.pp_pipeline.base import PPPipeline


class PyTorchPPPipeline(PPPipeline):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"microbatches": 4}
    ALLOWED_VALUES = {"microbatches": (1, None)}

    def wire_bytes(self) -> float:
        """The hops the step posts (the JAX member's census, :43): every
        rank posts both rings every tick they are wired for, zeros
        included. The drain ring moves ``[rows, n]`` on all ``ticks``
        ticks, the activation ring ``[rows, k]`` on the ``mb + d - 2``
        fill ticks."""
        d = self.num_partitions
        if d <= 1:
            return 0.0
        mb = self.options["microbatches"]
        rows = self.m // mb
        isz = wire_itemsize(self.dtype)
        ticks = max(mb + d - 1, mb + 2 * d - 3)
        drain = ticks * rows * self.n * isz
        activations = (mb + d - 2) * rows * self.k * isz
        return float(drain + activations)

    def _check_shapes(self) -> None:
        super()._check_shapes()
        mb = self.options["microbatches"]
        if self.m % mb != 0:
            raise ValueError(f"m={self.m} must be divisible by microbatches={mb}")

    def _input_setup(self) -> None:
        super()._input_setup()
        d, rank, runtime = self.num_partitions, self.rank, self.runtime
        mb = self.options["microbatches"]
        rows, n = self.m // mb, self.n
        fill = mb + d - 1                       # ticks of the pipeline phase
        ticks = max(fill, mb + 2 * d - 3)       # the drain's last hops
        src = d - 1                             # outputs are born there
        hops = (rank - src) % d                 # this rank's distance from it

        def step(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            coll = torch.empty((mb, rows, n), dtype=a.dtype, device=a.device)
            zeros = torch.zeros((rows, n), dtype=a.dtype, device=a.device)
            buf = obuf = zeros  # the activation from the left; the output in transit
            for t in range(ticks):
                y = None
                if rank <= t < rank + mb:
                    x_in = a[t * rows:(t + 1) * rows] if rank == 0 else buf
                    y = torch_matmul(x_in, w)
                if rank == src:
                    # the source starts each finished microbatch round the
                    # ring and forwards nothing else (a wrapped chunk would
                    # alias a later microbatch at the receivers)
                    send_o = zeros if y is None else y
                    if y is not None:
                        coll[t - src] = y
                else:
                    send_o = obuf
                if d == 1:
                    continue
                sends = (send_o,) + ((zeros if y is None else y,) if t + 1 < fill else ())
                received, handles = runtime.ring_shift(*sends)
                for h in handles:
                    h.wait()
                obuf = received[0]
                if t + 1 < fill:
                    buf = received[1]
                # the chunk the source sent at tick T carries microbatch
                # T - (d-1) and reaches distance h at the end of tick T+h-1
                arrived = t - d + 2 - hops
                if rank != src and 0 <= arrived < mb:
                    coll[arrived] = obuf
            return coll.reshape(self.m, n)

        self._fn = step
