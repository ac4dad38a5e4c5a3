"""Compiler-partitioned training step: the oracle's single program on
DTensors, compiled.

The counterpart of the JAX package's ``transformer_step/xla_gspmd.py``:
the same model math as the single-device oracle
(``models.transformer.reference_loss``: einsum attention, every router)
runs on DTensor parameters over a ``(dp, tp, pp)`` device mesh,
placed as ``param_specs`` places them (``param_placements``), with the
tokens sharded over dp. DTensor's sharding propagation picks every
collective (an expert picked out of the tp-sharded stack, a stage out of
the pp-sharded one, is gathered first) and Inductor schedules them. The
schema carries the compiler knobs of ``compile_options``.

``mode='train'`` compiles the loss forward (AOTAutograd compiles its
backward), takes the gradient outside the graph (Dynamo does not trace
``autograd.grad`` under ``fullgraph``), and runs the port's
``adamw_update`` as a second compiled graph. The step is functional, as
the ``spmd`` member's is. ``attn_kernel`` defaults to ``einsum`` and
``flash`` raises, as in the JAX member. The int8 MLP
(``mlp_kernel='int8'``, and ``'int8_weights'`` with ``mode='forward'``)
runs K7 through its ``torch.library`` operators
(``ops.quantized_matmul``), which the graph holds as opaque nodes: on the
card each call of the compiled step launches K7 and counts it.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ddlb_tpu_torch.models.transformer import (
    adamw_init,
    adamw_update,
    dtensor_params,
    param_placements,
    reference_loss,
)
from ddlb_tpu_torch.primitives.compile_options import CompiledOptionsMixin, local
from ddlb_tpu_torch.primitives.transformer_step.base import TransformerStep
from ddlb_tpu_torch.runtime import placements


class CompiledTransformerStep(CompiledOptionsMixin, TransformerStep):
    # this member measures the oracle's einsum formulation: its default
    # records einsum, and an explicit flash request raises
    DEFAULT_OPTIONS = {**CompiledOptionsMixin.DEFAULT_OPTIONS, "attn_kernel": "einsum"}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        if self.options["attn_kernel"] == "flash":
            raise ValueError(
                "compiled measures the einsum (reference_loss) formulation; "
                "attn_kernel='flash' applies to the spmd member"
            )

    def _input_setup(self) -> None:
        cfg = self._model_config()
        dp, tp, pp = self._mesh_factors()
        mesh = self.runtime.device_mesh(("dp", "tp", "pp"), (dp, tp, pp))
        self.num_partitions = dp * tp * pp
        params = dtensor_params(self._host_params(), cfg, mesh, self.device)
        rows = self.options["batch"] // dp
        at = self.rank // (tp * pp) * rows  # this rank's dp block of the batch
        data = placements(mesh, {"dp": 0})
        tokens, targets = (
            DTensor.from_local(torch.from_numpy(x[at:at + rows].copy()).to(self.device),
                               mesh, data, run_check=False)
            for x in self._host_tokens()
        )
        whole = placements(mesh, {})

        def fwd(p, tok, tgt):
            # replicated, so every rank's local loss is the loss
            return reference_loss(p, tok, tgt, cfg, tp=tp, dp=dp).redistribute(mesh, whole)

        loss_fn = self._compile(fwd, mesh)
        if self.options["mode"] == "train":
            where = param_placements(cfg, mesh)

            def adamw(p, grads, opt_state):
                # each gradient in its parameter's placement (as JAX's
                # gradients take their parameters' shardings), so the new
                # parameters and moments keep them
                grads = {name: g.redistribute(mesh, where[name]) for name, g in grads.items()}
                return adamw_update(p, grads, opt_state)

            update = self._compile(adamw, mesh)

            def step(p, opt_state, tok, tgt):
                leaves = {name: t.detach().requires_grad_(True) for name, t in p.items()}
                with torch.enable_grad():
                    loss = loss_fn(leaves, tok, tgt)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                new_p, opt_state = update(p, dict(zip(leaves, grads)), opt_state)
                return local((new_p, opt_state, loss.detach()))

            self._fn = step
            self._args = (params, adamw_init(params), tokens, targets)
        else:
            self._fn = lambda p, tok, tgt: local(loss_fn(p, tok, tgt))
            self._args = (params, tokens, targets)
        self.runtime.synchronize()
