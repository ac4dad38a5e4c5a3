"""Single-device roofline of the flagship step: the oracle with no
collective.

The counterpart of the JAX package's ``transformer_step/compute_only``:
the single-device formulation ``models.transformer.reference_loss`` runs
unsharded on the rank's device (every stage, head and expert, einsum
attention), forward only or with its gradient and the AdamW update for
``mode='train'``, bounding what the distributed step could do if every
collective were free.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.models.transformer import (
    adamw_init,
    adamw_update,
    place_params,
    reference_loss,
)
from ddlb_tpu_torch.primitives.transformer_step.base import TransformerStep


class ComputeOnlyTransformerStep(TransformerStep):
    #: no collective runs: the cost model drops the comm term
    COST_SCHEDULE = "compute_only"

    # the roofline runs the oracle's einsum formulation
    DEFAULT_OPTIONS = {"attn_kernel": "einsum"}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        if self.options["attn_kernel"] == "flash":
            raise ValueError(
                "compute_only measures the einsum (reference_loss) "
                "formulation; attn_kernel='flash' applies to the spmd member"
            )

    def _input_setup(self) -> None:
        cfg = self._model_config()
        dp, tp, _ = self._mesh_factors()
        params = place_params(self._host_params(), self.device)
        tokens, targets = (torch.from_numpy(x).to(self.device)
                           for x in self._host_tokens())

        def loss_fn(p, tok, tgt):
            return reference_loss(p, tok, tgt, cfg, tp=tp, dp=dp)

        if self.options["mode"] == "train":
            def step(p, opt_state, tok, tgt):
                leaves = {name: t.detach().requires_grad_(True) for name, t in p.items()}
                with torch.enable_grad():
                    loss = loss_fn(leaves, tok, tgt)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                new_p, opt_state = adamw_update(p, dict(zip(leaves, grads)), opt_state)
                return new_p, opt_state, loss.detach()

            self._fn = step
            self._args = (params, adamw_init(params), tokens, targets)
        else:
            self._fn = lambda p, tok, tgt: loss_fn(p, tok, tgt)
            self._args = (params, tokens, targets)
        self.runtime.synchronize()
