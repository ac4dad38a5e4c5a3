"""The distributed training step over a ``(dp, tp, pp)`` mesh of ranks.

The counterpart of the JAX package's ``transformer_step/spmd.py``: each
rank holds its stage, its tp share of the heads and its expert
(``models.transformer.shard_params``) and its dp rows of the tokens, and
one measured call is the model's training step (``make_train_step``:
forward, backward, AdamW) or, with ``mode='forward'``, the loss alone.
The step is functional: it returns new parameters and optimizer state and
leaves its operands as they are, so the runner re-runs the same step on
the same operands. ``schedule`` keeps the JAX package's values; only
``gpipe`` is ported.
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.models.transformer import (
    make_loss_fn,
    make_train_step,
    place_params,
    shard_params,
)
from ddlb_tpu_torch.primitives.transformer_step.base import TransformerStep, not_ported


class SPMDTransformerStep(TransformerStep):
    DEFAULT_OPTIONS = {"schedule": "gpipe", "virtual": 1}
    ALLOWED_VALUES = {
        "schedule": ["gpipe", "1f1b", "interleaved"],
        "virtual": (1, 8),
    }

    def _check_shapes(self) -> None:
        super()._check_shapes()
        o = self.options
        if o["schedule"] != "gpipe" and o["mode"] != "train":
            raise ValueError(
                f"schedule='{o['schedule']}' is a training schedule; "
                f"mode='forward' has no backward to interleave"
            )
        if o["virtual"] != 1 and o["mode"] != "train":
            raise ValueError("virtual > 1 requires mode='train'")
        if o["schedule"] == "interleaved" and o["virtual"] < 2:
            raise ValueError("schedule='interleaved' needs virtual >= 2")
        if o["schedule"] == "1f1b" and o["virtual"] != 1:
            raise ValueError("1f1b is the virtual=1 schedule; use 'interleaved'")
        if o["schedule"] != "gpipe":
            raise not_ported(f"schedule='{o['schedule']}' (models/pipeline.py)")
        if o["virtual"] != 1:
            raise not_ported("virtual > 1 (models/pipeline.py)")

    def _input_setup(self) -> None:
        cfg = self._model_config()
        dp, tp, pp = self._mesh_factors()
        self.mesh = self.runtime.mesh(dp, tp, pp)
        self.num_partitions = dp * tp * pp
        params = place_params(
            shard_params(self._host_params(), cfg, tp, self.mesh.tp_rank, pp,
                         self.mesh.pp_rank),
            self.device,
        )
        rows = self.options["batch"] // dp
        mine = slice(self.mesh.dp_rank * rows, (self.mesh.dp_rank + 1) * rows)
        tokens, targets = (torch.from_numpy(x[mine].copy()).to(self.device)
                           for x in self._host_tokens())
        if self.options["mode"] == "train":
            step, init_opt = make_train_step(self.mesh, cfg)
            self._fn = step
            self._args = (params, init_opt(params), tokens, targets)
        else:
            self._fn = make_loss_fn(self.mesh, cfg)
            self._args = (params, tokens, targets)
        self.runtime.synchronize()
