"""The Megatron-style tensor-parallel MLP block.

The port of the JAX package's ``models/tp_mlp.py``: the sequence-parallel
transformer MLP, whose up-projection is the ``tp_columnwise`` pattern
(all-gather the sequence-sharded activations, GEMM against a
column-sharded weight) and whose down-projection is the ``tp_rowwise``
pattern (GEMM against a row-sharded weight, reduce-scatter back to the
sequence shards).

- ``init_params``, ``mlp_forward`` (the single-device reference) and
  ``example_batch``, on the same numpy draws as the JAX package;
- ``mlp_block``: the explicit per-rank block on the runtime's mesh
  (``Mesh.tp_all_gather`` -> GEMM -> gelu -> GEMM ->
  ``Mesh.tp_reduce_scatter``), the JAX package's ``shard_map`` body;
- ``make_train_step``: the training step over a ``(dp, tp)`` mesh on
  DTensors (the JAX package's GSPMD form): the batch over dp, the
  sequence over tp outside the products, ``w1`` column-sharded and ``w2``
  row-sharded; DTensor's sharding propagation picks the all-gather,
  reduce-scatter and gradient reductions, and plain SGD updates the
  weights.

The products are ``torch.matmul`` (the JAX module has no Pallas kernel).
The gelu is the tanh form, JAX's default.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddlb_tpu_torch.ops.accum import float32_product
from ddlb_tpu_torch.runtime import placements


def init_params(d_model: int, d_ff: int, dtype=torch.bfloat16,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded host parameters ``{"w1": [d_model, d_ff], "w2": [d_ff,
    d_model]}`` (CPU tensors in ``dtype``): the JAX package's draws, bit for
    bit in float32 (a half dtype rounds the float64 draw to float32 first)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return torch.from_numpy(rng.normal(0.0, scale, shape).astype(np.float32)).to(dtype)

    return {"w1": normal((d_model, d_ff), (2.0 / d_model) ** 0.5),
            "w2": normal((d_ff, d_model), (2.0 / d_ff) ** 0.5)}


def mlp_forward(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Single-device reference forward ``gelu(x @ w1) @ w2``, each product
    summed in float32 and rounded to ``x.dtype``."""
    h = F.gelu(float32_product(x, w1).to(x.dtype), approximate="tanh")
    return float32_product(h, w2).to(x.dtype)


def mlp_block(mesh):
    """The sequence-parallel MLP on this rank of ``mesh`` (``Runtime.mesh``):
    ``block(x_local [s/tp, D], w1_local [D, F/tp], w2_local [F/tp, D]) ->
    y_local [s/tp, D]``: the sequence all-gathered over tp, the rank's
    columns of the hidden layer, its partial output summed over tp in
    float32 and scattered back by rows, then rounded to ``x.dtype``."""

    def block(x_local, w1_local, w2_local):
        x_full = mesh.tp_all_gather(x_local, 0)
        h = F.gelu(float32_product(x_full, w1_local).to(x_local.dtype), approximate="tanh")
        y = mesh.tp_reduce_scatter(float32_product(h, w2_local), 0)
        return y.to(x_local.dtype)

    return block


def make_train_step(mesh, learning_rate: float = 1e-3):
    """The training step over ``mesh`` (``Runtime.device_mesh`` over 'dp'
    and 'tp'): ``(train_step, init_opt_state, (x, w1, w2 placements))``.

    ``train_step(params, opt_state, x, target) -> (params, opt_state,
    loss)`` takes ``params`` as DTensors placed as returned (``w1``
    columns and ``w2`` rows over tp), ``x [B, S, D]`` and ``target`` (float32)
    with the batch over dp and the sequence over tp; the loss is the mean
    squared error of the output, kept sequence-sharded, against the target.
    The update is ``optax.sgd``'s, ``p - learning_rate * g``, each new weight
    in the placement of the weight it replaces, and the step is
    functional: the parameters given are left as they are. SGD has no
    state: ``init_opt_state`` gives an empty dict."""
    x_pl = placements(mesh, {"dp": 0, "tp": 1})
    w1_pl = placements(mesh, {"tp": 1})
    w2_pl = placements(mesh, {"tp": 0})

    def loss_fn(params, x, target):
        h = F.gelu(torch.matmul(x, params["w1"]), approximate="tanh")
        out = torch.matmul(h, params["w2"]).redistribute(mesh, x_pl)
        return torch.mean(torch.square(out.float() - target))

    def train_step(params, opt_state, x, target):
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, x, target)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        # each gradient in its weight's placement (a sum over dp where the
        # batch is sharded), so the new weights keep the placements
        new = {name: (p + g.redistribute(mesh, p.placements) * -learning_rate).to(p.dtype)
               for (name, p), g in zip(params.items(), grads)}
        return new, opt_state, loss.detach()

    def init_opt_state(params):
        return {}

    return train_step, init_opt_state, (x_pl, w1_pl, w2_pl)


def example_batch(batch: int, seq: int, d_model: int, dtype=torch.bfloat16,
                  seed: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded activations ``x [batch, seq, d_model]`` in ``dtype`` and a
    float32 target of the same shape, the JAX package's draws."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, seq, d_model)).astype(np.float32)
    t = rng.normal(0, 1, (batch, seq, d_model)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(t)
