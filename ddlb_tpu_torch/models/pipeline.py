"""1F1B and interleaved pipeline training for the flagship model.

The port of the JAX package's ``models/pipeline.py``. The GPipe step
(``models.transformer._gpipe``) runs every forward tick, then the same
ticks backwards, so every microbatch's stage input and last-stage tail
stay alive across the flush. This module runs a tabulated schedule
instead (``utils/pipeline_schedule.py``, the tables the ``pp_pipeline``
``schedules`` member executes): forward and backward ticks interleave as
the tables of the rank's pp coordinate say, and each (microbatch, chunk)
is taken back through by hand:

- a forward tick runs ``stage_fn`` under ``torch.no_grad()`` and stashes
  only its detached input in the slot the table names, so the stash holds
  no graph and is O(pipeline depth), not O(microbatches): the reason 1F1B
  exists. The last global stage also takes the tail's loss (``ln_f``, the
  head, the cross-entropy), again without a graph;
- a backward tick recomputes ``stage_fn`` on the stashed input with grad
  enabled (the JAX package's rematerialising ``jax.vjp``) and calls
  ``torch.autograd.grad`` seeded at the last stage by the tail's own
  backward (cotangent ``1 / (microbatches * dp * tp)``, with the gradients
  of ``ln_f`` and the head) and elsewhere by the cotangent that hopped in.
  The chunk's gradients add into float32 accumulators at its row; at
  global stage 0 the input's gradient is scatter-added into ``embed`` at
  the token ids.

The hops run where something lands next tick, activations to the next
pp rank and cotangents back, both in one ``batch_isend_irecv`` a tick
(``Mesh.exchange``), decided from the tables alone; the
tp collectives inside ``stage_fn`` stay matched because every rank of a
tp group shares its pp coordinate and so its row of the tables. At the
end each gradient is summed over every mesh axis that does not shard its
leaf, as ``_gpipe`` does, and cast to the leaf's dtype.

With ``virtual`` chunks a rank the chain is ``pp * virtual`` stages deep
and rank ``p``'s chunk ``c`` is global stage ``c * pp + p``: the stage
stack is laid out device-major first (``arrange_stage_stack``).

Under ``router='topk'`` each forward tick's stage aux loss is summed, and
the loss adds ``router_aux`` times its mean over (microbatches, the
``pp * virtual`` global stages, dp, tp); each backward tick seeds its
recomputed aux with that mean's weight, ``router_aux / (microbatches *
pp * virtual * dp * tp)`` (JAX :183-188, :298, :353-356).
"""

from __future__ import annotations

import torch

from ddlb_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    _check_step_shapes,
    adamw_init,
    adamw_update,
    make_stage_fn,
    param_axes,
    param_names,
    tail_loss,
)
from ddlb_tpu_torch.utils.pipeline_schedule import (
    KIND_BWD,
    KIND_FWD,
    TABLES,
    build_schedule,
    hops_due,
)


def arrange_stage_stack(params, pp: int, virtual: int, cfg: TransformerConfig = None):
    """A stage-ordered parameter stack (leading axis ``pp * virtual``, row
    ``s`` global stage ``s``) in the device-major layout the sharded step
    takes: row ``p * virtual + c`` holds global stage ``c * pp + p``, so
    rank ``p``'s block of the stack is its chunks (JAX :63). Tensors or
    numpy arrays; the oracle keeps the stage order.

    Leaves are classified by their axes (``param_axes``: a leaf with a pp
    axis is stage-stacked), never by shape, and a leaf the table does not
    know raises: it would otherwise be left in place with no error.
    Without ``cfg`` every leaf of every configuration counts as known."""
    if cfg is None:
        known = set(param_names(TransformerConfig(mlp_kernel="int8_weights", router="topk")))
        known |= set(param_names(TransformerConfig(n_heads=2, n_kv_heads=1)))
    else:
        known = set(param_names(cfg))
    unknown = set(params) - known
    if unknown:
        raise ValueError(
            f"param leaves missing from the spec table: {sorted(unknown)} "
            f"(pass the matching cfg, or extend param_specs)"
        )
    axes = param_axes(cfg or TransformerConfig(), params)
    idx = [c * pp + p for p in range(pp) for c in range(virtual)]
    return {name: x[idx] if "pp" in axes[name] else x for name, x in params.items()}


def make_loss_and_grads_1f1b(mesh, cfg: TransformerConfig, schedule: str = "1f1b",
                             virtual: int = 1):
    """``fn(params, tokens, targets) -> (loss, grads)`` running the tabulated
    schedule (``1f1b``, or ``interleaved`` with ``virtual`` chunks a rank;
    ``gpipe`` with ``virtual > 1`` runs here too) over the ``(dp, tp, pp)``
    mesh (JAX :114). ``params`` is this rank's slice (``shard_params`` of a
    stack ``pp * virtual`` deep, arranged by ``arrange_stage_stack``), the
    tokens its dp rows; the loss is the global one, ``grads`` the gradient
    of it for this rank's leaves, each in its leaf's dtype. No ``.grad`` is
    written and the parameters are left as they are."""
    if cfg.mlp_kernel == "int8_weights":
        raise ValueError(
            "1F1B is a training schedule and mlp_kernel='int8_weights' is "
            "the forward-only serving form; train with mlp_kernel='int8' "
            "(STE) instead"
        )
    stage_fn = make_stage_fn(cfg, mesh)
    tables = build_schedule(schedule, mesh.pp, cfg.microbatches, virtual)
    p_pp, last = mesh.pp_rank, tables.n_stages - 1
    row = {name: getattr(tables, name)[:, p_pp].tolist() for name in TABLES}
    fwd_due, bwd_due = hops_due(tables.fwd_land), hops_due(tables.bwd_land)
    topk = cfg.router == "topk"

    def fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor):
        _check_step_shapes(cfg, mesh, tokens)
        dp, tp, pp, mb = mesh.dp, mesh.tp, mesh.pp, cfg.microbatches
        B_loc, S = tokens.shape
        s_loc, b_mb, D = S // tp, B_loc // mb, cfg.d_model
        device, dt = tokens.device, cfg.dtype
        axes = param_axes(cfg, params)
        staged = [name for name in params if "pp" in axes[name]]

        def local(x, i):
            return x[i * b_mb:(i + 1) * b_mb, mesh.tp_rank * s_loc:(mesh.tp_rank + 1) * s_loc]

        slab = (b_mb, s_loc, D)
        act = torch.empty((tables.act_slots, *slab), dtype=dt, device=device)
        fland = torch.empty((tables.land_slots, *slab), dtype=dt, device=device)
        bland = torch.empty((tables.land_slots, *slab), dtype=dt, device=device)
        zeros = torch.zeros(slab, dtype=dt, device=device)
        grads = {name: torch.zeros(x.shape, dtype=torch.float32, device=device)
                 for name, x in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        aux_acc = torch.zeros((), dtype=torch.float32, device=device)
        # the global loss is the mean over (microbatches, dp ranks, tp shards)
        cot = torch.tensor(1.0 / (mb * dp * tp), dtype=torch.float32, device=device)
        aux_cot = torch.tensor(cfg.router_aux / (mb * tables.n_stages * dp * tp),
                               dtype=torch.float32, device=device)
        fwd_arr = bwd_arr = zeros
        for t in range(tables.ticks):
            if row["fwd_land"][t] >= 0:
                fland[row["fwd_land"][t]] = fwd_arr
            if row["bwd_land"][t] >= 0:
                bland[row["bwd_land"][t]] = bwd_arr
            kind, i, c = row["kind"][t], row["mb"][t], row["chunk"][t]
            aslot, islot = row["act_slot"][t], row["in_slot"][t]
            s = c * pp + p_pp  # the global stage of this tick's chunk
            chunk = {name: params[name][c:c + 1] for name in staged}
            send_f = send_b = zeros
            if kind == KIND_FWD:
                with torch.no_grad():
                    if s == 0:
                        x_in = params["embed"][local(tokens, i).long()]
                    else:
                        x_in = fland[islot]
                    act[aslot] = x_in
                    y, aux = stage_fn(x_in, chunk)
                    aux_acc += aux
                    if s == last:
                        loss_acc += tail_loss(y, params["ln_f"], params["head"],
                                              local(targets, i))
                    else:
                        send_f = y
            elif kind == KIND_BWD:
                with torch.enable_grad():
                    x = act[aslot].detach().requires_grad_(True)
                    leaves = {name: p.detach().requires_grad_(True) for name, p in chunk.items()}
                    wrt = [x, *leaves.values()]
                    y, aux = stage_fn(x, leaves)
                    # the aux term's seed, under the top-k router only
                    extra, extra_seed = ([aux], [aux_cot]) if topk else ([], [])
                    if s == last:
                        tail = [params[name].detach().requires_grad_(True)
                                for name in ("ln_f", "head")]
                        loss = tail_loss(y, *tail, local(targets, i))
                        got = torch.autograd.grad([loss, *extra], wrt + tail,
                                                  [cot, *extra_seed], allow_unused=True)
                        for name, g in zip(("ln_f", "head"), got[-2:]):
                            grads[name] += g.float()
                    else:
                        got = torch.autograd.grad([y, *extra], wrt, [bland[islot], *extra_seed],
                                                  allow_unused=True)
                for name, g in zip(leaves, got[1:len(wrt)]):
                    if g is not None:
                        grads[name][c] += g[0].float()
                dx = got[0]
                if s == 0:
                    grads["embed"].index_add_(0, local(tokens, i).reshape(-1).long(),
                                              dx.reshape(-1, D).float())
                else:
                    send_b = dx
            got_f, got_b = mesh.exchange("pp", send_f if fwd_due[t] else None,
                                         send_b if bwd_due[t] else None)
            fwd_arr = fwd_arr if got_f is None else got_f
            bwd_arr = bwd_arr if got_b is None else got_b
        loss = mesh.axis_sum(loss_acc / mb, "pp")
        if topk:
            loss = loss + cfg.router_aux * mesh.axis_sum(aux_acc / mb, "pp") / tables.n_stages
        loss = mesh.axis_sum(loss, "dp") / dp
        loss = mesh.axis_sum(loss, "tp") / tp
        out = {}
        for name, g in grads.items():
            g = mesh.axis_sum(g, "dp", *(a for a in ("tp", "pp") if a not in axes[name]))
            out[name] = g.to(params[name].dtype)
        return loss, out

    return fn


def make_train_step_1f1b(mesh, cfg: TransformerConfig, learning_rate: float = 1e-2,
                         schedule: str = "1f1b", virtual: int = 1):
    """The 1F1B (or interleaved) training step (JAX :383), the counterpart
    of ``models.transformer.make_train_step`` with the same returns:
    ``(train_step, init_opt_state)``, ``train_step(params, opt_state,
    tokens, targets) -> (params, opt_state, loss)``, functional, with the
    port's ``optax.adamw`` update."""
    grad_fn = make_loss_and_grads_1f1b(mesh, cfg, schedule=schedule, virtual=virtual)

    def train_step(params, opt_state, tokens, targets):
        loss, grads = grad_fn(params, tokens, targets)
        params, opt_state = adamw_update(params, grads, opt_state, learning_rate)
        return params, opt_state, loss

    return train_step, adamw_init
