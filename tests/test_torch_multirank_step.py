"""The port's ``transformer_step`` on a real 2-rank gloo world: the spmd
train step over (dp, tp, pp) meshes of two ranks against the JAX
package's step, and the ring flash attention's gradients at d = 2. Split
from ``test_torch_multirank.py`` so that the test runner's workers can
share the multi-rank worlds (a file is one unit of work); two ranks are
spawned, never forked.
"""

import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import torch

WORLD = 2
#: seconds the whole world may take; the test fails when it runs out
DEADLINE_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -- transformer_step over (dp, tp, pp) meshes of two ranks --------------------
#
# d_model 32, 4 heads of 8, d_ff 64, vocab 64, one layer a stage, batch 4,
# m = 16, float32. Each rank runs one spmd train step (or, under
# mode='forward', the loss alone, its parameters left as they are) and
# returns its loss and its slice of the parameters after the AdamW update;
# the parent holds
# them against the JAX package's train step on a CPU-simulation mesh of the
# same shape (jax.make_mesh lays out its devices with pp fastest, as
# runtime.Mesh places the ranks): the loss within 1e-5 and the slices of
# the updated parameters within 2e-6. The first AdamW step moves a
# parameter by lr * (u + wd * p) with u = g / (|g| + eps): where |u| >=
# 0.99 (|g| above about 1e-6) float32 gradients that agree to 1e-7 relative
# pin it far below 2e-6, and so they do where g is exactly 0 on both sides;
# where the gradient is tiny but not 0, typically a sum over ranks that
# nearly cancels, u follows the last bits of g, so there (under 5% of a
# leaf) the parameter is only held within 2 * lr. The learned routers run at
# E = tp experts (topk, its capacity binding at factor 0.5, expert_choice) and
# at pp = 2 under the 1f1b schedule (one expert, k = 1: the aux term through
# the table executor's cotangent). Then each rank's dq, dk, dv of the
# ring flash attention on its sequence chunk at d = 2 against jax.grad of
# the JAX package's ring_flash_attention at 1e-5.

STEP_M, STEP_N, STEP_K = 16, 32, 64
STEP_COMMON = dict(batch=4, vocab=64, n_heads=4, microbatches=2)
STEP_CASES = [
    (1, 2, 1, {"attention": "gathered"}),
    (1, 2, 1, {"attention": "ring"}),
    (1, 2, 1, {"attention": "ring", "attn_window": 6, "n_kv_heads": 2, "rope": True}),
    (1, 1, 2, {"attn_kernel": "einsum"}),
    (2, 1, 1, {"attn_kernel": "einsum"}),
    # the einsum ring: every hop in every rank's graph, live or not
    (1, 2, 1, {"attention": "ring", "attn_kernel": "einsum"}),
    (1, 2, 1, {"attention": "ring", "attn_kernel": "einsum", "attn_window": 5}),
    (1, 1, 2, {}),
    # the loss alone: parameters as they were, the loss the step's
    (1, 1, 2, {"mode": "forward"}),
    # the learned routers
    (1, 2, 1, {"router": "topk"}),
    (1, 2, 1, {"router": "topk", "capacity_factor": 0.5}),
    (1, 2, 1, {"router": "expert_choice"}),
    (1, 1, 2, {"router": "topk", "router_topk": 1, "schedule": "1f1b"}),
    # dp with flash; gathered GQA, rope and a window; the int8 MLP gathered
    # and ring; two layers a stage
    (2, 1, 1, {}),
    (1, 2, 1, {"n_kv_heads": 2, "rope": True, "attn_window": 6}),
    (1, 2, 1, {"mlp_kernel": "int8"}),
    (1, 2, 1, {"attention": "ring", "mlp_kernel": "int8"}),
    (1, 1, 2, {"layers_per_stage": 2}),
]
#: options of a case that are the member's, not the model config's
STEP_MEMBER_OPTIONS = ("mode", "schedule")
RING_S, RING_H, RING_DH = 32, 2, 8


def _ring_inputs():
    rng = np.random.default_rng(7)
    return [rng.normal(0, 1, (RING_S, RING_H, RING_DH)).astype(np.float32)
            for _ in range(4)]  # q, k, v, the output's cotangent


def _step_rank_main(rank, port, results):
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    from ddlb_tpu_torch.ops.flash_attention import ring_flash_attention
    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.runtime import Runtime

    try:
        out = {}
        for i, (dp, tp, pp, opts) in enumerate(STEP_CASES):
            impl = load_impl_class("transformer_step", "spmd")(
                STEP_M, STEP_N, STEP_K, dtype="float32", device="cpu",
                dp=dp, tp=tp, pp=pp, **STEP_COMMON, **opts,
            )
            result = impl.run()
            if opts.get("mode") == "forward":
                params, loss = impl._args[0], result
            else:
                params, _, loss = result
            coords = (impl.mesh.dp_rank, impl.mesh.tp_rank, impl.mesh.pp_rank)
            out[i] = ({k: v.numpy() for k, v in params.items()}, float(loss),
                      impl.validate(result), coords)
        mesh = Runtime("cpu").mesh(1, WORLD, 1)
        s_loc = RING_S // WORLD
        q, k, v, w = (torch.from_numpy(x[rank * s_loc:(rank + 1) * s_loc].copy())
                      for x in _ring_inputs())
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = ring_flash_attention(
            q, k, v, shift=lambda *ts: mesh.shift("tp", *ts), axis_size=WORLD,
            axis_index=mesh.tp_rank, scale=RING_DH**-0.5,
        )
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        out["ring"] = [g.numpy() for g in grads]
        results.put((rank, "ok", out, None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_step(dp, tp, pp, opts):
    """The JAX package's train step on a (dp, tp, pp) mesh of the CPU
    simulation: (full parameters before and after one step, loss). Under
    ``mode='forward'`` the parameters after are those before (the step's
    loss is taken before its update, so it is the forward's loss)."""
    import jax

    from ddlb_tpu.models.pipeline import make_train_step_1f1b
    from ddlb_tpu.models.transformer import (
        TransformerConfig, example_tokens, init_params, make_train_step,
    )

    forward = opts.get("mode") == "forward"
    schedule = opts.get("schedule", "gpipe")
    opts = {k: v for k, v in opts.items() if k not in STEP_MEMBER_OPTIONS}
    cfg = TransformerConfig(vocab=64, d_model=STEP_N, n_heads=4, d_ff=STEP_K,
                            microbatches=2, **opts)
    mesh = jax.make_mesh((dp, tp, pp), ("dp", "tp", "pp"), devices=jax.devices()[:WORLD])
    if schedule == "gpipe":
        step, init_opt, shardings = make_train_step(mesh, cfg, donate=False)
    else:
        step, init_opt, shardings = make_train_step_1f1b(mesh, cfg, donate=False,
                                                         schedule=schedule)
    init = init_params(cfg, pp, n_experts=tp, seed=42)
    params = {k: jax.device_put(v, shardings[k]) for k, v in init.items()}
    tokens, targets = example_tokens(4, STEP_M, 64, seed=42)
    new, _, loss = step(params, init_opt(params), jax.device_put(tokens, shardings["data"]),
                        jax.device_put(targets, shardings["data"]))
    if forward:
        new = init
    return ({k: np.asarray(v) for k, v in init.items()},
            {k: np.asarray(v) for k, v in new.items()}, float(loss))


def _jax_ring_grads():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ddlb_tpu.ops.flash_attention import ring_flash_attention
    from ddlb_tpu.runtime import shard_map_compat

    q, k, v, w = (jnp.asarray(x) for x in _ring_inputs())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("tp",))

    def body(q, k, v):
        return ring_flash_attention(q, k, v, axis_name="tp", axis_size=WORLD,
                                    scale=RING_DH**-0.5, block_q=8, block_kv=8,
                                    interpret=True)

    def loss(q, k, v):
        o = shard_map_compat(body, mesh=mesh, in_specs=(P("tp"),) * 3,
                             out_specs=P("tp"), check_vma=False)(q, k, v)
        return jnp.sum(o * w)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def test_two_rank_transformer_step():
    from ddlb_tpu_torch.models.transformer import TransformerConfig, param_axes

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_step_rank_main, args=(r, port, results), daemon=True)
        for r in range(WORLD)
    ]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, status, payload, _ = results.get(timeout=DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {WORLD}-rank world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * WORLD

    for i, (dp, tp, pp, opts) in enumerate(STEP_CASES):
        init, want_params, want_loss = _jax_step(dp, tp, pp, opts)
        axes = param_axes(TransformerConfig(
            **{k: v for k, v in opts.items() if k not in STEP_MEMBER_OPTIONS}), want_params)
        lr, wd = 1e-2, 1e-4
        # u as the JAX step applied it; 0 (an unused embedding row) is exact
        # on both sides
        u = {name: np.abs((init[name] - new) / lr - wd * init[name])
             for name, new in want_params.items()}
        atol = {name: np.where((u[name] > 1e-3) & (u[name] < 0.99), 2 * lr, 2e-6)
                for name in u}
        for rank in range(WORLD):
            params, loss, valid, (d_i, t_i, p_i) = got[rank][i]
            assert valid, (rank, STEP_CASES[i])
            assert (d_i, t_i, p_i) == (rank // (tp * pp), rank // pp % tp, rank % pp)
            np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-5)
            for name, full in want_params.items():
                part, tol = full, atol[name]
                for axis, dim in axes[name].items():
                    n, at = {"tp": (tp, t_i), "pp": (pp, p_i)}[axis]
                    width = part.shape[dim] // n
                    cut = range(at * width, (at + 1) * width)
                    part, tol = np.take(part, cut, axis=dim), np.take(tol, cut, axis=dim)
                err = np.abs(params[name] - part)
                assert np.all(err <= tol), (
                    f"rank {rank} case {STEP_CASES[i]} {name}: "
                    f"{int(np.sum(err > tol))} elements beyond tolerance, max {err.max()}"
                )
                assert np.mean(tol > 2e-6) < 0.05, name

    want = _jax_ring_grads()
    s_loc = RING_S // WORLD
    for rank in range(WORLD):
        for name, g, full in zip("qkv", got[rank]["ring"], want):
            np.testing.assert_allclose(
                g, full[rank * s_loc:(rank + 1) * s_loc], rtol=0, atol=1e-5,
                err_msg=f"rank {rank} d{name}",
            )
