"""The 1F1B and interleaved training step on a 2-rank gloo world.

Small model (d_model 32, 4 heads of 8, d_ff 64, vocab 64, one layer a
stage, batch 4, m = 16, microbatches 2), float32 unless stated. Each rank:

- runs the ``spmd`` member's train step at (dp, tp, pp) = (1, 1, 2) with
  ``schedule=1f1b`` and with ``schedule=interleaved, virtual=2`` (einsum
  attention), and returns its loss and its slice of the parameters after
  the AdamW update. The parent holds them against the JAX package's
  ``make_train_step_1f1b`` on a (1, 1, 2) mesh of the CPU simulation,
  with the stage stack arranged device-major by the JAX
  ``arrange_stage_stack``: the loss within 1e-5 and the parameters by
  ``tests/test_torch_multirank.py``'s rule (2e-6 where the first AdamW
  step is insensitive to the gradient's last bits, 2 * lr on the under 5%
  of a leaf where a tiny gradient makes it follow them);
- takes the loss and the gradients of the port's table executor
  (``make_loss_and_grads_1f1b``, 1f1b) and of the port's GPipe loop
  (``make_loss_and_grad_fn``) on the same parameters at (1, 1, 2) and
  (1, 2, 1), flash attention (its plain version on the CPU): the losses
  within 1e-6 and every gradient within 1e-6 (the same float32 arithmetic
  summed in another order);
- validates the member's bf16 1f1b and interleaved steps against the
  oracle.
"""

import traceback

import numpy as np
import pytest

import jax

from torch_parity import join_world, run_world

WORLD = 2
SEQ, D, FF = 16, 32, 64
COMMON = dict(batch=4, vocab=64, n_heads=4, microbatches=2)
LR, WD = 1e-2, 1e-4
DEADLINE_S = 300
#: the member's cases held against JAX: (schedule, virtual)
JAX_CASES = [("1f1b", 1), ("interleaved", 2)]
#: the meshes on which 1F1B is held against GPipe
GPIPE_MESHES = [(1, 1, 2), (1, 2, 1)]


def _rank_main(rank, port, results):
    join_world(rank, WORLD, port)
    import torch
    import torch.distributed as dist

    from ddlb_tpu_torch.models import pipeline as TP
    from ddlb_tpu_torch.models import transformer as T
    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.runtime import Runtime

    try:
        out = {}
        for schedule, v in JAX_CASES:
            for dtype in ("float32", "bfloat16"):
                impl = load_impl_class("transformer_step", "spmd")(
                    SEQ, D, FF, dtype=dtype, device="cpu", dp=1, tp=1, pp=2, schedule=schedule,
                    virtual=v, attn_kernel="einsum", **COMMON)
                result = impl.run()
                params, _, loss = result
                out[schedule, dtype] = ({k: x.float().numpy() for k, x in params.items()},
                                        float(loss), impl.validate(result), impl.mesh.pp_rank)
        cfg = T.TransformerConfig(vocab=64, d_model=D, n_heads=4, d_ff=FF, microbatches=2)
        tokens, targets = (torch.from_numpy(x) for x in T.example_tokens(4, SEQ, 64, seed=1))
        for dp, tp, pp in GPIPE_MESHES:
            mesh = Runtime("cpu").mesh(dp, tp, pp)
            full = T.init_params(cfg, pp, n_experts=tp, seed=0)
            params = T.shard_params(full, cfg, tp, mesh.tp_rank, pp, mesh.pp_rank)
            loss_g, grads_g = T.make_loss_and_grad_fn(mesh, cfg)(params, tokens, targets)
            loss_f, grads_f = TP.make_loss_and_grads_1f1b(mesh, cfg)(params, tokens, targets)
            out[dp, tp, pp] = (float(loss_g), float(loss_f),
                               {k: g.numpy() for k, g in grads_g.items()},
                               {k: g.numpy() for k, g in grads_f.items()})
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_step(schedule, v):
    """The JAX package's 1F1B step on a (1, 1, 2) mesh: (arranged
    parameters before and after one step, loss)."""
    from ddlb_tpu.models import pipeline as JP
    from ddlb_tpu.models import transformer as J

    cfg = J.TransformerConfig(vocab=64, d_model=D, n_heads=4, d_ff=FF, microbatches=2,
                              attn_kernel="einsum")
    mesh = jax.make_mesh((1, 1, 2), ("dp", "tp", "pp"), devices=jax.devices()[:WORLD])
    step, init_opt, shardings = JP.make_train_step_1f1b(mesh, cfg, donate=False,
                                                         schedule=schedule, virtual=v)
    init = JP.arrange_stage_stack(J.init_params(cfg, 2 * v, n_experts=1, seed=42), 2, v, cfg=cfg)
    params = {k: jax.device_put(x, shardings[k]) for k, x in init.items()}
    tokens, targets = J.example_tokens(4, SEQ, 64, seed=42)
    new, _, loss = step(params, init_opt(params), jax.device_put(tokens, shardings["data"]),
                        jax.device_put(targets, shardings["data"]))
    return ({k: np.asarray(x) for k, x in init.items()},
            {k: np.asarray(x) for k, x in new.items()}, float(loss))


@pytest.fixture(scope="module")
def world():
    return run_world(_rank_main, WORLD, DEADLINE_S)


@pytest.mark.parametrize("schedule,v", JAX_CASES)
def test_step_matches_jax_make_train_step_1f1b(world, schedule, v):
    from ddlb_tpu_torch.models.transformer import TransformerConfig, param_axes

    init, want, want_loss = _jax_step(schedule, v)
    axes = param_axes(TransformerConfig(), want)
    u = {name: np.abs((init[name] - new) / LR - WD * init[name]) for name, new in want.items()}
    atol = {name: np.where((u[name] > 1e-3) & (u[name] < 0.99), 2 * LR, 2e-6) for name in u}
    for rank in range(WORLD):
        params, loss, valid, pp_rank = world[rank][schedule, "float32"]
        assert valid and pp_rank == rank
        np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-5)
        for name, full in want.items():
            part, tol = full, atol[name]
            if "pp" in axes[name]:
                # rank p's block of the device-major stack: its v chunks
                part, tol = (x[rank * v:(rank + 1) * v] for x in (full, tol))
            err = np.abs(params[name] - part)
            assert np.all(err <= tol), (
                f"rank {rank} {schedule} {name}: {int(np.sum(err > tol))} elements beyond "
                f"tolerance, max {err.max()}")
            assert np.mean(tol > 2e-6) < 0.05, name
        assert world[rank][schedule, "bfloat16"][2], (rank, schedule, "bfloat16")


@pytest.mark.parametrize("mesh", GPIPE_MESHES, ids=str)
def test_one_f_one_b_gradients_equal_gpipe(world, mesh):
    for rank in range(WORLD):
        loss_g, loss_f, grads_g, grads_f = world[rank][mesh]
        assert loss_f == pytest.approx(loss_g, abs=1e-6)
        assert set(grads_f) == set(grads_g)
        for name, g in grads_g.items():
            np.testing.assert_allclose(grads_f[name], g, rtol=0, atol=1e-6,
                                       err_msg=f"rank {rank} {mesh} {name}")
