"""The tensor-parallel MLP block (``models/tp_mlp.py``) against the JAX
package's, on the CPU, float32.

- ``init_params`` and ``example_batch`` bit for bit the JAX draws;
  ``mlp_forward`` within 1e-5 (float32 sums in another order).
- One SGD step of ``make_train_step`` at world 1 against the JAX step on
  one device: the loss within 1e-6 and the new weights within 1e-6.
- A 2-rank gloo world (spawned, with a deadline): ``mlp_block`` on each
  rank's shards (the rows of ``x``, the columns of ``w1``, the rows of
  ``w2``) against the rank's rows of ``mlp_forward`` within 1e-5, and the
  DTensor train step at (dp, tp) = (1, 2) and (2, 1) against the JAX step
  on two devices of the CPU simulation: the loss within 1e-6, each rank's
  shards of the new weights within 1e-6.
"""

import traceback

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.models import tp_mlp as J
from ddlb_tpu_torch.models import tp_mlp as T
from torch_parity import join_world, run_world

D, FF, B, S = 32, 64, 4, 16
WORLD = 2
DEADLINE_S = 240
LAYOUTS = ((1, WORLD), (WORLD, 1))
LR = 1e-3


def _jax_batch():
    x, t = J.example_batch(B, S, D, dtype=jax.numpy.float32)
    return np.asarray(x), np.asarray(t)


def test_draws_match_jax():
    want = J.init_params(D, FF, dtype=jax.numpy.float32, seed=3)
    got = T.init_params(D, FF, dtype=torch.float32, seed=3)
    for name in ("w1", "w2"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    x, t = T.example_batch(B, S, D, dtype=torch.float32)
    wx, wt = _jax_batch()
    np.testing.assert_array_equal(x.numpy(), wx)
    np.testing.assert_array_equal(t.numpy(), wt)
    assert T.init_params(D, FF)["w1"].dtype == torch.bfloat16


def test_mlp_forward_matches_jax():
    p = J.init_params(D, FF, dtype=jax.numpy.float32)
    x, _ = _jax_batch()
    want = np.asarray(J.mlp_forward(jax.numpy.asarray(x), p["w1"], p["w2"]))
    got = T.mlp_forward(torch.from_numpy(x.copy()), *(torch.from_numpy(np.array(p[n]))
                                                      for n in ("w1", "w2")))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _jax_step(dp, tp):
    """The JAX step on a (dp, tp) mesh of the simulation: (loss, w1, w2)."""
    mesh = jax.make_mesh((dp, tp), ("dp", "tp"), devices=jax.devices()[:dp * tp])
    step, init_opt, (_, w1_sh, w2_sh) = J.make_train_step(mesh, LR)
    p = J.init_params(D, FF, dtype=jax.numpy.float32)
    params = {"w1": jax.device_put(p["w1"], w1_sh), "w2": jax.device_put(p["w2"], w2_sh)}
    x, t = J.example_batch(B, S, D, dtype=jax.numpy.float32)
    new, _, loss = step(params, init_opt(params), x, t)
    return float(loss), np.asarray(new["w1"]), np.asarray(new["w2"])


def test_train_step_matches_jax_at_world_one():
    from torch.distributed.tensor import DTensor

    from ddlb_tpu_torch.runtime import Runtime

    mesh = Runtime("cpu").device_mesh(("dp", "tp"), (1, 1))
    step, init_opt, (x_pl, w1_pl, w2_pl) = T.make_train_step(mesh, LR)
    p = T.init_params(D, FF, dtype=torch.float32)
    params = {"w1": DTensor.from_local(p["w1"], mesh, w1_pl, run_check=False),
              "w2": DTensor.from_local(p["w2"], mesh, w2_pl, run_check=False)}
    x, t = (DTensor.from_local(a, mesh, x_pl, run_check=False)
            for a in T.example_batch(B, S, D, dtype=torch.float32))
    new, state, loss = step(params, init_opt(params), x, t)
    assert state == {}
    want_loss, w1, w2 = _jax_step(1, 1)
    assert float(loss.full_tensor()) == pytest.approx(want_loss, abs=1e-6)
    np.testing.assert_allclose(new["w1"].full_tensor().numpy(), w1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(new["w2"].full_tensor().numpy(), w2, rtol=0, atol=1e-6)
    assert torch.equal(params["w1"].to_local(), p["w1"])  # functional


def _rank_main(rank, port, results):
    join_world(rank, WORLD, port)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from ddlb_tpu_torch.runtime import Runtime

    try:
        out = {}
        runtime = Runtime("cpu")
        mesh = runtime.mesh(1, WORLD)
        p = T.init_params(D, FF, dtype=torch.float32)
        x, t = T.example_batch(B, S, D, dtype=torch.float32)
        rows, cols = (B * S) // WORLD, FF // WORLD
        me = slice(rank * rows, (rank + 1) * rows)
        mine = slice(rank * cols, (rank + 1) * cols)
        y = T.mlp_block(mesh)(x.reshape(B * S, D)[me], p["w1"][:, mine], p["w2"][mine])
        out["block"] = y.numpy()
        for dp, tp in LAYOUTS:
            dmesh = runtime.device_mesh(("dp", "tp"), (dp, tp))
            step, init_opt, (x_pl, w1_pl, w2_pl) = T.make_train_step(dmesh, LR)

            def place(a, pl):
                # every rank holds the whole array: cut its shard out of it
                whole = DTensor.from_local(a, dmesh, [Replicate()], run_check=False)
                return whole.redistribute(dmesh, pl)

            xs, ts = place(x, x_pl), place(t, x_pl)
            params = {"w1": place(p["w1"], w1_pl), "w2": place(p["w2"], w2_pl)}
            new, _, loss = step(params, init_opt(params), xs, ts)
            out[dp, tp] = (float(loss.full_tensor()),
                           {name: w.full_tensor().numpy() for name, w in new.items()},
                           {name: (w.to_local().numpy(), tuple(str(q) for q in w.placements))
                            for name, w in new.items()})
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world():
    return run_world(_rank_main, WORLD, DEADLINE_S)


def test_two_rank_mlp_block_matches_mlp_forward(world):
    p = J.init_params(D, FF, dtype=jax.numpy.float32)
    x, _ = _jax_batch()
    want = np.asarray(J.mlp_forward(jax.numpy.asarray(x.reshape(B * S, D)), p["w1"], p["w2"]))
    rows = (B * S) // WORLD
    for rank in range(WORLD):
        np.testing.assert_allclose(world[rank]["block"], want[rank * rows:(rank + 1) * rows],
                                   rtol=0, atol=1e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("dp,tp", LAYOUTS, ids=str)
def test_two_rank_train_step_matches_jax(world, dp, tp):
    want_loss, w1, w2 = _jax_step(dp, tp)
    for rank in range(WORLD):
        loss, full, local = world[rank][dp, tp]
        assert loss == pytest.approx(want_loss, abs=1e-6)
        np.testing.assert_allclose(full["w1"], w1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(full["w2"], w2, rtol=0, atol=1e-6)
        # w1 by columns and w2 by rows over tp, whole over dp
        width, t_i = FF // tp, rank % tp
        mine = slice(t_i * width, (t_i + 1) * width)
        np.testing.assert_array_equal(local["w1"][0], full["w1"][:, mine])
        np.testing.assert_array_equal(local["w2"][0], full["w2"][mine])
