"""Train-state checkpoints (``models/checkpoint.py``, on
``torch.distributed.checkpoint``): the port's counterparts of
``tests/test_checkpoint.py``, on the CPU.

A 2-rank gloo world (spawned, with a deadline) trains the flagship model's
``spmd`` step at (dp, tp, pp) = (1, 2, 1), its parameters and AdamW state
sharded as ``param_placements`` places them (the experts, heads and output
rows over tp). It saves the state as DTensors before step 2, trains on to
step 4, then restores the checkpoint onto a fresh state drawn from another
seed and trains steps 2 and 3 again: the losses equal the uninterrupted
ones bit for bit. The parent restores the same checkpoint onto one process
(a one-rank mesh, every leaf whole) and finds each rank's shards in it bit
for bit; a params-only restore and the resume probe on an empty directory
run in one process.
"""

import traceback

import numpy as np
import pytest
import torch

from ddlb_tpu_torch.models import transformer as T
from ddlb_tpu_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from torch_parity import join_world, run_world

WORLD = 2
DEADLINE_S = 240
CFG = T.TransformerConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, microbatches=2)
MESH = (1, WORLD, 1)
STEPS, SAVE_AT = 4, 2


def _state(params, opt_state, mesh):
    """This rank's train state as DTensors on ``mesh`` (``param_placements``;
    the step count, a scalar, stays a plain tensor)."""
    from torch.distributed.tensor import DTensor

    where = T.param_placements(CFG, mesh)

    def wrap(tree):
        return {name: DTensor.from_local(x, mesh, where[name], run_check=False)
                for name, x in tree.items()}

    return wrap(params), {"count": opt_state["count"], "mu": wrap(opt_state["mu"]),
                          "nu": wrap(opt_state["nu"])}


def _local(tree):
    return {name: x.to_local() for name, x in tree.items()}


def _rank_main(rank, port, results, directory):
    join_world(rank, WORLD, port)
    import torch.distributed as dist

    from ddlb_tpu_torch.runtime import Runtime

    try:
        runtime = Runtime("cpu")
        mesh = runtime.mesh(*MESH)
        dmesh = runtime.device_mesh(("dp", "tp", "pp"), MESH)
        step, init_opt = T.make_train_step(mesh, CFG)
        tokens, targets = (torch.from_numpy(x) for x in T.example_tokens(4, 16, CFG.vocab))

        def fresh(seed):
            full = T.init_params(CFG, 1, n_experts=WORLD, seed=seed)
            params = T.shard_params(full, CFG, WORLD, mesh.tp_rank)
            return params, init_opt(params)

        params, opt = fresh(0)
        losses, saved = [], None
        for i in range(STEPS):
            if i == SAVE_AT:
                saved = _state(params, opt, dmesh)
                save_checkpoint(directory, i, *saved)
            params, opt, loss = step(params, opt, tokens, targets)
            losses.append(float(loss))
        assert latest_step(directory) == SAVE_AT

        params2, opt2 = restore_checkpoint(directory, SAVE_AT,
                                           dict(zip(("params", "opt_state"),
                                                    _state(*fresh(7), dmesh))))
        params2 = _local(params2)
        opt2 = {"count": opt2["count"], "mu": _local(opt2["mu"]), "nu": _local(opt2["nu"])}
        resumed = []
        for _ in range(STEPS - SAVE_AT):
            params2, opt2, loss = step(params2, opt2, tokens, targets)
            resumed.append(float(loss))
        shards = {"params": {k: v.to_local().numpy() for k, v in saved[0].items()},
                  "mu": {k: v.to_local().numpy() for k, v in saved[1]["mu"].items()},
                  "nu": {k: v.to_local().numpy() for k, v in saved[1]["nu"].items()},
                  "count": int(saved[1]["count"])}
        results.put((rank, "ok", (losses, resumed, shards, mesh.tp_rank)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("ckpt"))
    return directory, run_world(_rank_main, WORLD, DEADLINE_S, directory)


def test_round_trip_continues_training_bitwise(world):
    _, got = world
    for rank in range(WORLD):
        losses, resumed, _, _ = got[rank]
        assert len(set(losses)) == STEPS  # the steps trained
        assert resumed == losses[SAVE_AT:], (rank, resumed, losses)


def test_restore_onto_different_mesh(world):
    """The two ranks' checkpoint restored onto one process: a one-rank
    mesh, every leaf whole, each rank's shards found in it bit for bit."""
    from ddlb_tpu_torch.runtime import Runtime

    directory, got = world
    dmesh = Runtime("cpu").device_mesh(("dp", "tp", "pp"), (1, 1, 1))
    like = T.init_params(CFG, 1, n_experts=WORLD, seed=7)
    params, opt = restore_checkpoint(directory, SAVE_AT, dict(zip(
        ("params", "opt_state"), _state(like, T.adamw_init(like), dmesh))))
    axes = T.param_axes(CFG, like)
    for rank in range(WORLD):
        shards, t_i = got[rank][2], got[rank][3]
        assert int(opt["count"]) == shards["count"] == SAVE_AT
        for tree, name_of in ((params, "params"), (opt["mu"], "mu"), (opt["nu"], "nu")):
            for name, x in tree.items():
                whole = x.to_local()
                assert whole.shape == like[name].shape, name
                want = shards[name_of][name]
                if "tp" in axes[name]:
                    dim = axes[name]["tp"]
                    width = whole.shape[dim] // WORLD
                    whole = whole.narrow(dim, t_i * width, width)
                np.testing.assert_array_equal(whole.numpy(), want, err_msg=f"{name_of} {name}")


def test_params_only_restore(tmp_path):
    params = T.init_params(CFG, 1, n_experts=1, seed=3)
    save_checkpoint(str(tmp_path), 0, params)
    with pytest.raises(ValueError, match="exists"):
        save_checkpoint(str(tmp_path), 0, params)
    save_checkpoint(str(tmp_path), 0, params, force=True)
    like = T.init_params(CFG, 1, n_experts=1, seed=4)
    restored, opt_none = restore_checkpoint(str(tmp_path), 0, {"params": like})
    assert opt_none is None
    assert not torch.equal(like["embed"], params["embed"])  # the template is left as it is
    for name, x in params.items():
        assert torch.equal(restored[name], x), name


def test_every_rank_takes_rank_0s_answer_on_an_existing_step(tmp_path, monkeypatch):
    """Across ranks, whether the step exists is rank 0's answer: a rank that
    finds the directory another rank has begun writing does not raise
    alone (the race that failed the two-rank world at random)."""
    import torch.distributed as dist

    from ddlb_tpu_torch.models import checkpoint

    params = T.init_params(CFG, 1, n_experts=1, seed=3)
    (tmp_path / "0").mkdir()  # rank 0 already writing
    seen = []

    def broadcast(objects, src):
        seen.append((list(objects), src))
        objects[0] = False  # rank 0 looked before it wrote

    monkeypatch.setattr(checkpoint, "_single_process", lambda: False)
    monkeypatch.setattr(dist, "broadcast_object_list", broadcast)
    saved = []
    monkeypatch.setattr(checkpoint.dcp, "save", lambda *a, **kw: saved.append(kw))
    checkpoint.save_checkpoint(str(tmp_path), 0, params)
    assert seen == [([True], 0)] and len(saved) == 1


def test_latest_step_empty(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    assert latest_step(str(tmp_path)) is None
    (tmp_path / "5").mkdir()  # a step directory without DCP's metadata: incomplete
    assert latest_step(str(tmp_path)) is None
