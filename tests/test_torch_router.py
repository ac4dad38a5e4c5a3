"""The learned MoE routers (``router=topk|expert_choice``) and the
``int8_weights`` forward of the training model against the JAX package, on
the CPU.

- The router helpers on one seeded float32 slab (32 tokens, d_model 32)
  at E = 2 and 4 experts, k = 1 and 2, capacity factor 1.25 and 0.5 (at
  0.5 the capacity binds and selections are dropped): the selections
  ``tope``, the slots, ``kept`` and the expert-choice rows ``idx`` exactly
  equal to JAX's; ``topv``, the aux loss, the expert-choice weights and
  the combined slab within 1e-6 (the gate's float32 product sums in
  another order). Every failure message prints the slab's smallest
  top-k probability margin, so that a flipped selection shows as what it
  is.
- ``reference_loss`` of both routers at tp 2 and 4 (capacity factor 0.5,
  so tokens drop), on one process, against the JAX oracle: the loss
  within 1e-5, every gradient against ``jax.grad`` within 1e-6, and the
  parameters after one AdamW step under ``_adam_atol``
  (``test_torch_transformer_step.py``'s rule).
- The sharded step at world 1 (one expert, k = 1, with and without
  drops): the loss and gradients of the GPipe loop against JAX's
  ``make_loss_fn`` and ``jax.grad``, and the 1F1B executor's against the
  GPipe loop's; ``mlp_kernel=int8_weights`` with ``mode='forward'``
  against JAX's loss, and ``mode='train'`` refused with its message.
- The members through the runner, the tp = 1 error row of ``router_topk=2``
  and the serving paths' refusal of the learned routers.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from ddlb_tpu.models import transformer as J
from ddlb_tpu_torch.models import transformer as T
from ddlb_tpu_torch.runtime import Runtime

SEQ, BATCH = 16, 4
COMMON = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, microbatches=2)
LR, WD = 1e-2, 1e-4
SLAB_T, SLAB_D = 32, 32


def _slab(E, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.normal(0, 1, (SLAB_T, SLAB_D)).astype(np.float32)
    gate = rng.normal(0, SLAB_D ** -0.5, (SLAB_D, E)).astype(np.float32)
    return tokens, gate


def _margin(probs, k):
    """The smallest gap between the i-th and (i+1)-th largest probability
    of a row, over the first k ranks (where a rank has a successor)."""
    p = -np.sort(-probs, axis=-1)
    k = min(k, p.shape[-1] - 1)
    return float((p[:, :k] - p[:, 1:k + 1]).min()) if k else float("inf")


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("E", [2, 4])
def test_topk_helpers_match_jax(E, k, factor):
    tokens, gate = _slab(E)
    C = T.router_capacity(SLAB_T, E, k, factor)
    assert C == J.router_capacity(SLAB_T, E, k, factor)
    jt, jg = jax.numpy.asarray(tokens), jax.numpy.asarray(gate)
    want = [np.asarray(a) for a in J._router_assign(jt, jg, k, C)]
    probs = np.asarray(J._router_probs(jt, jg))
    msg = f"E={E} k={k} factor={factor}: smallest top-k margin {_margin(probs, k):.3g}"
    tt, tg = torch.from_numpy(tokens), torch.from_numpy(gate)
    np.testing.assert_allclose(T.router_probs(tt, tg).numpy(), probs, rtol=0, atol=1e-6,
                               err_msg=msg)
    tope, topv, slot, kept, aux = T.router_assign(tt, tg, k, C)
    for name, got, exp in (("tope", tope, want[0]), ("slot", slot, want[2]),
                           ("kept", kept, want[3])):
        np.testing.assert_array_equal(got.numpy(), exp, err_msg=f"{name}, {msg}")
    np.testing.assert_allclose(topv.numpy(), want[1], rtol=0, atol=1e-6, err_msg=msg)
    assert abs(float(aux) - float(want[4])) <= 1e-6, msg
    if factor < 1:
        assert not kept.all(), "the capacity must bind at factor 0.5"

    buf = T.router_dispatch(tt, tope, slot, kept, E, C)
    jbuf = J._router_dispatch(jt, *(jax.numpy.asarray(a) for a in (want[0], want[2], want[3])),
                              E, C)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf), err_msg=msg)
    out = np.random.default_rng(1).normal(0, 1, (E, C, SLAB_D)).astype(np.float32)
    got = T.router_combine(torch.from_numpy(out), tope, slot, topv, kept, C, torch.float32)
    exp = J._router_combine(jax.numpy.asarray(out), *(jax.numpy.asarray(a) for a in (
        want[0], want[2], want[1], want[3])), C, jax.numpy.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=1e-6, err_msg=msg)


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("E", [2, 4])
def test_expert_choice_helpers_match_jax(E, factor):
    tokens, gate = _slab(E, seed=2)
    C = min(T.router_capacity(SLAB_T, E, 1, factor), SLAB_T)
    jt, jg = jax.numpy.asarray(tokens), jax.numpy.asarray(gate)
    jidx, jw = (np.asarray(a) for a in J._expert_choice_assign(jt, jg, C))
    probs = np.asarray(J._router_probs(jt, jg))
    msg = f"E={E} factor={factor}: smallest top-C margin {_margin(probs.T, C):.3g}"
    idx, w = T.expert_choice_assign(torch.from_numpy(tokens), torch.from_numpy(gate), C)
    np.testing.assert_array_equal(idx.numpy(), jidx, err_msg=f"idx, {msg}")
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-6, err_msg=msg)
    out = np.random.default_rng(3).normal(0, 1, (E, C, SLAB_D)).astype(np.float32)
    got = T.expert_choice_combine(torch.from_numpy(out), idx, w, SLAB_T, torch.float32)
    exp = J._expert_choice_combine(jax.numpy.asarray(out), jax.numpy.asarray(jidx),
                                   jax.numpy.asarray(jw), SLAB_T, jax.numpy.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=1e-6, err_msg=msg)
    if factor < 1:  # E * C < T: some tokens are taken by no expert
        assert len(np.unique(jidx)) < SLAB_T


def _adam_atol(init, new):
    u = np.abs((init - new) / LR - WD * init)
    return np.where((u > 1e-3) & (u < 0.99), 2 * LR, 2e-6)


def _pair(tp, pp=1, seed=0, **opts):
    """JAX and port configs, JAX's ``init_params`` carried over, and the
    tokens."""
    jcfg = J.TransformerConfig(**COMMON, **opts)
    cfg = T.TransformerConfig(**COMMON, **opts)
    params = {k: np.array(v) for k, v in J.init_params(jcfg, pp, n_experts=tp,
                                                       seed=seed).items()}
    tokens, targets = (np.array(a) for a in J.example_tokens(BATCH, SEQ, 64, seed=1))
    return jcfg, cfg, params, tokens, targets


ORACLE_CASES = [(tp, router) for tp in (2, 4) for router in ("topk", "expert_choice")]


@pytest.mark.parametrize("tp,router", ORACLE_CASES, ids=str)
def test_reference_loss_and_gradient_match_jax(tp, router):
    jcfg, cfg, params, tokens, targets = _pair(tp, router=router, capacity_factor=0.5,
                                               layers_per_stage=2)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}

    def jloss(p):
        return J.reference_loss(p, tokens, targets, jcfg, tp=tp)

    loss, grads = jax.jit(jax.value_and_grad(jloss))(jp)
    grads = {k: np.asarray(v) for k, v in grads.items()}
    leaves = {k: v.requires_grad_(True)
              for k, v in T.params_from_numpy(params, cfg, device="cpu").items()}
    tloss = T.reference_loss(leaves, torch.from_numpy(tokens), torch.from_numpy(targets),
                             cfg, tp=tp)
    assert tloss.item() == pytest.approx(float(loss), abs=1e-5)
    tgrads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    assert set(tgrads) == set(grads) and "router" in grads
    for name, g in grads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g, rtol=0, atol=1e-6, err_msg=name)
    assert np.abs(grads["router"]).max() > 0  # the gate learns through the combine

    opt = optax.adamw(LR)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    want = {k: np.asarray(v) for k, v in optax.apply_updates(jp, updates).items()}
    plain = {k: v.detach() for k, v in leaves.items()}
    got, _ = T.adamw_update(plain, tgrads, T.adamw_init(plain))
    for name, w in want.items():
        err = np.abs(got[name].numpy() - w)
        assert np.all(err <= _adam_atol(params[name], w)), (name, float(err.max()))


STEP_CASES = {
    "topk": {"router": "topk", "router_topk": 1},
    "topk_drops": {"router": "topk", "router_topk": 1, "capacity_factor": 0.5},
    "expert_choice": {"router": "expert_choice"},
    "topk_einsum_gqa": {"router": "topk", "router_topk": 1, "attn_kernel": "einsum",
                        "n_kv_heads": 2},
}


@pytest.mark.parametrize("case", list(STEP_CASES), ids=str)
def test_step_matches_jax_at_world_one(case):
    """The GPipe loop's loss and gradients (aux term included) against
    JAX's sharded loss at one device, and the 1F1B executor's against the
    GPipe loop's."""
    opts = STEP_CASES[case]
    jcfg, cfg, params, tokens, targets = _pair(1, **opts)
    mesh_j = jax.make_mesh((1, 1, 1), ("dp", "tp", "pp"), devices=jax.devices()[:1])
    loss_fn, _ = J.make_loss_fn(mesh_j, jcfg)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, tokens, targets)
    mesh = Runtime("cpu").mesh(1, 1, 1)
    tparams = T.params_from_numpy(params, cfg, device="cpu")
    ttok, ttgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    assert float(T.make_loss_fn(mesh, cfg)(tparams, ttok, ttgt)) == pytest.approx(
        float(loss), abs=1e-5)
    tloss, tgrads = T.make_loss_and_grad_fn(mesh, cfg)(tparams, ttok, ttgt)
    assert float(tloss) == pytest.approx(float(loss), abs=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), np.asarray(g), rtol=0, atol=1e-6,
                                   err_msg=name)
    from ddlb_tpu_torch.models.pipeline import make_loss_and_grads_1f1b

    floss, fgrads = make_loss_and_grads_1f1b(mesh, cfg)(tparams, ttok, ttgt)
    assert float(floss) == pytest.approx(float(tloss), abs=1e-6)
    for name, g in tgrads.items():
        np.testing.assert_allclose(fgrads[name].numpy(), g.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("router", ["block", "topk"])
def test_int8_weights_forward_matches_jax(router):
    """``int8_weights`` (and a learned gate beside it): the parameters bit
    for bit the JAX package's, the sharded loss and the oracle's equal to
    JAX's; the train step refuses it with the JAX package's message."""
    opts = {"mlp_kernel": "int8_weights", "router": router, "router_topk": 1}
    jcfg, cfg, params, tokens, targets = _pair(1, **opts)
    ours = T.init_params(cfg, 1, n_experts=1)
    for name, want in params.items():
        got = ours[name]
        assert got.dtype == T.params_from_numpy({name: want}, cfg, "cpu")[name].dtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    mesh_j = jax.make_mesh((1, 1, 1), ("dp", "tp", "pp"), devices=jax.devices()[:1])
    loss = float(jax.jit(J.make_loss_fn(mesh_j, jcfg)[0])(params, tokens, targets))
    oracle = float(J.reference_loss(params, tokens, targets, jcfg, tp=1))
    mesh = Runtime("cpu").mesh(1, 1, 1)
    tparams = T.params_from_numpy(params, cfg, device="cpu")
    ttok, ttgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    assert float(T.make_loss_fn(mesh, cfg)(tparams, ttok, ttgt)) == pytest.approx(loss, abs=1e-5)
    assert float(T.reference_loss(tparams, ttok, ttgt, cfg, tp=1)) == pytest.approx(
        oracle, abs=1e-5)
    with pytest.raises(ValueError, match="forward-only serving form"):
        T.make_train_step(mesh, cfg)


def _rows(impls, **extra):
    from ddlb_tpu_torch.cli.benchmark import run_benchmark

    return run_benchmark({
        "primitive": "transformer_step", "m": SEQ, "n": 32, "k": 64, "dtype": "float32",
        "device": "cpu", "num_iterations": 1, "num_warmups": 1, "output_csv": None,
        "implementations": impls, **extra,
    })


def test_members_through_the_runner():
    """spmd train (both routers, drops, 1f1b) and forward (``int8_weights``)
    and compute_only rows valid against the oracle; ``router_topk=2`` at
    tp = 1 (one expert) an error row, as ``lax.top_k`` makes it in the JAX
    package."""
    base = {"vocab": [64], "n_heads": [4], "router_topk": [1]}
    rows = _rows({
        "spmd": [dict(base, router=["topk", "expert_choice"], capacity_factor=[1.25, 0.5]),
                 dict(base, router=["topk"], schedule=["1f1b"]),
                 dict(base, router=["topk"], mode=["forward"], mlp_kernel=["int8_weights"])],
        "compute_only": [dict(base, router=["topk", "expert_choice"], mode=["train"])],
    })
    assert len(rows) == 8
    for row in rows:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
    (bad,) = _rows({"spmd": [{"vocab": [64], "n_heads": [4], "router": ["topk"],
                              "router_topk": [2]}]})
    assert not bad["valid"] and "out of range" in bad["error"], bad["error"]


def test_serving_refuses_the_learned_routers():
    from ddlb_tpu_torch.models import decode as dec

    mesh = Runtime("cpu").mesh(1, 1)
    for router in T.LEARNED_ROUTERS:
        cfg = T.TransformerConfig(**COMMON, router=router)
        for make in (dec.make_decode_fn, dec.make_prefill_fn):
            with pytest.raises(ValueError, match=f"router='{router}' is a training-side"):
                make(mesh, cfg)


def test_router_leaf_follows_param_specs():
    """The gate is staged on pp and whole on tp (JAX ``param_specs``), and
    the stage stack's arrangement moves it with the other stage leaves."""
    from ddlb_tpu_torch.models.pipeline import arrange_stage_stack

    cfg = T.TransformerConfig(**COMMON, router="topk")
    assert J.param_specs(J.TransformerConfig(**COMMON, router="topk"))["router"] == \
        jax.sharding.PartitionSpec("pp", None, None, None)
    assert T.param_axes(cfg, ["router"]) == {"router": {"pp": 0}}
    full = T.init_params(cfg, 4, n_experts=2)
    assert full["router"].dtype == torch.float32 and full["router"].shape == (4, 1, 32, 2)
    part = T.shard_params(full, cfg, 2, 1, 2, 1)
    assert torch.equal(part["router"], full["router"][2:4])
    arranged = arrange_stage_stack(full, 2, 2)  # no cfg: every leaf known
    assert torch.equal(arranged["router"], full["router"][[0, 2, 1, 3]])
