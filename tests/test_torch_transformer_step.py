"""The training step (``transformer_step``) against the JAX package at
world 1, on the CPU.

Tiny model (d_model 32, 4 heads of 8, d_ff 64, vocab 64, one layer,
microbatches 2, batch 4, sequence 32), float32, parameters made by the JAX
package's ``init_params`` and carried over bit for bit by
``params_from_numpy``. For each case (gathered and ring attention x flash
and einsum kernels, GQA, rope, a window, the int8 straight-through MLP):

- the loss against JAX's ``make_loss_fn`` and its ``reference_loss``:
  atol 1e-5 (the same float32 arithmetic in other summation orders), and
  the port's own ``reference_loss`` against JAX's at 1e-5;
- every gradient against ``jax.grad`` of the same loss: atol 1e-6 (the
  gradients are of order 1e-2 and agree to float32 rounding);
- the parameters after one AdamW step against ``optax.adamw(1e-2)``
  applied to JAX's gradients: atol 2e-6 where the update is insensitive
  (|u| >= 0.99 for u = g / (|g| + eps), and exact zeros), 2 * lr where a
  tiny gradient makes u follow its last bits.

Under ``mlp_kernel='int8'`` the gradient and loss tolerances are 1e-4:
a float32 rounding difference upstream can flip one quantization step
(JAX's own int8 tolerance is twice its float tolerance).

Then the members through the port's runner with ``device="cpu"``, the
``compute_only`` member against the same references, and the options
that are not ported.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from ddlb_tpu.models import transformer as J
from ddlb_tpu_torch.models import transformer as T
from ddlb_tpu_torch.runtime import Runtime

SEQ, BATCH = 32, 4
COMMON = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, microbatches=2)
LR, WD = 1e-2, 1e-4

CASES = {
    "gathered_flash": {},
    "gathered_einsum": {"attn_kernel": "einsum"},
    "ring_flash": {"attention": "ring"},
    "ring_einsum_gqa_rope": {"attention": "ring", "attn_kernel": "einsum",
                             "n_kv_heads": 2, "rope": True},
    "gathered_flash_gqa_rope": {"n_kv_heads": 2, "rope": True},
    "gathered_flash_window": {"attn_window": 12},
    "ring_flash_window": {"attention": "ring", "attn_window": 12},
    "int8": {"mlp_kernel": "int8", "attn_kernel": "einsum"},
}


def _jax_reference(opts, seeds=(0, 1)):
    """The JAX package's parameters (``init_params`` seed), tokens
    (``example_tokens`` seed), loss, oracle loss, gradients and the
    parameters after one ``optax.adamw`` step, on the host."""
    cfg = J.TransformerConfig(**COMMON, **opts)
    mesh = jax.make_mesh((1, 1, 1), ("dp", "tp", "pp"), devices=jax.devices()[:1])
    loss_fn, _ = J.make_loss_fn(mesh, cfg)
    params = J.init_params(cfg, 1, n_experts=1, seed=seeds[0])
    tokens, targets = J.example_tokens(BATCH, SEQ, cfg.vocab, seed=seeds[1])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, tokens, targets)
    optimizer = optax.adamw(LR)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    new = optax.apply_updates(params, updates)
    oracle = J.reference_loss(params, tokens, targets, cfg, tp=1)
    host = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    return (host(params), np.asarray(tokens), np.asarray(targets), float(loss),
            float(oracle), host(grads), host(new))


def _adam_atol(init, new):
    u = np.abs((init - new) / LR - WD * init)
    return np.where((u > 1e-3) & (u < 0.99), 2 * LR, 2e-6)


@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_step_matches_jax(case):
    opts = CASES[case]
    params, tokens, targets, loss, oracle, grads, new = _jax_reference(opts)
    cfg = T.TransformerConfig(**COMMON, **opts)
    tparams = T.params_from_numpy(params, cfg, device="cpu")
    ttok, ttgt = torch.from_numpy(tokens.copy()), torch.from_numpy(targets.copy())
    mesh = Runtime("cpu").mesh(1, 1, 1)
    tol = 1e-4 if opts.get("mlp_kernel") == "int8" else 1e-5
    gtol = 1e-4 if opts.get("mlp_kernel") == "int8" else 1e-6

    assert float(T.make_loss_fn(mesh, cfg)(tparams, ttok, ttgt)) == pytest.approx(loss, abs=tol)
    assert float(T.reference_loss(tparams, ttok, ttgt, cfg, tp=1)) == pytest.approx(oracle, abs=tol)
    tloss, tgrads = T.make_loss_and_grad_fn(mesh, cfg)(tparams, ttok, ttgt)
    assert float(tloss) == pytest.approx(loss, abs=tol)
    assert set(tgrads) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g, rtol=0, atol=gtol, err_msg=name)

    step, init_opt = T.make_train_step(mesh, cfg)
    snapshot = {k: v.clone() for k, v in tparams.items()}
    opt_state = init_opt(tparams)
    got, state, step_loss = step(tparams, opt_state, ttok, ttgt)
    assert float(step_loss) == pytest.approx(loss, abs=tol)
    assert int(state["count"]) == 1 and int(opt_state["count"]) == 0
    for name, want in new.items():
        assert torch.equal(tparams[name], snapshot[name])  # inputs untouched
        err = np.abs(got[name].numpy() - want)
        atol = _adam_atol(params[name], want)
        if opts.get("mlp_kernel") == "int8":
            atol = np.maximum(atol, 2 * LR * (np.abs(grads[name]) < 1e-3))
        assert np.all(err <= atol), (name, float(err.max()))


def test_adamw_matches_optax_over_steps():
    """Three AdamW updates on fixed gradients against optax.adamw(1e-2),
    float32 at atol 1e-7 and bfloat16 (moments in bf16, as optax keeps
    them) within two bf16 spacings of the parameter (the two frameworks
    round the python constants differently in bf16: after three steps a
    few elements sit one spacing apart)."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(0, 1, (8, 5)).astype(np.float32),
         "b": rng.normal(0, 1, (7,)).astype(np.float32)}
    gs = [{k: rng.normal(0, 1e-2, v.shape).astype(np.float32) for k, v in p.items()}
          for _ in range(3)]
    for dtype, jdtype in ((torch.float32, np.float32), (torch.bfloat16, jax.numpy.bfloat16)):
        opt = optax.adamw(LR)
        jp = {k: jax.numpy.asarray(v, jdtype) for k, v in p.items()}
        js = opt.init(jp)
        tp = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
        ts = T.adamw_init(tp)
        for g in gs:
            jg = {k: jax.numpy.asarray(v, jdtype) for k, v in g.items()}
            upd, js = opt.update(jg, js, jp)
            jp = optax.apply_updates(jp, upd)
            tp, ts = T.adamw_update(tp, {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}, ts)
        for k in p:
            want = np.asarray(jp[k]).astype(np.float32)
            got = tp[k].float().numpy()
            assert tp[k].dtype == dtype
            atol = 1e-7 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(np.abs(want))) - 6)
            assert np.all(np.abs(got - want) <= atol), (dtype, k)


def test_second_step_continues_optax_state():
    """The JAX step's parameters and optax state after one step, carried
    over (``params_from_numpy``, ``adamw_state_from_numpy``), then one more
    step on each side: the parameters within the first step's tolerance
    and the moments within 1e-7 (float32, gathered flash)."""
    cfg_j = J.TransformerConfig(**COMMON)
    cfg = T.TransformerConfig(**COMMON)
    mesh_j = jax.make_mesh((1, 1, 1), ("dp", "tp", "pp"), devices=jax.devices()[:1])
    step_j, init_opt, _ = J.make_train_step(mesh_j, cfg_j, donate=False)
    params = J.init_params(cfg_j, 1, n_experts=1)
    tokens, targets = J.example_tokens(BATCH, SEQ, cfg_j.vocab)
    p1, s1, _ = step_j(params, init_opt(params), tokens, targets)
    p2, s2, loss2 = step_j(p1, s1, tokens, targets)
    host = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    adam = s1[0]
    tp1 = T.params_from_numpy(host(p1), cfg, device="cpu")
    state = T.adamw_state_from_numpy(adam.count, host(adam.mu), host(adam.nu), cfg,
                                     device="cpu")
    assert int(state["count"]) == 1
    step, _ = T.make_train_step(Runtime("cpu").mesh(1, 1, 1), cfg)
    got, got_state, loss = step(tp1, state, torch.from_numpy(np.array(tokens)),
                                torch.from_numpy(np.array(targets)))
    assert float(loss) == pytest.approx(float(loss2), abs=1e-5)
    assert int(got_state["count"]) == 2
    for name, want in host(p2).items():
        err = np.abs(got[name].numpy() - want)
        assert np.all(err <= _adam_atol(host(p1)[name], want) + 2e-6), name
        for moment in ("mu", "nu"):
            np.testing.assert_allclose(got_state[moment][name].numpy(),
                                       np.asarray(getattr(s2[0], moment)[name]),
                                       rtol=1e-4, atol=1e-7, err_msg=f"{moment} {name}")


def test_int8_ste_matmul_matches_jax():
    """The straight-through product: forward bit for bit the JAX
    package's compiled one (the same quantization and epilogue on the
    plain K7), and
    both gradients its custom_vjp's (a float32 cotangent against the
    original operands) within float32 summation order."""
    from ddlb_tpu.ops.quantized_matmul import int8_ste_matmul as jax_ste
    from ddlb_tpu_torch.ops.quantized_matmul import int8_ste_matmul

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (24, 40)).astype(np.float32)
    w = rng.normal(0, 0.2, (40, 16)).astype(np.float32)
    g = rng.normal(0, 1, (24, 16)).astype(np.float32)
    # compiled, as the JAX model calls it (eagerly JAX divides by 127 where
    # XLA multiplies by 1/127: a scale can differ in its last bit)
    out_j, vjp = jax.vjp(jax.jit(jax_ste), jax.numpy.asarray(x), jax.numpy.asarray(w))
    dx_j, dw_j = vjp(jax.numpy.asarray(g))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = int8_ste_matmul(tx, tw)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=0, atol=1e-5)


def _run(rows_config):
    from ddlb_tpu_torch.cli.benchmark import run_benchmark

    return run_benchmark({
        "primitive": "transformer_step", "m": SEQ, "n": 32, "k": 64,
        "dtype": "float32", "device": "cpu", "num_iterations": 1,
        "num_warmups": 1, "output_csv": None, **rows_config,
    })


def test_members_through_the_runner(tmp_path):
    """spmd (train and forward, gathered and ring) and compute_only rows
    of ``scripts/config_transformer_step.json``'s kinds, at a tiny width,
    valid against the oracle; the row's flops are the JAX census."""
    rows = _run({
        "output_csv": str(tmp_path / "rows.csv"),
        "implementations": {
            "spmd": [{"mode": ["train", "forward"], "vocab": [64], "n_heads": [4],
                      "attention": ["gathered", "ring"], "attn_kernel": ["flash"]}],
            "compute_only": [{"mode": ["forward", "train"], "vocab": [64], "n_heads": [4]}],
        },
    })
    assert len(rows) == 6
    for row in rows:
        assert row["valid"] and not row["error"], row
        assert row["platform"] == "cpu" and np.isfinite(row["median time (ms)"])
    from ddlb_tpu.primitives.transformer_step.base import TransformerStep as JaxStep
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    for mode in ("train", "forward"):
        got = [r for r in rows if f"mode={mode}" in r["option"]]
        assert got and all(r["Throughput (TFLOPS)"] > 0 for r in got)
        impl = load_impl_class("transformer_step", "compute_only")(
            SEQ, 32, 64, dtype="float32", device="cpu", mode=mode, vocab=64, n_heads=4)
        # the JAX census on the same one-stage mesh (its own auto factors
        # see the simulation's eight devices)
        impl._total_stages = lambda: 1
        assert impl.flops() == JaxStep.flops(impl)


@pytest.mark.parametrize("mode", ["train", "forward"])
def test_compute_only_matches_the_oracle(mode):
    """The compute_only member's loss is the JAX oracle's; its train step
    returns new parameters and leaves its operands as they are."""
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    impl = load_impl_class("transformer_step", "compute_only")(
        SEQ, 32, 64, dtype="float32", device="cpu", mode=mode, vocab=64, n_heads=4,
        batch=BATCH)
    # the primitives draw parameters and tokens from their seed (42)
    params, _, _, _, oracle, _, new = _jax_reference({"attn_kernel": "einsum"}, (42, 42))
    before = {k: v.clone() for k, v in impl._args[0].items()}
    out = impl.run()
    assert impl.validate(out)
    loss = out[-1] if mode == "train" else out
    assert float(loss) == pytest.approx(oracle, abs=1e-5)
    if mode == "train":
        for name, want in new.items():
            assert torch.equal(impl._args[0][name], before[name])
            err = np.abs(out[0][name].numpy() - want)
            assert np.all(err <= _adam_atol(params[name], want)), name


@pytest.mark.parametrize(
    "options,match",
    [
        ({"router": "topk"}, "router='topk'.*not yet ported.*ROADMAP.md"),
        ({"router": "expert_choice"}, "router='expert_choice'.*not yet ported"),
        ({"mlp_kernel": "int8_weights", "mode": "forward"}, "int8_weights.*not yet ported"),
        ({"mlp_kernel": "int8_weights"}, "requires mode='forward'"),
        ({"schedule": "1f1b"}, "schedule='1f1b'.*not yet ported.*ROADMAP.md"),
        ({"schedule": "interleaved", "virtual": 2}, "schedule='interleaved'.*not yet ported"),
        ({"virtual": 2}, "virtual > 1.*not yet ported"),
        ({"schedule": "1f1b", "mode": "forward"}, "is a training schedule"),
        ({"dp": 2, "tp": 1, "pp": 1}, "dp\\*tp\\*pp = 2 != 1"),
        ({"n_heads": 5}, "divisible by n_heads=5"),
        ({"batch": 3}, "not divisible by dp\\*microbatches"),
    ],
)
def test_rejections(options, match):
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    opts = {"vocab": 64, "n_heads": 4, **options}
    with pytest.raises(ValueError, match=match):
        load_impl_class("transformer_step", "spmd")(SEQ, 32, 64, dtype="float32",
                                                    device="cpu", **opts)


def test_compute_only_refuses_flash():
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    with pytest.raises(ValueError, match="einsum"):
        load_impl_class("transformer_step", "compute_only")(
            SEQ, 32, 64, dtype="float32", device="cpu", attn_kernel="flash")


def test_option_schema_is_the_jax_packages():
    from ddlb_tpu.primitives.registry import load_impl_class as load_jax
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    for member in ("spmd", "compute_only"):
        assert (load_impl_class("transformer_step", member).option_schema()
                == load_jax("transformer_step", member).option_schema())


@pytest.mark.parametrize("tp,pp,ring", [(2, 1, False), (2, 2, False), (4, 1, True), (1, 2, True)])
def test_shard_params_follow_param_specs(tp, pp, ring):
    """The slices ``shard_params`` cuts are the blocks of JAX's
    ``param_specs`` (stage axis on pp; heads, output rows and experts on
    tp; attention projections whole under ring attention)."""
    opts = {"attention": "ring"} if ring else {}
    cfg = T.TransformerConfig(**COMMON, **opts)
    jcfg = J.TransformerConfig(**COMMON, **opts)
    full = T.init_params(cfg, pp, n_experts=tp)
    specs = J.param_specs(jcfg)
    for t_i in range(tp):
        for p_i in range(pp):
            part = T.shard_params(full, cfg, tp, t_i, pp, p_i)
            for name, spec in specs.items():
                want = full[name]
                for dim, axis in enumerate(spec):
                    n, at = {"tp": (tp, t_i), "pp": (pp, p_i), None: (1, 0)}[axis]
                    width = want.shape[dim] // n
                    want = want.narrow(dim, at * width, width)
                assert torch.equal(part[name], want), (name, t_i, p_i)


def test_mesh_places_ranks_as_jax_make_mesh():
    """rank = (dp_i * tp + tp_i) * pp + pp_i, the row-major order of
    ``jax.make_mesh``'s device array."""
    from ddlb_tpu_torch.runtime import Mesh

    for dp, tp, pp in ((2, 2, 2), (1, 2, 4), (4, 1, 2)):
        devices = np.asarray(jax.make_mesh((dp, tp, pp), ("dp", "tp", "pp")).devices)
        ids = np.vectorize(lambda d: d.id)(devices)
        order = np.argsort(ids.ravel())
        for rank in range(dp * tp * pp):
            coords = np.unravel_index(order[rank], (dp, tp, pp))
            mesh = Mesh.__new__(Mesh)
            mesh.dp, mesh.tp, mesh.pp = dp, tp, pp
            assert mesh.rank_at(*coords) == rank
            assert (rank // (tp * pp), rank // pp % tp, rank % pp) == tuple(coords)
