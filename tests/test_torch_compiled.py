"""The ``compiled`` members (the JAX package's ``xla_gspmd``) on the CPU,
at world 1; ``test_torch_compiled_multirank.py`` runs them on a 2-rank
gloo world.

Each member writes its JAX twin's global program on DTensors and compiles
it with ``torch.compile(fullgraph=True)``; on the CPU no Inductor option
is passed (``build_compile_options`` returns None, as the JAX package
passes none off the TPU). Against the twins, the JAX package's
``xla_gspmd`` members on one device of the CPU simulation (the model
members through a JAX runtime narrowed to that device, since their meshes
span every device the runtime lists):

- the GEMM families (``tp_columnwise``, ``tp_rowwise``, ``dp_allreduce``,
  ``ep_alltoall``) in float32 and bfloat16 within the families'
  ``validation_atol``; the ``collectives`` ops bit for bit (data movement,
  or a sum of one term);
- ``transformer_step``: the loss (forward, and the train step's) within
  ``reference_loss``'s 1e-4 (float32) / 2e-2 (bfloat16), and the
  parameters after one AdamW step under the update rule of
  ``test_torch_transformer_step.py`` (2e-6 where the update is insensitive,
  2 * lr where a tiny gradient makes it follow its last bits);
- ``transformer_decode``: the decode and prefill logits within 1e-4.

Then ``make_full_width_fns`` against the oracle, the compiler knobs, the
rejections and the runner's warm-up rule. The int8 rows and the learned
routers are ``test_torch_compiled_models.py``; the shipped
``config_transformer_step.json`` entry through the CLI and CLI sweeps back
to back in one process are ``test_torch_compiled_sweeps.py`` (files of
their own, so that the test runner's workers can share them).
"""

import contextlib
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu.runtime import Runtime as JaxRuntime
from ddlb_tpu.runtime import as_auto_mesh
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.primitives.base import validation_atol
from ddlb_tpu_torch.primitives.compile_options import (
    GSPMD_ALLOWED_VALUES,
    GSPMD_DEFAULT_OPTIONS,
    build_compile_options,
)
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port

REPO = Path(__file__).resolve().parent.parent

#: the JAX package's xla_gspmd members as the twins, shared with
#: test_torch_compiled_multirank.py
M, N, K = 64, 32, 48
GEMM_FAMILIES = ["tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall"]
OPS = ["all_gather", "all_reduce", "reduce_scatter", "all_to_all", "ppermute"]
#: transformer_step at 2 layers: (m, n, k) and options
STEP_SHAPE = (16, 32, 64)
STEP = dict(vocab=64, n_heads=4, layers_per_stage=2, batch=2, microbatches=1)
#: transformer_decode at 2 layers
DECODE_SHAPE = (16, 32, 64)
DECODE = dict(vocab=64, n_heads=4, layers=2, batch=4)
LR, WD = 1e-2, 1e-4


@contextlib.contextmanager
def jax_devices(n):
    """The JAX runtime narrowed to its first ``n`` devices, so that a model
    member's mesh (which spans every device the runtime lists) is n wide."""
    rt = JaxRuntime()
    saved = rt.devices, rt.num_devices
    rt.devices, rt.num_devices = saved[0][:n], n
    try:
        yield
    finally:
        rt.devices, rt.num_devices = saved


def tp_mesh(n):
    """An n-device mesh whose axis GSPMD may place freely (as the twins'
    own model meshes are): on an explicit one-device mesh JAX asks the
    contracted tp_rowwise product for an output sharding."""
    return as_auto_mesh(jax.make_mesh((n,), ("tp",), devices=jax.devices()[:n]))


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def rows_of(family, op, rank, d, full):
    """This rank's part of a twin's global result, as the port's member
    returns it."""
    if family in ("tp_columnwise", "dp_allreduce") or op in ("all_gather", "all_reduce"):
        return full
    rows = full.shape[0] // d
    return full[rank * rows:(rank + 1) * rows]


def gemm_twin(family, dtype, d, op=None):
    opts = {"op": op} if op else {}
    n = 8 if op else N
    return host(load_jax(family, "xla_gspmd")(M, n, K, dtype=dtype, mesh=tp_mesh(d),
                                               **opts).run())


def adam_atol(init, new):
    u = np.abs((init - new) / LR - WD * init)
    return np.where((u > 1e-3) & (u < 0.99), 2 * LR, 2e-6)


def step_twin(mode, dtype, dp, tp, pp):
    """The JAX member's (loss, parameters before, parameters after)."""
    with jax_devices(dp * tp * pp):
        ref = load_jax("transformer_step", "xla_gspmd")(
            *STEP_SHAPE, dtype=dtype, mode=mode, dp=dp, tp=tp, pp=pp, **STEP)
        before = {name: np.asarray(v, np.float32) for name, v in ref.get_inputs()[0].items()}
        out = ref.run()
    if mode == "forward":
        return float(out), before, None
    return float(out[-1]), before, {name: np.asarray(v, np.float32)
                                    for name, v in out[0].items()}


def decode_twin(phase, dp, tp):
    with jax_devices(dp * tp):
        ref = load_jax("transformer_decode", "xla_gspmd")(
            *DECODE_SHAPE, dtype="float32", phase=phase, dp=dp, tp=tp, **DECODE)
        out = ref.run()  # prefill: (logits, cache)
    return np.asarray(out[0] if phase == "prefill" else out, np.float32)


# -- world 1 ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", GEMM_FAMILIES)
def test_gemm_member_matches_jax_at_world_one(family, dtype):
    impl = load_port(family, "compiled")(M, N, K, dtype=dtype, device="cpu")
    got = impl.run()
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(host(got), gemm_twin(family, dtype, 1), rtol=0,
                               atol=validation_atol(dtype, K))
    assert impl.validate(got)
    assert impl.inductor_options is None  # no Inductor option on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax_at_world_one(op, dtype):
    impl = load_port("collectives", "compiled")(M, 8, K, dtype=dtype, device="cpu", op=op)
    got = impl.run()
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(host(got), gemm_twin("collectives", dtype, 1, op))
    assert impl.validate(got)
    assert impl.wire_bytes() == 0.0


@pytest.mark.parametrize("mode,dtype", [("forward", "float32"), ("forward", "bfloat16"),
                                        ("train", "float32")])
def test_step_matches_jax_at_world_one(mode, dtype):
    impl = load_port("transformer_step", "compiled")(
        *STEP_SHAPE, dtype=dtype, device="cpu", mode=mode, dp=1, tp=1, pp=1, **STEP)
    before = {name: p.to_local().clone() for name, p in impl._args[0].items()}
    out = impl.run()
    assert impl.validate(out)
    want_loss, init, want = step_twin(mode, dtype, 1, 1, 1)
    loss = out if mode == "forward" else out[-1]
    assert float(loss) == pytest.approx(want_loss, abs=1e-4 if dtype == "float32" else 2e-2)
    if mode == "train":
        params, state, _ = out
        assert int(state["count"]) == 1
        for name, new in want.items():
            assert torch.equal(impl._args[0][name].to_local(), before[name])  # functional
            err = np.abs(params[name].numpy() - new)
            assert np.all(err <= adam_atol(init[name], new)), (name, float(err.max()))


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_decode_matches_jax_at_world_one(phase):
    impl = load_port("transformer_decode", "compiled")(
        *DECODE_SHAPE, dtype="float32", device="cpu", phase=phase, dp=1, tp=1, **DECODE)
    got = impl.run()
    assert got.shape == (DECODE["batch"], DECODE["vocab"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), decode_twin(phase, 1, 1), rtol=0, atol=1e-4)
    assert impl.validate(got)
    if phase == "decode":  # a repeated step reads the same cache
        np.testing.assert_array_equal(impl.run().numpy(), got.numpy())


def test_k7_operators_pass_opcheck():
    """``ddlb::int8_matmul`` (each output dtype, both weight layouts) and
    ``ddlb::int8_ste_matmul`` (with its straight-through gradient) pass
    ``torch.library.opcheck``: schema, fake implementation, autograd
    registration and AOT dispatch."""
    from ddlb_tpu_torch.ops import quantized_matmul as qm

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (12, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (32, 24)).astype(np.float32))
    (aq, sa), (bq, sb) = qm.quantize_rowwise(x), qm.quantize_colwise(w)
    for weight in (bq, bq.contiguous()):
        for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
            torch.library.opcheck(torch.ops.ddlb.int8_matmul.default,
                                  (aq, weight, sa, sb, out_dtype))
    torch.library.opcheck(torch.ops.ddlb.int8_ste_matmul.default,
                          (x.clone().requires_grad_(True), w.clone().requires_grad_(True)))


def test_k7_sharding_rules():
    """DTensor runs both K7 operators by their rules: rows of the
    activation sharded with the weight replicated give sharded rows, every
    operand replicated a replicated result, and a sharded weight is
    gathered first; each the plain result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ddlb_tpu_torch.ops import quantized_matmul as qm
    from ddlb_tpu_torch.runtime import Runtime

    mesh = Runtime("cpu").device_mesh(("tp",), (1,))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (32, 16)).astype(np.float32))
    (aq, sa), (bq, sb) = qm.quantize_rowwise(x), qm.quantize_colwise(w)
    want_ste = qm.int8_ste_matmul(x, w)
    want = qm.int8_matmul_kernel(aq, bq, sa, sb, out_dtype=torch.float32)

    def on(t, p):
        return DTensor.from_local(t, mesh, [p], run_check=False)

    for pa, pw, out in ((Shard(0), Replicate(), Shard(0)), (Replicate(), Replicate(), Replicate()),
                        (Replicate(), Shard(1), Replicate())):
        got = qm.int8_ste_matmul(on(x, pa), on(w, pw))
        assert got.placements == (out,)
        assert torch.equal(got.full_tensor(), want_ste)
        got = qm.int8_matmul_kernel(on(aq, pa), on(bq, pw), on(sa, pa), on(sb, pw),
                                    out_dtype=torch.float32)
        assert got.placements == (out,)
        assert torch.equal(got.full_tensor(), want)


def test_decode_registers_rules_before_its_setup_prefill(monkeypatch):
    """The decode member's set-up prefill runs on DTensors before the
    compile: the sharding rules ``register_missing_rules`` adds (the card's
    float32 LM head, ``aten.mm.dtype``) are registered first. Without them
    a process whose first compiled row was a decode failed on the card."""
    from ddlb_tpu_torch.primitives.transformer_decode import compiled as member

    calls = []
    make = member.make_full_width_fns

    def traced(*args):
        decode_fwd, prefill_fwd = make(*args)

        def prefill(*a):
            calls.append("prefill")
            return prefill_fwd(*a)

        return decode_fwd, prefill

    monkeypatch.setattr(member, "register_missing_rules", lambda: calls.append("rules"))
    monkeypatch.setattr(member, "make_full_width_fns", traced)
    load_port("transformer_decode", "compiled")(*DECODE_SHAPE, dtype="float32", device="cpu",
                                                 phase="decode", **DECODE)
    assert calls == ["rules", "prefill"]


def test_full_width_fns_match_the_oracle():
    """``make_full_width_fns`` on plain tensors: prefill then a decode step
    are the oracle's logits at the last prompt position and at the next
    one (int8 cache, rope and a window through the same path)."""
    from ddlb_tpu_torch.models import decode as dec
    from ddlb_tpu_torch.models.transformer import TransformerConfig, example_tokens, init_params

    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                            layers_per_stage=2, rope=True, attn_window=6, kv_cache="int8")
    B, S = 4, 12
    params = init_params(cfg, 1, n_experts=2, seed=3)
    tokens = torch.from_numpy(example_tokens(B, S + 1, 64, seed=3)[0])
    decode_fwd, prefill_fwd = dec.make_full_width_fns(cfg, B, 1, 2)
    empty = dec.init_cache(cfg, B, S + 1, device="cpu")
    logits, cache = prefill_fwd(params, empty, tokens[:, :S])
    np.testing.assert_allclose(
        logits.numpy(), dec.reference_logits(params, tokens[:, :S], cfg, tp=2, dp=1).numpy(),
        rtol=0, atol=1e-2)
    step = decode_fwd(params, cache, tokens[:, S], torch.tensor(S))
    np.testing.assert_allclose(
        step.numpy(), dec.reference_logits(params, tokens, cfg, tp=2, dp=1).numpy(),
        rtol=0, atol=1e-2)
    # functional: the caches given are as they were
    assert all(not t.any() for t in empty.values())
    assert not cache["k"][:, :, S].any()


# -- the knobs, the rejections, the runner --------------------------------------------


def _knob_grid():
    return [dict(zip(GSPMD_ALLOWED_VALUES, values))
            for values in itertools.product(*GSPMD_ALLOWED_VALUES.values())]


@pytest.mark.parametrize("options", _knob_grid(), ids=str)
def test_compile_options(options):
    if not options["async_collective_fusion"]:
        for platform in ("cuda", "cpu"):
            with pytest.raises(ValueError, match="async_collective_fusion=False"):
                build_compile_options(options, platform)
        return
    assert build_compile_options(options, "cpu") is None
    got = build_compile_options(options, "cuda")
    want = {"reorder_for_compute_comm_overlap": options["latency_hiding_scheduler"],
            "emulate_precision_casts": True}
    cm = options["collective_matmul"]
    if cm != "auto":
        want["_micro_pipeline_tp"] = cm == "force"
    assert got == want
    import torch._inductor.config as inductor_config

    for key in got:  # every key is an Inductor setting of this torch
        assert hasattr(inductor_config, key)


def test_added_sharding_rules():
    """``aten.mm.dtype`` (the float32 head on the card) takes ``aten.mm``'s
    placements once registered, checked on meta tensors (the CPU has no
    ``mm.dtype`` kernel); ``aten.roll`` stays sharded only off the rolled
    dimension."""
    import types

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ddlb_tpu_torch.primitives.compile_options import register_missing_rules, roll_rule
    from ddlb_tpu_torch.runtime import Runtime

    mesh = Runtime("cpu").device_mesh(("tp",), (1,))
    register_missing_rules()
    a = torch.empty(8, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(4, 6, dtype=torch.bfloat16, device="meta")
    for pa, pb, want in ((Shard(0), Replicate(), Shard(0)), (Shard(1), Shard(0), Partial()),
                         (Replicate(), Shard(1), Shard(1))):
        out = torch.mm(DTensor.from_local(a, mesh, [pa], run_check=False),
                       DTensor.from_local(b, mesh, [pb], run_check=False),
                       out_dtype=torch.float32)
        assert out.placements == (want,) and out.dtype == torch.float32
        assert out.shape == (8, 6)
    x = types.SimpleNamespace(ndim=3)
    assert roll_rule(x, [4], [0]) == [([Replicate()], [Replicate(), None, None]),
                                      ([Shard(1)], [Shard(1), None, None]),
                                      ([Shard(2)], [Shard(2), None, None])]
    assert roll_rule(x, [4]) == [([Replicate()], [Replicate(), None, None])]


def test_device_meshes_that_keep_the_same_axes_are_one():
    """``Runtime.device_mesh`` leaves out axes of size 1, and two requests
    that keep the same axes get one ``DeviceMesh``: under torch 2.13 an
    equal second mesh broke the next compiled backward in the process
    (``test_torch_tp_mlp.py``'s (1, 1) step, then a compiled
    ``transformer_step`` at (1, 1, 1): "Node tangents_2 was invalid")."""
    from ddlb_tpu_torch.runtime import Runtime

    rt = Runtime("cpu")
    mesh = rt.device_mesh(("dp", "tp"), (1, 1))
    assert mesh is rt.device_mesh(("dp", "tp", "pp"), (1, 1, 1))
    assert mesh.mesh_dim_names == ("dp",)


def test_option_schema_is_the_jax_packages():
    from ddlb_tpu.primitives.xla_options import GSPMD_ALLOWED_VALUES as JAX_ALLOWED
    from ddlb_tpu.primitives.xla_options import GSPMD_DEFAULT_OPTIONS as JAX_DEFAULTS

    assert GSPMD_DEFAULT_OPTIONS == JAX_DEFAULTS and GSPMD_ALLOWED_VALUES == JAX_ALLOWED

    for family in GEMM_FAMILIES + ["collectives", "transformer_step", "transformer_decode"]:
        ours = load_port(family, "compiled")
        assert ours.option_schema() == load_jax(family, "xla_gspmd").option_schema(), family


@pytest.mark.parametrize(
    "family,shape,options,match",
    [
        ("tp_rowwise", (M, N, K), {"async_collective_fusion": False},
         "async_collective_fusion=False has no counterpart"),
        ("transformer_step", STEP_SHAPE, {"attn_kernel": "flash", **STEP},
         "attn_kernel='flash' applies to the spmd member"),
        ("transformer_step", STEP_SHAPE, {"mlp_kernel": "int8_weights", **STEP},
         "mlp_kernel='int8_weights'.*requires mode='forward'"),
        ("transformer_decode", DECODE_SHAPE, {"attn_kernel": "flash", **DECODE},
         "attn_kernel='flash' applies to the spmd member"),
        ("transformer_decode", DECODE_SHAPE, {"decode_kernel": "pallas", **DECODE},
         "decode_kernel='pallas' applies to the spmd member"),
        ("transformer_decode", DECODE_SHAPE, {"phase": "generate", **DECODE},
         "phase='generate'.*measures the single decode/prefill step"),
        ("transformer_decode", DECODE_SHAPE, {"phase": "serve", **DECODE},
         "phase='serve'.*measures the single decode/prefill step"),
    ],
)
def test_rejections(family, shape, options, match):
    with pytest.raises(ValueError, match=match):
        load_port(family, "compiled")(*shape, dtype="float32", device="cpu", **options)


def test_runner_needs_a_warmup(tmp_path):
    """The first call compiles: a compiled row without a warm-up is an
    error row, not a timed compile."""
    rows = port_cli.run_benchmark({
        "primitive": "tp_rowwise", "m": M, "n": N, "k": K, "dtype": "float32",
        "device": "cpu", "num_iterations": 1, "num_warmups": 0,
        "output_csv": str(tmp_path / "rows.csv"),
        "implementations": {"compiled": [{}], "pytorch": [{}]},
    })
    by = {r["base_implementation"]: r for r in rows}
    assert "num_warmups must be >= 1" in by["compiled"]["error"]
    assert not by["compiled"]["valid"] and by["pytorch"]["valid"]
