"""The ``pp_pipeline`` family against the JAX package at world 1, on the
CPU.

Every member (``compute_only`` both sizes, ``pytorch`` for ``jax_spmd``,
``schedules`` in each schedule, ``compiled`` for ``xla_gspmd``) at m = n =
k = 32 (float32 and bfloat16) on the seeded operands both packages draw,
against the JAX member on a one-device mesh of the CPU simulation:

- the outputs (and the ``schedules`` member's stage gradients) within
  1e-5 in float32 (the same products in other summation orders) and one
  bf16 spacing in bfloat16 (each stage's product rounded once on both
  sides);
- the oracles, both computed by the JAX code on the same seed: the chain
  (``_expected_full``) within 1e-5 relative, the stage gradients
  (``_expected_grads``, sums of order 10 in float32 in other orders)
  within 1e-5 relative plus 1e-5 absolute;
- the members' own validation, ``flops()`` against the JAX census, the
  schedule tables against the JAX member's, the option rules and the
  rejections, and both of the repo's pipeline configs through the port's
  CLI at a small shape.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.primitives import registry
from ddlb_tpu_torch.primitives.registry import load_impl_class
from torch_parity import assert_within_bf16_ulps, to_numpy

M = N = K = 32
CASES = [
    ("compute_only", {"size": "sharded"}),
    ("compute_only", {"size": "unsharded"}),
    ("pytorch", {"microbatches": 1}),
    ("pytorch", {"microbatches": 4}),
    ("schedules", {"schedule": "gpipe", "microbatches": 4}),
    ("schedules", {"schedule": "1f1b", "microbatches": 2}),
    ("schedules", {"schedule": "interleaved", "virtual": 2, "microbatches": 4}),
    ("schedules", {"schedule": "gpipe", "virtual": 3, "microbatches": 2}),
    ("compiled", {}),
]
JAX_NAMES = {"pytorch": "jax_spmd", "compiled": "xla_gspmd"}


def _jax_member(name, dtype, opts):
    mesh = jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])
    return load_jax("pp_pipeline", JAX_NAMES.get(name, name))(
        M, N, K, dtype=dtype, mesh=mesh, **opts)


def _assert_close(got, want, dtype, what):
    if dtype == "bfloat16":
        assert_within_bf16_ulps(got, want, 1.0)
    else:
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=0, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,opts", CASES, ids=lambda x: str(x))
def test_member_matches_the_jax_member(name, opts, dtype):
    impl = load_impl_class("pp_pipeline", name)(M, N, K, dtype=dtype, device="cpu", **opts)
    twin = _jax_member(name, dtype, opts)
    out, want = impl.run(), twin.run()
    assert impl.flops() == twin.flops()
    np.testing.assert_allclose(impl._expected_full(), twin._expected_full(), rtol=1e-5, atol=0)
    if name == "schedules":
        (y, dw), (want_y, want_dw) = out, want
        _assert_close(y, want_y, dtype, "y")
        # both executors sum dW in float32 from the same rounded products
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(impl._expected_grads(), twin._expected_grads(),
                                   rtol=1e-5, atol=1e-5)
        for table in ("kind", "mb", "act_slot", "fwd_land", "bwd_land"):
            np.testing.assert_array_equal(getattr(impl.tables, table),
                                          getattr(twin.tables, table))
        assert impl.tables.peak_stash == twin.tables.peak_stash
    else:
        _assert_close(out, want, dtype, name)
    valid = impl.validate(out)
    if name == "schedules" and dtype == "bfloat16" and opts.get("virtual") == 3:
        # the JAX oracle holds bf16 gradients to float32 draws at
        # 1e-3 * m * S = 0.096 here: at m = 32 a three-deep chain's bf16
        # rounding exceeds it, for the JAX member as for the port
        assert valid is False and twin.validate(want) is False
    else:
        assert valid is True


def test_members_and_names():
    assert registry.implementation_names("pp_pipeline") == (
        "compute_only", "pytorch", "schedules", "compiled")
    assert "pp_pipeline" in registry.ALLOWED_PRIMITIVES
    with pytest.raises(ValueError, match="Unknown primitive 'pp_pipelines'"):
        registry.check_primitive("pp_pipelines")
    assert registry.throughput_unit("pp_pipeline") == "TFLOPS"
    for port_name, jax_name in JAX_NAMES.items():
        assert registry.port_member_name(jax_name) == port_name
        with pytest.raises(ValueError, match=f"counterpart is '{port_name}'"):
            load_impl_class("pp_pipeline", jax_name)


@pytest.mark.parametrize("name", ["compute_only", "pytorch", "schedules", "compiled"])
def test_option_schema_is_the_jax_packages(name):
    from ddlb_tpu.primitives.registry import load_impl_class as jax_class

    got = load_impl_class("pp_pipeline", name).option_schema()
    want = jax_class("pp_pipeline", JAX_NAMES.get(name, name)).option_schema()
    assert got[0] == want[0]
    assert {k: list(v) if isinstance(v, list) else v for k, v in got[1].items()} == \
        {k: list(v) if isinstance(v, list) else v for k, v in want[1].items()}


@pytest.mark.parametrize(
    "name,shape,opts,match",
    [
        ("pytorch", (32, 32, 16), {}, "k=16 must equal n=32"),
        ("compute_only", (32, 32, 32), {"dtype": "int32"}, "requires a floating dtype"),
        ("pytorch", (30, 32, 32), {"microbatches": 4}, "m=30 must be divisible by microbatches=4"),
        ("schedules", (30, 32, 32), {"microbatches": 4}, "must be divisible by microbatches"),
        ("schedules", (32, 32, 32), {"schedule": "1f1b", "virtual": 2}, "use 'interleaved'"),
        ("schedules", (32, 32, 32), {"schedule": "interleaved"}, "needs virtual >= 2"),
        ("schedules", (32, 32, 32), {"virtual": 9}, "virtual"),
    ],
)
def test_rejections(name, shape, opts, match):
    opts = dict(opts)
    dtype = opts.pop("dtype", "float32")
    with pytest.raises(ValueError, match=match):
        load_impl_class("pp_pipeline", name)(*shape, dtype=dtype, device="cpu", **opts)


def test_schedules_stash_is_allocated_at_the_tables_size():
    """The stash the step allocates is ``peak_stash`` slots: 1f1b's is one
    slot where gpipe's holds every microbatch."""
    sizes = {}
    for schedule in ("gpipe", "1f1b"):
        impl = load_impl_class("pp_pipeline", "schedules")(
            M, N, K, dtype="float32", device="cpu", schedule=schedule, microbatches=4)
        seen = []
        real_empty = torch.empty

        def spy(*args, **kw):
            out = real_empty(*args, **kw)
            seen.append(tuple(out.shape))
            return out

        torch.empty = spy
        try:
            impl.run()
        finally:
            torch.empty = real_empty
        sizes[schedule] = (impl.tables.peak_stash, seen[0])
    assert sizes["gpipe"] == (4, (4, M // 4, K))
    assert sizes["1f1b"] == (1, (1, M // 4, K))


@pytest.mark.parametrize("config", ["config_pp_pipeline.json", "config_schedules.json"])
def test_configs_through_the_cli(config, tmp_path):
    """The repo's pipeline configs as shipped but for the shape and the
    iteration counts: every row valid on the CPU, in TFLOPS."""
    import json

    with open(Path(__file__).resolve().parent.parent / "scripts" / config) as f:
        cfg = json.load(f)
    cfg["benchmark"].update(m=[32], n=[32], k=[32], num_iterations=1, num_warmups=1,
                            device="cpu", output_csv=str(tmp_path / "rows.csv"))
    rows = port_cli.run_benchmark(cfg)
    assert len(rows) == {"config_pp_pipeline.json": 7, "config_schedules.json": 10}[config]
    for row in rows:
        assert row["valid"] and not row["error"], row
        assert row["unit"] == "TFLOPS" and row["Throughput (TFLOPS)"] > 0
