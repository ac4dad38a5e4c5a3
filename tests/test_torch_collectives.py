"""The port's collectives family at world 1 against the JAX members on a
one-device mesh of the CPU simulation, from the same numpy seed; its
metric against the JAX package's for d = 1..4; its row unit; its option
and shape rules; and ``scripts/config_collectives.json`` through the
port's CLI on the CPU at a small shape.

At world 1 every op is a copy (or the sum of one summand), so the rows are
compared bit for bit; ``test_torch_multirank.py`` runs every member at
d = 2 against the JAX members on a two-device mesh. The JAX
``strategy=hierarchical`` builds its own mesh over every simulated device,
so the port's hierarchical row is held to JAX's ``rs_ag``, the
decomposition it degenerates to on one node.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu.primitives.registry import throughput_unit as jax_unit
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.options import OptionsManager
from ddlb_tpu_torch.primitives import registry
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port
from torch_parity import bits

REPO = Path(__file__).resolve().parent.parent
M, N, K = 32, 8, 64
OPS = ["all_gather", "all_reduce", "reduce_scatter", "all_to_all", "ppermute"]

#: (port member, options, JAX member, JAX options)
PAIRS = (
    [("compute_only", {"size": s}, "compute_only", {"size": s})
     for s in ("sharded", "unsharded")]
    + [("pytorch", {"op": op}, "jax_spmd", {"op": op}) for op in OPS]
    + [("pytorch", {"op": "all_reduce", "strategy": "rs_ag"}, "jax_spmd",
        {"op": "all_reduce", "strategy": "rs_ag"}),
       ("pytorch", {"op": "all_reduce", "strategy": "hierarchical"}, "jax_spmd",
        {"op": "all_reduce", "strategy": "rs_ag"})]
    + [("cuda", {"op": op}, "pallas", {"op": op})
       for op in ("all_gather", "reduce_scatter", "all_reduce")]
)


def _one_device_mesh():
    return jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ours,options,theirs,their_options", PAIRS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_member_matches_jax_at_world_one(ours, options, theirs, their_options, dtype):
    impl = load_port("collectives", ours)(M, N, K, dtype=dtype, device="cpu", **options)
    ref = load_jax("collectives", theirs)(M, N, K, dtype=dtype, mesh=_one_device_mesh(),
                                          **their_options)
    got, want = impl.run(), ref.run()
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert impl.validate(got)
    assert impl.wire_bytes() == ref.wire_bytes() and impl.flops() == ref.flops()


def test_compute_only_copies_into_a_fresh_tensor():
    impl = load_port("collectives", "compute_only")(M, N, K, device="cpu")
    got = impl.run()
    assert got.data_ptr() != impl.a.data_ptr() and torch.equal(got, impl.a)
    assert impl.validate(got) and not impl.validate(impl.a)
    assert impl.wire_bytes() == 0.0 and impl.hbm_bytes() == M * K * 2


def _bare(name, m, d, dtype="bfloat16", **options):
    """A port member with its options parsed and ``d`` partitions, for the
    metric and the shape checks alone (the port's world here is 1)."""
    cls = load_port("collectives", name)
    impl = object.__new__(cls)
    impl.m, impl.n, impl.k, impl.num_partitions, impl.dtype = m, N, K, d, dtype
    impl._options_manager = OptionsManager(*cls.option_schema())
    impl.options = impl._options_manager.parse(options)
    return impl


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64", "int32"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_wire_bytes_and_flops_match_jax(d, dtype):
    mesh = jax.make_mesh((d,), ("tp",), devices=jax.devices()[:d])
    m = 12 * d * d
    for op in OPS:
        ref = load_jax("collectives", "jax_spmd")(m, N, K, dtype=dtype, mesh=mesh, op=op)
        ours = _bare("pytorch", m, d, dtype, op=op)
        assert ours.wire_bytes() == ref.wire_bytes(), (op, d, dtype)
        assert ours.flops() == ref.flops() == 1000.0 * ref.wire_bytes()
    for size in ("sharded", "unsharded"):
        ref = load_jax("collectives", "compute_only")(m, N, K, dtype=dtype, mesh=mesh,
                                                      size=size)
        ours = _bare("compute_only", m, d, dtype, size=size)
        assert (ours.wire_bytes(), ours.hbm_bytes(), ours.flops()) == \
            (ref.wire_bytes(), ref.hbm_bytes(), ref.flops())


def test_rows_carry_the_family_unit(tmp_path):
    for primitive in registry.ALLOWED_PRIMITIVES:
        assert registry.throughput_unit(primitive) == jax_unit(primitive)
    rows = port_cli.run_benchmark({
        "primitive": "collectives", "m": M, "n": N, "k": K, "device": "cpu",
        "num_iterations": 2, "num_warmups": 1, "output_csv": str(tmp_path / "c.csv"),
        "implementations": {"pytorch": [{"op": "all_gather"}], "xla_gspmd": [{}]},
    })
    assert [r["unit"] for r in rows] == ["GB/s", "GB/s"]
    assert rows[0]["valid"] and "not yet ported" in rows[1]["error"]
    tp = port_cli.run_benchmark({
        "primitive": "tp_rowwise", "m": M, "n": N, "k": K, "device": "cpu",
        "num_iterations": 1, "num_warmups": 0, "output_csv": str(tmp_path / "t.csv"),
        "implementations": {"pytorch": [{}]},
    })
    assert tp[0]["unit"] == "TFLOPS"
    with pytest.raises(ValueError, match="not yet ported"):
        registry.throughput_unit("pp_pipeline")


@pytest.mark.parametrize("op", ["reduce_scatter", "all_to_all", "all_reduce"])
def test_chunked_ops_need_m_divisible_by_d_squared(op):
    match = f"m=24 must be divisible by partitions\\^2=16 for op={op}"
    mesh = jax.make_mesh((4,), ("tp",), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=match):
        load_jax("collectives", "jax_spmd")(24, N, K, mesh=mesh, op=op)
    with pytest.raises(ValueError, match=match):
        _bare("pytorch", 24, 4, op=op)._check_shapes()
    _bare("pytorch", 24, 4, op="all_gather")._check_shapes()  # m % d suffices
    with pytest.raises(ValueError, match="m=26 must be divisible by partitions=4"):
        _bare("compute_only", 26, 4)._check_shapes()


@pytest.mark.parametrize(
    "name,options,match",
    [
        ("cuda", {"op": "all_to_all"}, "not in allowed values"),
        ("cuda", {"op": "ppermute"}, "not in allowed values"),
        ("pytorch", {"op": "all_gather", "strategy": "hierarchical"},
         "decomposes all_reduce only"),
        ("pytorch", {"op": "all_reduce", "strategy": "hierarchical", "transport": "dcn"},
         "transport axis does not apply"),
        ("pytorch", {"op": "gather"}, "not in allowed values"),
        ("compute_only", {"size": "half"}, "not in allowed values"),
        ("pytorch", {"transport": "nvlink"}, "not in allowed values"),
    ],
)
def test_option_rejections_match_jax(name, options, match):
    jax_name = {"pytorch": "jax_spmd", "cuda": "pallas"}.get(name, name)
    with pytest.raises(ValueError, match=match):
        load_jax("collectives", jax_name)(M, N, K, mesh=_one_device_mesh(), **options)
    with pytest.raises(ValueError, match=match):
        load_port("collectives", name)(M, N, K, device="cpu", **options)


@pytest.mark.parametrize(
    "options,match",
    [
        ({"detect_races": True}, "race detector and has no CUDA counterpart"),
        ({"dtype": "int32"}, "K4/K5 take"),
        ({"dtype": "float64"}, "K4/K5 take"),
    ],
)
def test_cuda_member_rejects_what_k4_k5_do_not_take(options, match):
    options = dict(options)
    dtype = options.pop("dtype", "bfloat16")
    with pytest.raises(ValueError, match=match):
        load_port("collectives", "cuda")(M, N, K, dtype=dtype, device="cpu", **options)
    with pytest.raises(ValueError, match="16-byte units"):
        load_port("collectives", "cuda")(M, N, 4, device="cpu")


def test_hierarchical_on_one_node_logs_that_it_is_rs_ag(caplog):
    with caplog.at_level(logging.WARNING):
        impl = load_port("collectives", "pytorch")(M, N, K, device="cpu", op="all_reduce",
                                                   strategy="hierarchical")
    assert "measures the rs_ag decomposition" in caplog.text
    assert impl.validate(impl.run())


@pytest.mark.parametrize("member", ["xla_gspmd", "jax_spmd_hier", "jax_spmd_striped"])
def test_members_not_yet_ported(member):
    load_jax("collectives", member)  # the JAX package has it
    with pytest.raises(ValueError, match="not yet ported"):
        load_port("collectives", member)


def test_registry_resolves_the_family():
    assert registry.implementation_names("collectives") == ("compute_only", "pytorch", "cuda")
    for name in ("compute_only", "pytorch", "cuda"):
        assert load_port("collectives", name).primitive_name == "collectives"
    with pytest.raises(ValueError, match="counterpart is 'cuda'"):
        load_port("collectives", "pallas")


def test_sweep_config_runs_on_the_cpu(tmp_path):
    """``scripts/config_collectives.json`` as it is, through the port's CLI
    (its ``jax_spmd`` and ``pallas`` entries run as ``pytorch`` and
    ``cuda``) at a small shape: every row valid and in GB/s but the
    ``xla_gspmd``, ``jax_spmd_hier`` and ``jax_spmd_striped`` rows, which
    stay 'not yet ported' error rows."""
    cfg = json.loads((REPO / "scripts" / "config_collectives.json").read_text())["benchmark"]
    cfg.update(m=[32], n=[8], k=[64], num_iterations=2, num_warmups=1, device="cpu",
               output_csv=str(tmp_path / "rows.csv"))
    path = tmp_path / "config_collectives.json"
    path.write_text(json.dumps({"benchmark": cfg}))
    rows = port_cli.run_benchmark(port_cli.load_config(str(path)))
    # 2 compute_only, 5 + 1 + 1 jax_spmd, 4 + 1 hier, 1 striped, 5 xla_gspmd, 3 pallas
    assert len(rows) == 23
    unported = ("xla_gspmd", "jax_spmd_hier", "jax_spmd_striped")
    for row in rows:
        assert row["unit"] == "GB/s"
        if row["base_implementation"] in unported:
            assert "not yet ported" in row["error"] and not row["valid"]
        else:
            assert row["valid"] and not row["error"], row
    assert sum(r["base_implementation"] == "cuda" for r in rows) == 3
    assert sum(r["base_implementation"] == "pytorch" for r in rows) == 7
