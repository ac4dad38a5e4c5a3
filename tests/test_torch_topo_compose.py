"""The topology compositions and the transport axis in one process.

The pure functions against the JAX package's over grids of worlds and node
counts: the wire census's closed forms (``perfmodel/cost.py``),
``two_level_factors``, ``select_composition`` (pinned, and ``auto`` with
the health inputs unset), ``transport_order`` against the device order of
JAX's ``Runtime.transport_mesh`` (a world of 8 in 1, 2 and 4 slices, built
by the pure function), and ``ComposedMember.wire_bytes`` against JAX's
mixin on the same duck-typed stubs. Then the members: every composed
member at world 1 against its JAX twin on a one-device mesh (bit for bit
where no GEMM is involved), their rejections, the option schemas of the
seven families that carry ``transport`` against the JAX members', and
``scripts/config_transport_sweep.json`` through the port's CLI.
``test_torch_topo_multirank.py`` runs the members on 4-rank worlds.
"""

import contextlib
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from ddlb_tpu.perfmodel import cost as jax_cost
from ddlb_tpu.primitives import registry as jax_registry
from ddlb_tpu.primitives import topo_compose as jax_topo
from ddlb_tpu.runtime import Runtime as JaxRuntime
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.perfmodel import cost
from ddlb_tpu_torch.primitives import registry, topo_compose
from ddlb_tpu_torch.primitives.base import validation_atol
from ddlb_tpu_torch.runtime import node_assignment, transport_order
from torch_parity import bits

REPO = Path(__file__).resolve().parent.parent
HEALTH_ENV = ("DDLB_TPU_WORLD_DEGRADED", "DDLB_TPU_FAULT_PLAN", "DDLB_TPU_HISTORY")
OPS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
#: (world, nodes) pairs, nodes not always dividing the world
WORLDS = [(d, s) for d in (1, 2, 3, 4, 6, 8, 12, 16) for s in (0, 1, 2, 3, 4)]
#: the Pallas tile knobs the port leaves out (ROADMAP.md section 1)
TILE_KNOBS = {"block_m", "block_n", "block_k", "tune", "block_q", "block_kv"}
#: the port's member -> its JAX twin (the inverse of ``registry._RENAMED``)
JAX_NAMES = {ours: theirs for theirs, ours in registry._RENAMED.items()}
TRANSPORT_FAMILIES = ("tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall",
                      "collectives", "cp_ring_attention", "pp_pipeline")


@pytest.fixture
def healthy(monkeypatch):
    for name in HEALTH_ENV:
        monkeypatch.delenv(name, raising=False)


# -- the closed forms -----------------------------------------------------------


@pytest.mark.parametrize("fn", ["ring_step_count", "ring_wire_bytes", "hierarchical_phases",
                                "hierarchical_wire_bytes", "striped_wire_bytes"])
def test_cost_closed_forms_equal_jax(fn):
    ops = OPS + ("ppermute", "pmean", "psum", "psum_scatter")
    for op in ops:
        for d, inter in ((1, 1), (2, 1), (4, 2), (8, 2), (8, 4), (6, 3), (16, 4)):
            args = {"ring_step_count": (op, d), "ring_wire_bytes": (op, 4096.0, d),
                    "hierarchical_phases": (op, 4096.0, d // inter, inter),
                    "hierarchical_wire_bytes": (op, 4096.0, d // inter, inter),
                    "striped_wire_bytes": (op, 4096.0, inter, cost.torus_factors(d // inter))
                    }[fn]
            try:
                want = getattr(jax_cost, fn)(*args)
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)[:20]):
                    getattr(cost, fn)(*args)
                continue
            assert getattr(cost, fn)(*args) == want, (fn, args)


def test_itemsize_op_names_and_torus_equal_jax():
    for dtype in ("float32", "float64", "float16", "bfloat16", "int32", "int64", "int8"):
        assert cost.wire_itemsize(dtype) == jax_cost.wire_itemsize(dtype)
    with pytest.raises(ValueError, match="Unknown dtype"):
        cost.wire_itemsize("complex64")
    for op in OPS + ("pmean", "ppermute"):
        assert cost.canonical_op(op) == jax_cost.canonical_op(op)
    for n in range(1, 65):
        assert cost.torus_factors(n) == jax_cost.torus_factors(n)
    with pytest.raises(ValueError):
        cost.torus_factors(0)


# -- the composition policy -------------------------------------------------------


def test_two_level_factors_equal_jax():
    for d, s in WORLDS:
        assert topo_compose.two_level_factors(d, s) == jax_topo.two_level_factors(d, s)


def test_select_composition_equals_jax(healthy):
    for d, s in WORLDS:
        for requested in topo_compose.COMPOSITIONS + ("auto",):
            ours = topo_compose.select_composition(requested, d, s)
            assert ours[0] == jax_topo.select_composition(requested, d, s)[0], (d, s)
    with pytest.raises(ValueError, match="composition must be one of"):
        topo_compose.select_composition("bogus", 8, 2)


def test_auto_logs_the_health_inputs_it_does_not_read(monkeypatch, caplog, healthy):
    """The JAX policy turns a degraded world to ``striped``; the port
    resolves from the topology and says so."""
    monkeypatch.setenv("DDLB_TPU_WORLD_DEGRADED", "1")
    assert jax_topo.select_composition("auto", 8, 2)[0] == "striped"
    with caplog.at_level(logging.WARNING):
        assert topo_compose.select_composition("auto", 8, 2)[0] == "hierarchical"
    assert "from the topology only" in caplog.text and "DDLB_TPU_WORLD_DEGRADED" in caplog.text
    member = SimpleNamespace(options={"composition": "auto"}, num_partitions=4,
                             runtime=SimpleNamespace(num_slices=1))
    assert topo_compose.ComposedMember._resolved_composition(member) == "flat"
    caplog.clear()
    monkeypatch.delenv("DDLB_TPU_WORLD_DEGRADED")
    with caplog.at_level(logging.WARNING):
        assert topo_compose.ComposedMember._resolved_composition(member) == "flat"
    assert caplog.text == ""  # resolved once: the topology does not move


# -- the world's topology ---------------------------------------------------------


@contextlib.contextmanager
def jax_slices(monkeypatch, slices):
    """The JAX runtime's slice ids for ``DDLB_TPU_SIM_SLICES=slices`` over its
    8 simulated devices, by its own ``_slice_assignment``."""
    rt = JaxRuntime()
    saved = rt.slice_ids, rt.num_slices
    monkeypatch.setenv("DDLB_TPU_SIM_SLICES", str(slices))
    rt.slice_ids = rt._slice_assignment()
    rt.num_slices = len(set(rt.slice_ids))
    try:
        yield rt
    finally:
        rt.slice_ids, rt.num_slices = saved
        monkeypatch.delenv("DDLB_TPU_SIM_SLICES")


@pytest.mark.parametrize("transport", ["ici", "dcn"])
@pytest.mark.parametrize("slices", [1, 2, 4])
def test_transport_order_equals_jax_transport_mesh(monkeypatch, caplog, slices, transport):
    with jax_slices(monkeypatch, slices) as rt:
        assert rt.num_devices == 8
        ids = node_assignment(8, 8, slices)
        assert ids == rt.slice_ids
        mesh = rt.transport_mesh(("tp",), transport)
        want = tuple(rt.devices.index(dev) for dev in mesh.devices.flat)
    with caplog.at_level(logging.WARNING):
        assert transport_order(8, ids, transport) == want
    assert ("single node" in caplog.text) == (transport == "dcn" and slices == 1)
    if transport == "dcn" and slices == 2:
        assert want == (0, 4, 1, 5, 2, 6, 3, 7)


def test_node_assignment_rules():
    assert node_assignment(8, 4) == (0, 0, 0, 0, 1, 1, 1, 1)
    assert node_assignment(4, 4, 2) == (0, 0, 1, 1)  # the knob wins over the launcher
    assert node_assignment(4, 1) == (0, 1, 2, 3)
    with pytest.raises(ValueError, match="does not divide"):
        node_assignment(6, 6, 4)
    with pytest.raises(ValueError, match="transport must be"):
        transport_order(4, (0, 0, 1, 1), "nvlink")


# -- the wire census of the composed members ----------------------------------------


def _stub(cls, family, d, slices, composition, op):
    stub = cls.__new__(cls)
    stub.m, stub.n, stub.k, stub.dtype = 256, 64, 32, "bfloat16"
    stub.num_partitions = d
    stub.options = {"composition": composition, "op": op}
    stub.runtime = SimpleNamespace(num_slices=slices)
    return stub


@pytest.mark.parametrize("family", ["collectives", "dp_allreduce", "ep_alltoall"])
def test_composed_wire_bytes_equal_jax(family, healthy):
    ours_cls = registry.load_impl_class(family, "pytorch_hier")
    jax_cls = jax_registry.load_impl_class(family, "jax_spmd_hier")
    for d, slices in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (8, 2), (8, 4), (16, 4), (6, 4)):
        for comp in topo_compose.COMPOSITIONS + ("auto",):
            for op in OPS if family == "collectives" else (None,):
                ours = _stub(ours_cls, family, d, slices, comp, op)
                theirs = _stub(jax_cls, family, d, slices, comp, op)
                assert ours.wire_bytes() == theirs.wire_bytes(), (d, slices, comp, op)
                assert ours._resolved_composition() == theirs._resolved_composition()


def test_family_wire_bytes_equal_jax():
    """The dp/ep bases' flat census, which a ``flat`` composition reads."""
    for family, name in (("dp_allreduce", "pytorch"), ("ep_alltoall", "pytorch"),
                         ("ep_alltoall", "quantized"), ("dp_allreduce", "compute_only")):
        ours_cls = registry.load_impl_class(family, name)
        jax_cls = jax_registry.load_impl_class(family, JAX_NAMES.get(name, name))
        for d in (1, 2, 4, 8):
            ours, theirs = (_stub(c, family, d, 1, "flat", None) for c in (ours_cls, jax_cls))
            assert ours.wire_bytes() == theirs.wire_bytes(), (family, name, d)


# -- the members ---------------------------------------------------------------------


def test_registry_has_no_unported_member():
    with pytest.raises(ValueError, match="Unknown primitive 'bogus'"):
        registry.load_impl_class("bogus", "pytorch")
    for jax_name, ours in (("jax_spmd_hier", "pytorch_hier"),
                           ("jax_spmd_striped", "pytorch_striped")):
        assert registry.port_member_name(jax_name) == ours
        for family in ("collectives", "dp_allreduce", "ep_alltoall"):
            assert ours in registry.implementation_names(family)
        with pytest.raises(ValueError, match=f"Unknown implementation '{ours}'"):
            registry.load_impl_class("tp_columnwise", ours)


@pytest.mark.parametrize("family", TRANSPORT_FAMILIES)
def test_option_schemas_equal_jax(family):
    """Every JAX member of a family that carries ``transport`` has a port
    counterpart with its schema, the Pallas tile knobs aside."""
    for name in jax_registry.implementation_names(family):
        ours = registry.load_impl_class(family, registry.port_member_name(name))
        theirs = jax_registry.load_impl_class(family, name)
        for mine, want in zip(ours.option_schema(), theirs.option_schema()):
            assert mine == {k: v for k, v in want.items() if k not in TILE_KNOBS}, (family, name)
        assert ours.option_schema()[0]["transport"] == "ici"


@contextlib.contextmanager
def jax_one_device():
    rt = JaxRuntime()
    saved = rt.devices, rt.num_devices, rt.slice_ids, rt.num_slices
    rt.devices, rt.num_devices, rt.slice_ids, rt.num_slices = saved[0][:1], 1, (0,), 1
    try:
        yield
    finally:
        rt.devices, rt.num_devices, rt.slice_ids, rt.num_slices = saved


WORLD_ONE_CASES = (
    [("collectives", "pytorch_hier", {"op": op}) for op in OPS]
    + [("collectives", "pytorch_striped", {})]
    + [(fam, name, {}) for fam in ("dp_allreduce", "ep_alltoall")
       for name in ("pytorch_hier", "pytorch_striped")]
)


@pytest.mark.parametrize("family,name,opts", WORLD_ONE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composed_members_at_world_one_equal_jax(family, name, opts, dtype, healthy):
    m, n, k = (32, 8, 64) if family == "collectives" else (32, 16, 48)
    ours = registry.load_impl_class(family, name)(m, n, k, dtype=dtype, device="cpu", **opts)
    got = ours.run()
    assert ours.validate(got)
    with jax_one_device():
        theirs = jax_registry.load_impl_class(family, JAX_NAMES[name])(m, n, k, dtype=dtype,
                                                                       **opts)
        want = theirs.run()
    if family == "collectives":
        np.testing.assert_array_equal(bits(got), bits(want))
    else:  # a GEMM: the libraries sum in their own orders
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=validation_atol(dtype, k))
    assert ours.extra_row_fields() == {"composition": theirs._resolved_composition()}
    assert ours.wire_bytes() == theirs.wire_bytes() == 0.0


@pytest.mark.parametrize("family,name,opts,match", [
    ("collectives", "pytorch_hier", {"op": "ppermute"}, "is a single hop"),
    ("collectives", "pytorch_hier", {"op": "all_gather", "composition": "striped"},
     "stripes all_reduce only"),
    ("collectives", "pytorch_hier", {"op": "all_reduce", "transport": "dcn"},
     "the transport axis does not apply"),
    ("dp_allreduce", "pytorch_striped", {"transport": "ici"},
     "the transport axis does not apply"),
    ("ep_alltoall", "pytorch_hier", {"composition": "bogus"}, "not in allowed values"),
])
def test_composed_member_rejections(family, name, opts, match):
    with pytest.raises(ValueError, match=match):
        registry.load_impl_class(family, name)(32, 8, 32, dtype="float32", device="cpu", **opts)
    # a pinned flat composition is the parent's ring, whatever the transport
    if match == "the transport axis does not apply":
        flat = registry.load_impl_class(family, name)(
            32, 8, 32, dtype="float32", device="cpu", **{**opts, "composition": "flat"})
        assert flat.validate(flat.run())


def test_transport_sweep_config_runs_on_the_cpu(tmp_path, caplog):
    """``scripts/config_transport_sweep.json`` as it is, through the port's
    CLI at a small shape: every row valid; on one node ``dcn`` warns that
    it is the ``ici`` layout."""
    cfg = json.loads((REPO / "scripts" / "config_transport_sweep.json").read_text())["benchmark"]
    cfg.update(m=[64], n=[32], k=[32], num_iterations=2, num_warmups=1, device="cpu",
               time_measurement_backend="host_clock",  # device_loop needs the card
               output_csv=str(tmp_path / "rows.csv"))
    path = tmp_path / "config_transport_sweep.json"
    path.write_text(json.dumps({"benchmark": cfg}))
    with caplog.at_level(logging.WARNING):
        rows = port_cli.run_benchmark(port_cli.load_config(str(path)))
    assert len(rows) == 8
    for row in rows:
        assert row["valid"] and not row["error"], row
    assert sorted({r["base_implementation"] for r in rows}) == ["compiled", "overlap", "pytorch"]
    assert sum("transport=dcn" in r["option"] for r in rows) == 4
    assert "dcn and ici ring layouts are identical" in caplog.text
