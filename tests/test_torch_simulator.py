"""The port's simulator and topologies against the JAX package's, on the CPU.

Topology parsing, presets and rates on ``cpu`` worlds against the JAX
package's ``cpu-sim``; the H100 presets and the switched-node rule; the
flat, hierarchical and striped programs replayed by both engines to the
same makespan and summary; gate 1 (the closed forms) a family against the
JAX gate's renamed twin; the ``dcn``-on-one-node departure; gates 2 and 3
over a bank the port's runner writes on the CPU.
"""

import dataclasses
import json
import math

import pytest

from ddlb_tpu.perfmodel import topology as jax_topology
from ddlb_tpu.simulator import engine as jax_engine
from ddlb_tpu.simulator import frontends as jax_frontends
from ddlb_tpu.simulator import validate as jax_validate
from ddlb_tpu_torch.observatory import calibrate, store
from ddlb_tpu_torch.perfmodel import cost, specs, topology
from ddlb_tpu_torch.simulator import engine, frontends, validate
from ddlb_tpu_torch.simulator.program import ScheduleProgram, Stage, WireStep
from test_torch_observatory import jax_bank, write_bank

WORLDS = ["cpu:1x8", "cpu:2x8", "cpu:2x4x4", "cpu:16x16x16"]
OPS = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all"]
PAYLOAD = 64.0 * (1 << 20)


def _jax_spec(spec):
    return spec.replace("cpu:", "cpu-sim:")


def _close(a, b, rtol=1e-12):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-300)
    return a == b


def _same(ours, theirs):
    """Recursive equality, floats to 1e-12, the JAX ``cpu-sim`` name read
    as the port's ``cpu``."""
    if isinstance(theirs, str):
        return ours == theirs.replace("cpu-sim", "cpu")
    if isinstance(theirs, dict):
        return set(ours) == set(theirs) and all(_same(ours[k], theirs[k]) for k in theirs)
    if isinstance(theirs, (list, tuple)):
        return len(ours) == len(theirs) and all(_same(a, b) for a, b in zip(ours, theirs))
    if isinstance(theirs, (int, float)) and not isinstance(theirs, bool):
        return _close(float(ours), float(theirs))
    return ours == theirs


# -- topologies -----------------------------------------------------------------------


TOPOLOGY_SPECS = ["cpu:8", "cpu:1x8", "cpu:2x8", "cpu:4x2x4", "cpu:2x4x4", "cpu:16x16x16"]
DEGRADATIONS = [None, "dcn=0.25", "ici1=0", "dcn=0.5,ici0=0.75", "dcn=0"]


@pytest.mark.parametrize("spec", TOPOLOGY_SPECS)
@pytest.mark.parametrize("degrade", DEGRADATIONS)
def test_topology_equals_jax(spec, degrade):
    ours, theirs = topology.parse_topology(spec), jax_topology.parse_topology(_jax_spec(spec))
    if degrade:
        ours = ours.degraded(topology.parse_degradation(degrade))
        theirs = theirs.degraded(jax_topology.parse_degradation(degrade))
    assert ours.name == theirs.name.replace("cpu-sim", "cpu")
    for attr in ("pods", "ici_mesh", "chips_per_pod", "num_chips", "ici_bw", "dcn_bw",
                 "flat_bw"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.comm_resources() == theirs.comm_resources()
    assert ours.alive_ici_axes() == theirs.alive_ici_axes()
    assert ours.flat_hop_fractions() == theirs.flat_hop_fractions()
    for resource in ("mxu", "hbm", "dcn", "flat", *ours.comm_resources()):
        for dtype in ("bfloat16", "float32", "int8"):
            assert ours.resource_rate(resource, dtype) == theirs.resource_rate(resource, dtype)
    for bad in ("nvlink", f"ici{len(ours.ici_mesh)}"):
        with pytest.raises(ValueError):
            ours.resource_rate(bad)
        with pytest.raises(ValueError):
            theirs.resource_rate(bad)


@pytest.mark.parametrize("text", ["dcn=0.25", "ici1=0", " dcn=0.5 , ici0=1 ,", "ici0=0,dcn=0",
                                  "", "dcn", "dcn=x", "dcn=1.5", "=0.5"])
def test_degradation_parses_as_jax(text):
    try:
        theirs = jax_topology.parse_degradation(text)
    except ValueError:
        with pytest.raises(ValueError):
            topology.parse_degradation(text)
        return
    ours = topology.parse_degradation(text)
    assert (dict(ours.factors), ours.down, ours.name) == (
        dict(theirs.factors), theirs.down, theirs.name)
    for cls in ("ici0", "ici1", "dcn"):
        assert ours.factor(cls) == theirs.factor(cls)


@pytest.mark.parametrize("bad", ["v5p:4x16x16", "cpu", "cpu:", ":4x8", "cpu:4xa",
                                 "cpu:0x8", "h100-sxm:4x-8"])
def test_topology_rejects_as_jax(bad):
    with pytest.raises((KeyError, ValueError)):
        topology.resolve_topology(bad)


@pytest.mark.parametrize("preset", sorted(topology.PRESETS))
def test_h100_presets(preset):
    """Every preset is a world of H100 nodes of eight at the data sheet's
    rates, and none carries a TPU name or number."""
    spec = topology.PRESETS[preset]
    assert spec.startswith("h100-sxm:") and spec.endswith("x8")
    assert not any(tpu in spec for tpu in ("v4", "v5", "v6"))
    world = topology.resolve_topology(preset)
    h100 = specs.CHIP_SPECS["h100-sxm"]
    assert world.chip is h100 and world.chips_per_pod == 8
    assert (world.ici_bw, world.dcn_bw) == (450e9, 50e9)
    assert world.num_chips == int(preset.split("node")[1])
    assert world.pods == world.num_chips // 8
    assert world.resource_rate("mxu") == h100.peak_flops("bfloat16")
    assert world.resource_rate("hbm") == h100.hbm_bw
    assert world.comm_resources() == (("ici0", "dcn", "flat") if world.pods > 1 else ("ici0",))


# -- the switched node ----------------------------------------------------------------


@pytest.mark.parametrize("spec", ["h100-sxm:4x2x4", "h100-sxm:1x2x4", "h100-sxm:2x2x2x2"])
def test_switched_node_refuses_a_second_axis(spec):
    """An H100 node is one NVLink fabric: a mesh of more than one
    dimension inside it is refused, where a ``cpu`` torus of that shape is
    a world."""
    with pytest.raises(ValueError, match="switched fabric"):
        topology.resolve_topology(spec)
    torus = topology.resolve_topology(spec.replace("h100-sxm", "cpu"))
    assert len(torus.alive_ici_axes()) == len(torus.ici_mesh) > 1


@pytest.mark.parametrize("spec", ["h100-sxm:1x8", "h100-sxm:2x8", "h100-sxm:4x8"])
@pytest.mark.parametrize("op", OPS)
def test_switched_node_striping_gains_nothing(spec, op):
    """On an H100 node the one fabric is the one path: the striped
    composition is the hierarchical one, to the bit."""
    world = topology.resolve_topology(spec)
    assert world.alive_ici_axes() == (0,) and world.comm_resources()[0] == "ici0"
    striped = engine.replay(frontends.striped_program(op, PAYLOAD, world), world)
    hier = engine.replay(frontends.hierarchical_program(op, PAYLOAD, world), world)
    assert striped.makespan_s == hier.makespan_s
    assert set(striped.busy_s) <= {"ici0", "dcn"}


def test_switched_node_has_one_fabric():
    """A step on a second intra-node axis cannot be priced on an H100
    node, and overlaps on a ``cpu`` torus; a downed fabric leaves no path."""
    program = ScheduleProgram("two-axes", [Stage([WireStep(1e9, scope="ici0")]),
                                           Stage([WireStep(1e9, scope="ici1")])],
                              overlap=True)
    h100 = topology.parse_topology("h100-sxm:1x8")
    with pytest.raises(ValueError, match="cannot price resource 'ici1'"):
        engine.replay(program, h100)
    torus = topology.parse_topology("cpu:1x2x4")
    assert engine.replay(program, torus).makespan_s == pytest.approx(1e9 / 100e9, rel=1e-12)
    down = h100.degraded(topology.parse_degradation("ici0=0"))
    assert down.alive_ici_axes() == () and down.resource_rate("ici0") == 0.0


@pytest.mark.parametrize("op", OPS)
def test_cpu_torus_striping_equals_jax(op):
    ours = topology.parse_topology("cpu:4x2x4")
    theirs = jax_topology.parse_topology("cpu-sim:4x2x4")
    for algo in frontends.SYNTHETIC_ALGOS:
        a = engine.replay(frontends.synthetic_program(algo, op, PAYLOAD, ours), ours)
        b = jax_engine.replay(jax_frontends.synthetic_program(algo, op, PAYLOAD, theirs),
                              theirs)
        assert _same(engine.summarize(a, ours), jax_engine.summarize(b, theirs))
    striped = engine.replay(frontends.striped_program(op, PAYLOAD, ours), ours)
    hier = engine.replay(frontends.hierarchical_program(op, PAYLOAD, ours), ours)
    if op != "all_to_all":
        assert striped.makespan_s < hier.makespan_s


# -- replay ----------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("algo", ["flat", "hierarchical", "striped"])
@pytest.mark.parametrize("op", OPS)
def test_replay_equals_jax(world, algo, op):
    """Both engines replay the same synthetic program to the same
    makespan and ``summarize()``, to 1e-12; the replay is deterministic."""
    ours = topology.parse_topology(world)
    theirs = jax_topology.parse_topology(_jax_spec(world))
    a = engine.replay(frontends.synthetic_program(algo, op, PAYLOAD, ours), ours)
    b = jax_engine.replay(jax_frontends.synthetic_program(algo, op, PAYLOAD, theirs), theirs)
    assert _close(a.makespan_s, b.makespan_s)
    assert _same(engine.summarize(a, ours), jax_engine.summarize(b, theirs))
    assert [(e.index, e.resource, e.start_s, e.finish_s) for e in a.timeline] == [
        (e.index, e.resource, e.start_s, e.finish_s) for e in b.timeline]
    again = engine.replay(frontends.synthetic_program(algo, op, PAYLOAD, ours), ours)
    assert again.timeline == a.timeline and again.busy_s == a.busy_s


@pytest.mark.parametrize("degrade", ["dcn=0.25", "ici1=0", "dcn=0", "ici0=0,ici1=0"])
def test_degraded_replay_equals_jax(degrade):
    ours = topology.parse_topology("cpu:4x2x4").degraded(topology.parse_degradation(degrade))
    theirs = jax_topology.parse_topology("cpu-sim:4x2x4").degraded(
        jax_topology.parse_degradation(degrade))
    for op in OPS:
        for algo in frontends.SYNTHETIC_ALGOS:
            a = engine.replay(frontends.synthetic_program(algo, op, PAYLOAD, ours), ours)
            b = jax_engine.replay(jax_frontends.synthetic_program(algo, op, PAYLOAD, theirs),
                                  theirs)
            assert _same(engine.summarize(a, ours), jax_engine.summarize(b, theirs))


def test_replay_records_its_span_and_events(tmp_path, monkeypatch):
    from ddlb_tpu_torch import telemetry
    from ddlb_tpu_torch.telemetry import names

    assert {"sim.replay", "sim.validate"} <= set(names.SPAN_NAMES)
    assert "sim.events" in names.METRIC_NAMES
    world = topology.parse_topology("cpu:2x8")
    with telemetry.metrics_scope() as scope:
        result = engine.replay(frontends.flat_ring_program("all_reduce", 1e6, world), world)
    assert scope.snapshot()["sim.events"] == result.events == 2 * (16 - 1)


def test_unknown_algorithm_and_family_raise():
    world = topology.parse_topology("cpu:8")
    with pytest.raises(frontends.ProgramBuildError):
        frontends.synthetic_program("ring2", "all_reduce", 1.0, world)
    with pytest.raises(frontends.ProgramBuildError):
        frontends.program_from_impl(type("X", (), {"primitive_name": "nope"})(), world)


# -- gate 1 -----------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(validate.REPRESENTATIVES))
def test_closed_form_gate_equals_jax(family):
    """Gate 1 passes on ``cpu`` and ``h100-sxm`` worlds, and each record's
    replay equals the JAX gate's for its renamed twin on ``cpu-sim``."""
    ours = validate.closed_form_check(chip="cpu", families=[family])
    theirs = jax_validate.closed_form_check(chip="cpu-sim", families=[family])
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        assert a["ok"] and b["ok"], (a, b)
        assert a["options"].get("chunk_count") == b["options"].get("chunk_count")
        assert _close(a["predicted_sim_s"], b["predicted_sim_s"])
        assert _close(a["predicted_cost_s"], b["predicted_cost_s"])
    on_card = validate.closed_form_check(families=[family])
    assert len(on_card) == len(ours)
    assert all(r["ok"] and r["rel_err"] <= validate.CLOSED_FORM_RTOL for r in on_card)


def test_validation_constants_are_jax_constants():
    for name in ("CLOSED_FORM_RTOL", "HISTORY_RTOL", "LOWER_BOUND_SLACK", "CALIBRATION_RTOL",
                 "REPRODUCIBLE_FAMILIES", "CHUNKED_VARIANTS"):
        assert getattr(validate, name) == getattr(jax_validate, name)
    from ddlb_tpu.analysis.spmd.families import FAMILY_SHAPES

    assert validate.FAMILY_SHAPES == FAMILY_SHAPES
    from ddlb_tpu_torch.primitives.registry import port_member_name

    assert validate.REPRESENTATIVES == {
        family: (port_member_name(member), overrides)
        for family, (member, overrides) in jax_validate.REPRESENTATIVES.items()}
    for text in ("algorithm=chunked;chunk_count=2", "a=true;b=False;c=1.5;d=x;e", "", None):
        assert validate.parse_option_string(text) == jax_validate.parse_option_string(text)


# -- the departure: a dcn row on one node ----------------------------------------------


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise", "dp_allreduce",
                                    "ep_alltoall", "collectives"])
def test_dcn_row_on_one_node_replays_to_the_ports_estimate(family, monkeypatch):
    """A ``transport=dcn`` stub whose world is one node replays to the
    port's ``estimate`` with its ``wire_bytes()`` on ``ici0``; across two
    nodes (``DDLB_TPU_SIM_SLICES=2``) its bytes ride ``dcn`` and the
    replay equals the JAX package's."""
    monkeypatch.delenv("DDLB_TPU_SIM_SLICES", raising=False)
    shp = validate.FAMILY_SHAPES[family]
    args = (family, "pytorch", shp["m"], shp["n"], shp["k"], shp["d"])
    for chip in ("cpu", "h100-sxm"):
        world = topology.flat_topology(shp["d"], chip)
        stub = validate.build_stub(*args, transport="dcn")
        program = frontends.program_from_impl(stub, world)
        result = engine.replay(program, world)
        assert result.makespan_s == pytest.approx(
            cost.estimate(stub, world.chip).predicted_s, rel=1e-12)
        assert program.meta["transport"] == "ici"
        assert set(result.payload) == {"mxu", "ici0"} - ({"mxu"} if family == "collectives"
                                                          else set())
        assert result.payload["ici0"] == pytest.approx(stub.wire_bytes(), rel=1e-12)
        ici_twin = validate.build_stub(*args, transport="ici")
        assert result.makespan_s == engine.replay(
            frontends.program_from_impl(ici_twin, world), world).makespan_s
    monkeypatch.setenv("DDLB_TPU_SIM_SLICES", "2")
    world = topology.flat_topology(shp["d"], "cpu")
    jax_world = jax_topology.flat_topology(shp["d"], "cpu-sim")
    stub = validate.build_stub(*args, transport="dcn")
    assert stub.runtime.num_slices == 2
    result = engine.replay(frontends.program_from_impl(stub, world), world)
    jax_stub = jax_validate.build_stub(family, "jax_spmd", *args[2:], transport="dcn")
    want = jax_engine.replay(jax_frontends.program_from_impl(jax_stub, jax_world), jax_world)
    assert _close(result.makespan_s, want.makespan_s)
    assert _same(result.payload, want.payload) and "dcn" in result.payload
    assert result.makespan_s == pytest.approx(cost.estimate(stub, world.chip).predicted_s,
                                              rel=1e-12)


# -- gates 2 and 3 over a bank the port's runner writes ---------------------------------


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    return write_bank(tmp_path_factory.mktemp("sim_bank"))


def test_history_gate_passes_on_a_port_bank_as_on_jax(bank, tmp_path):
    ours = validate.history_check(bank)
    assert ours["ok"] and ours["checked"] == 10 and not ours["skipped"]
    theirs = jax_validate.history_check(jax_bank(bank, tmp_path / "jax"))
    assert ours == theirs


def test_history_gate_fails_a_row_faster_than_its_roofline(bank, tmp_path):
    """A row banked faster than its bound is a lower-bound violation, a
    row whose prediction drifted a banked-prediction one; an empty bank
    is not a pass."""
    records = store.load_history(bank)
    fast = json.loads(json.dumps(records[0]))
    fast["row"]["median time (ms)"] = fast["row"]["predicted_s"] * 1e3 * 0.5
    fast["run_id"] = "fast"
    drifted = json.loads(json.dumps(records[1]))
    drifted["row"]["predicted_s"] *= 2.0
    summary = validate.history_check(records=[fast, drifted])
    assert not summary["ok"] and summary["checked"] == 2
    kinds = sorted(v["kind"] for v in summary["violations"])
    assert kinds == ["banked-prediction", "lower-bound"]
    empty = validate.history_check(str(tmp_path / "none"))
    assert empty["checked"] == 0 and not empty["ok"]
    unknown = json.loads(json.dumps(records[0]))
    unknown["row"]["base_implementation"] = "jax_spmd"
    skipped = validate.history_check(records=[unknown])
    assert skipped["skipped"] == 1 and not skipped["ok"]


def test_calibration_gate_runs_on_a_fitted_table(bank, tmp_path, monkeypatch):
    """Gate 3 with a table ``observatory.calibrate`` fits from the bank,
    against the JAX gate on the same table and rows; no table is not a
    pass."""
    from ddlb_tpu.perfmodel import calib as jax_calib

    monkeypatch.delenv("DDLB_TPU_CALIB", raising=False)
    table = calibrate.calibrate_history(bank)
    assert table is not None
    ours = validate.calibration_check(bank, table=table)
    path = calibrate.write_table(table, str(tmp_path / "calib.json"))
    jax_table = jax_calib.load_table(path)
    jax_dir = jax_bank(bank, tmp_path / "jax")
    jax_table = dataclasses.replace(jax_table, groups={
        ("cpu-sim", backend): group for (_chip, backend), group in jax_table.groups.items()})
    theirs = jax_validate.calibration_check(jax_dir, table=jax_table)
    assert ours["checked"] == theirs["checked"] == 10
    assert ours["table_version"] == table.version
    # the keys order apart (the members' names differ): compare as sets
    def by_value(summary):
        return sorted((v["sim_cal_s"], v["measured_median_s"], v["rel_err"])
                      for v in summary["violations"])

    assert _same(by_value(ours), by_value(theirs))
    assert ours["ok"] == (not ours["violations"])
    none = validate.calibration_check(bank)
    assert not none["ok"] and none["skipped_reasons"] == ["no calibration table"]
    monkeypatch.setenv("DDLB_TPU_CALIB", path)
    assert validate.calibration_check(bank)["checked"] == 10
