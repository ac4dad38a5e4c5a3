"""The port's perfmodel against the JAX package's, on the CPU.

The spec's numbers and dtype rules and the ``DDLB_TPU_CHIP`` override;
every family's cost model through both packages' ``estimate()`` on the
same duck-typed stand-ins to 1e-12 (every schedule, chunked overlap
included, under the ``cpu`` entry and JAX's ``cpu-sim``), and the one
departure, a ``dcn`` row on one node; every port member's
``COST_SCHEDULE`` and cost dtype against its JAX twin; the wire census of
``cp_ring_attention`` and ``pp_pipeline`` against the JAX members' at
d = 1-4; serving's horizon floor and ``handoff_bytes``; the attribution
and the per-row span groups of a port trace against JAX's; world-1 rows
with the eleven cost-model columns, error rows included; and
``scripts/perf_report.py`` ranking a port CSV.
"""

import csv
import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from ddlb_tpu.observatory import attribution as jax_attribution
from ddlb_tpu.perfmodel import cost as jax_cost
from ddlb_tpu.perfmodel import specs as jax_specs
from ddlb_tpu_torch import schema
from ddlb_tpu_torch.benchmark import (
    PERF_ROW_DEFAULTS,
    PrimitiveBenchmarkRunner,
    append_csv,
    benchmark_worker,
    make_result_row,
)
from ddlb_tpu_torch.observatory import attribution
from ddlb_tpu_torch.perfmodel import cost, specs
from ddlb_tpu_torch.primitives import registry
from ddlb_tpu_torch.runtime import Runtime

REPO = Path(__file__).resolve().parent.parent
PERF_COLUMNS = ("predicted_s", "roofline_frac", "bound", "chip", "measured_overlap_frac",
                "phase_compute_s", "phase_comm_s", "phase_idle_s", "predicted_cal_s",
                "cal_residual_frac", "cal_version")
DTYPES = ("bfloat16", "float16", "float32", "float64", "int32", "int64", "int8")
SCHEDULES = ("sequential", "overlap", "compute_only")


def _close(a, b, rel=1e-12):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == pytest.approx(b, rel=rel, abs=0.0)


def _jax_like(spec):
    """A JAX ``ChipSpec`` with the port entry's numbers."""
    return jax_specs.ChipSpec(
        name=spec.name, peak_tflops=dict(spec.peak_tflops),
        hbm_gib=spec.hbm_bytes / jax_specs.GiB, hbm_bw_gbs=spec.hbm_bw / 1e9,
        ici_bw_gbs=spec.link_bw / 1e9, dcn_bw_gbs=spec.dcn_bw / 1e9)


# -- the spec -------------------------------------------------------------------


def test_h100_entry_is_the_data_sheet_with_the_port_dtype_rule():
    h100 = specs.CHIP_SPECS["h100-sxm"]
    assert (h100.hbm_bytes, h100.hbm_bw, h100.link_bw, h100.dcn_bw) == (
        80e9, 3.35e12, 4.5e11, 5e10)
    assert h100.peak_flops("bfloat16") == h100.peak_flops("float16") == 989e12
    assert h100.peak_flops("int8") == 1979e12
    # TF32 off, and the integer rows' float64 products: the 67 TFLOP/s units,
    # not the JAX convention's bf16 / 3 and int8 peak
    for dtype in ("float32", "float64", "int32", "int64"):
        assert h100.peak_flops(dtype) == 67e12
    jax_rule = _jax_like(specs.ChipSpec("x", 1, 1, 1, peak_tflops={"bfloat16": 989.0,
                                                                   "int8": 1979.0}))
    assert jax_rule.peak_flops("float32") == pytest.approx(989e12 / 3)
    assert jax_rule.peak_flops("int32") == 1979e12
    assert (h100.transport_bw("ici"), h100.transport_bw("dcn")) == (4.5e11, 5e10)


@pytest.mark.parametrize("dtype", DTYPES + ("uint8",))
def test_cpu_entry_is_jax_cpu_sim(dtype):
    ours, theirs = specs.CHIP_SPECS["cpu"], jax_specs.get_spec("cpu-sim")
    assert ours.peak_flops(dtype) == theirs.peak_flops(dtype)
    assert (ours.hbm_bytes, ours.hbm_bw) == (theirs.hbm_bytes, theirs.hbm_bw)
    for transport in ("ici", "dcn"):
        assert ours.transport_bw(transport) == theirs.link_bw(transport)


def test_get_spec_aliases_and_the_override(monkeypatch):
    assert specs.get_spec("H100") is specs.get_spec("nvidia h100 80gb hbm3") \
        is specs.CHIP_SPECS["h100-sxm"]
    assert specs.get_spec("cpu-sim") is specs.CHIP_SPECS["cpu"]
    with pytest.raises(KeyError, match="Unknown chip 'v5e'"):
        specs.get_spec("v5e")
    assert Runtime("cpu").chip_spec is specs.CHIP_SPECS["cpu"]
    monkeypatch.setenv("DDLB_TPU_CHIP", "h100")
    assert Runtime("cpu").chip_spec is specs.CHIP_SPECS["h100-sxm"]
    assert specs.detect_spec() is specs.CHIP_SPECS["h100-sxm"]
    assert specs.spec_for_device("cuda", "NVIDIA A100-SXM4-80GB").name == "h100-sxm"
    monkeypatch.setenv("DDLB_TPU_CHIP", "cpu")
    with pytest.raises(ValueError, match="CPU entry"):
        specs.spec_for_device("cuda", "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("DDLB_TPU_CHIP", "tpu-v9")
    with pytest.raises(KeyError, match="tpu-v9"):
        Runtime("cpu").chip_spec
    monkeypatch.delenv("DDLB_TPU_CHIP")
    assert specs.detect_spec() is specs.CHIP_SPECS["cpu"]


# -- every family's cost model against the JAX package's ----------------------------


def _stand_in(family, schedule, chunks, rng, dtype, transport="ici", d=None, runtime=None,
              cost_dtype=None):
    """A member's duck type with seeded censuses, for either package."""
    d = int(rng.integers(1, 9)) if d is None else d
    flops = float(rng.uniform(1e6, 1e13))
    wire = float(rng.uniform(0.0, 1e10))
    hbm = float(rng.uniform(0.0, 1e11))
    handoff = float(rng.uniform(0.0, 1e9))
    options = {"transport": transport}
    if chunks is not None:
        options.update(algorithm="chunked", chunk_count=chunks)
    impl = SimpleNamespace(
        primitive_name=family, m=64, n=64, k=64, dtype=dtype, num_partitions=d,
        options=options, COST_SCHEDULE=schedule,
        flops=lambda: flops, wire_bytes=lambda: wire, hbm_bytes=lambda: hbm,
        handoff_bytes=lambda: handoff,
        overlap_chunks=lambda: chunks,
        cost_dtype=lambda: cost_dtype or dtype,
    )
    if runtime is not None:
        impl.runtime = runtime
    return impl


FAMILY_CASES = [(family, schedule, chunks)
                for family in sorted(cost.FAMILY_COST_MODELS)
                for schedule in SCHEDULES
                for chunks in (None, 1, 3)
                if chunks is None or schedule == "overlap"]


@pytest.mark.parametrize("family,schedule,chunks", FAMILY_CASES)
def test_estimate_equals_jax(family, schedule, chunks):
    """Both packages' ``estimate()`` on the same stand-ins: the ``cpu``
    entry against ``cpu-sim``, and the H100 entry against a JAX spec with
    its numbers, every term, the prediction, the bound and the share of a
    measured time equal to 1e-12."""
    rng = np.random.default_rng([len(family), len(schedule), chunks or 0])
    pairs = ((specs.CHIP_SPECS["cpu"], jax_specs.get_spec("cpu-sim")),
             (specs.CHIP_SPECS["h100-sxm"], _jax_like(specs.CHIP_SPECS["h100-sxm"])))
    for trial in range(6):
        dtype = DTYPES[trial % len(DTYPES)]
        impl = _stand_in(family, schedule, chunks, rng, dtype,
                         cost_dtype="int8" if trial == 5 else None)
        for ours_spec, jax_spec in pairs:
            ours, theirs = cost.estimate(impl, ours_spec), jax_cost.estimate(impl, jax_spec)
            for name in ("compute_s", "comm_s", "hbm_s", "predicted_s"):
                assert _close(getattr(ours, name), getattr(theirs, name)), (name, trial)
            assert ours.bound == theirs.bound
            for measured in (float("nan"), 0.0, ours.predicted_s * 0.5,
                             ours.predicted_s * 3.0):
                assert _close(ours.roofline_frac(measured), theirs.roofline_frac(measured))
            assert cost.overlap_chunks(impl) == jax_cost.overlap_chunks(impl)


def test_cost_models_cover_the_registry_exactly():
    assert set(cost.FAMILY_COST_MODELS) == set(registry.ALLOWED_PRIMITIVES)
    assert set(cost.FAMILY_COST_MODELS) == set(jax_cost.FAMILY_COST_MODELS)
    with pytest.raises(ValueError, match="No cost model"):
        cost.estimate(SimpleNamespace(primitive_name="nope"))


def test_dcn_on_one_node_is_priced_at_the_link_inside_it():
    """The port's one departure from the JAX comm term: a ``dcn`` row
    whose world is one node crosses the link inside it (NVLink on the
    card), so its wire is priced at ``ici``; JAX prices it at ``dcn``.
    Across two nodes both price ``dcn`` alike."""
    spec, jax_spec = specs.CHIP_SPECS["cpu"], jax_specs.get_spec("cpu-sim")
    rng = np.random.default_rng(7)
    one_node = SimpleNamespace(slice_ids=(0, 0, 0, 0))
    two_nodes = SimpleNamespace(slice_ids=(0, 0, 1, 1))
    for runtime in (None, one_node):
        impl = _stand_in("tp_columnwise", "sequential", None, rng, "bfloat16",
                         transport="dcn", d=4, runtime=runtime)
        ici_twin = SimpleNamespace(**{**vars(impl), "options": {"transport": "ici"}})
        ours = cost.estimate(impl, spec)
        assert ours.comm_s == jax_cost.estimate(ici_twin, jax_spec).comm_s
        assert ours.comm_s * 10.0 == pytest.approx(jax_cost.estimate(impl, jax_spec).comm_s)
    impl = _stand_in("tp_columnwise", "sequential", None, rng, "bfloat16",
                     transport="dcn", d=4, runtime=two_nodes)
    assert _close(cost.estimate(impl, spec).comm_s, jax_cost.estimate(impl, jax_spec).comm_s)
    assert cost.estimate(impl, spec).comm_s == impl.wire_bytes() / spec.dcn_bw


def _jax_name(port_name):
    reverse = {v: k for k, v in registry._RENAMED.items()}
    return reverse.get(port_name, port_name)


MEMBERS = [(family, name) for family in registry.ALLOWED_PRIMITIVES
           for name in registry.implementation_names(family)]


@pytest.mark.parametrize("family,name", MEMBERS)
def test_member_cost_schedule_and_dtype_equal_jax(family, name):
    from ddlb_tpu.primitives.registry import load_impl_class as jax_load

    ours = registry.load_impl_class(family, name)
    theirs = jax_load(family, _jax_name(name))
    assert ours.COST_SCHEDULE == theirs.COST_SCHEDULE, (family, name)
    assert ours.COST_DTYPE == theirs.COST_DTYPE, (family, name)
    for dtype in ("bfloat16", "float32"):
        stand_in = SimpleNamespace(COST_DTYPE=ours.COST_DTYPE, dtype=dtype)
        assert ours.cost_dtype(stand_in) == theirs.cost_dtype(stand_in)


# -- the wire census (fault 8) ----------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_attention_and_pipeline_wire_bytes_equal_jax(d):
    """The ``cp_ring_attention`` and ``pp_pipeline`` wire census
    (``collective_bytes``, the comm term) against the JAX members' on the
    same (m, n, k, dtype, d, options)."""
    from ddlb_tpu.primitives.cp_ring_attention.base import CPRingAttention as JaxCP
    from ddlb_tpu.primitives.cp_ring_attention.compute_only import (
        ComputeOnlyCPRingAttention as JaxCPOnly)
    from ddlb_tpu.primitives.cp_ring_attention.ulysses import UlyssesCPRingAttention as JaxUly
    from ddlb_tpu.primitives.pp_pipeline.base import PPPipeline as JaxPP
    from ddlb_tpu.primitives.pp_pipeline.compute_only import ComputeOnlyPPPipeline as JaxPPOnly
    from ddlb_tpu.primitives.pp_pipeline.jax_spmd import JaxSPMDPPPipeline as JaxPPSpmd
    from ddlb_tpu.primitives.pp_pipeline.schedules import SchedulePPPipeline as JaxPPSched
    from ddlb_tpu_torch.primitives.cp_ring_attention.base import CPRingAttention
    from ddlb_tpu_torch.primitives.cp_ring_attention.compute_only import (
        ComputeOnlyCPRingAttention)
    from ddlb_tpu_torch.primitives.cp_ring_attention.ulysses import UlyssesCPRingAttention
    from ddlb_tpu_torch.primitives.pp_pipeline.base import PPPipeline
    from ddlb_tpu_torch.primitives.pp_pipeline.compute_only import ComputeOnlyPPPipeline
    from ddlb_tpu_torch.primitives.pp_pipeline.pytorch import PyTorchPPPipeline
    from ddlb_tpu_torch.primitives.pp_pipeline.schedules import SchedulePPPipeline

    for dtype in ("bfloat16", "float32"):
        for window, heads, kv_heads in ((0, 8, 8), (40, 8, 2), (1000, 4, 4)):
            shape = SimpleNamespace(m=96 * d, n=128, k=16, dtype=dtype, num_partitions=d,
                                    options={"window": window}, num_heads=heads,
                                    kv_heads=kv_heads)
            for port, jax in ((CPRingAttention, JaxCP), (UlyssesCPRingAttention, JaxUly)):
                assert port.wire_bytes(shape) == jax.wire_bytes(shape), (port, d, window)
            assert ComputeOnlyCPRingAttention.wire_bytes(shape) == 0.0 == \
                JaxCPOnly.wire_bytes(shape)
        for mb in (1, 2, 4):
            shape = SimpleNamespace(m=48 * mb, n=32, k=32, dtype=dtype, num_partitions=d,
                                    options={"microbatches": mb})
            assert PPPipeline.wire_bytes(shape) == JaxPP.wire_bytes(shape)
            assert PyTorchPPPipeline.wire_bytes(shape) == JaxPPSpmd.wire_bytes(shape)
            assert ComputeOnlyPPPipeline.wire_bytes(shape) == 0.0 == \
                JaxPPOnly.wire_bytes(shape)
            for schedule, virtual in (("gpipe", 1), ("1f1b", 1), ("interleaved", 2)):
                if schedule == "interleaved" and mb % d:
                    continue
                shape.options = {"microbatches": mb, "schedule": schedule}
                shape.num_stages = d * virtual
                assert SchedulePPPipeline.wire_bytes(shape) == JaxPPSched.wire_bytes(shape), \
                    (d, mb, schedule)
        if d > 1:
            assert PyTorchPPPipeline.wire_bytes(shape) > 0.0


def test_world_one_attention_and_pipeline_rows_carry_their_census():
    for primitive, impl, mnk, options in (
            ("cp_ring_attention", "ring", (64, 32, 16), {}),
            ("pp_pipeline", "pytorch", (32, 16, 16), {"microbatches": 2})):
        row = benchmark_worker({
            "primitive": primitive, "impl_id": f"{impl}_0", "base_implementation": impl,
            "options": options, "m": mnk[0], "n": mnk[1], "k": mnk[2], "dtype": "float32",
            "num_iterations": 2, "num_warmups": 1, "device": "cpu"})
        assert row["valid"] and not row["error"], row["error"]
        # one rank: no hop crosses a link
        assert row["collective_bytes"] == 0.0 and row["phase_comm_s"] == 0.0
        assert row["bound"] == "compute" and 0.0 < row["roofline_frac"] <= 1.0


# -- serving: the horizon floor and the handoff census ------------------------------


SERVING = dict(batch=4, vocab=64, n_heads=4, n_requests=8, out_mean=4, out_max=8,
               n_kv_heads=2, prefix_pop=3, prefix_len=6)


@pytest.mark.parametrize("member,rate", [("engine", 5.0), ("engine", 1e9),
                                         ("disagg", 5.0), ("disagg", 1e9)])
def test_serving_cost_model_equals_jax(member, rate):
    """``cost_model()`` (the decode census plus the handoffs, floored at
    the arrival horizon) and ``disagg.handoff_bytes()`` against the JAX
    member's on the JAX package's own trace of the same spec."""
    from ddlb_tpu.primitives.registry import load_impl_class as jax_load
    from ddlb_tpu.primitives.serving_load.base import ServingLoad as JaxServingLoad
    from ddlb_tpu.workload import generate_trace

    ours = registry.load_impl_class("serving_load", member)(
        8, 32, 64, dtype="float32", device="cpu", seed=3, **SERVING, rate=rate)
    jax_cls = jax_load("serving_load", member)
    theirs = SimpleNamespace(options=dict(ours.options), m=8, n=32, k=64, seed=3,
                             dtype="float32", num_partitions=1,
                             primitive_name="serving_load", COST_SCHEDULE="sequential")
    theirs._trace = generate_trace(JaxServingLoad.workload_spec(theirs))
    theirs.flops = lambda: JaxServingLoad.flops(theirs)
    theirs.hbm_bytes = lambda: JaxServingLoad.hbm_bytes(theirs)
    if member == "disagg":
        theirs.handoff_bytes = lambda: jax_cls.handoff_bytes(theirs)
        assert ours.handoff_bytes() == pytest.approx(theirs.handoff_bytes(), rel=1e-12)
        assert ours.handoff_bytes() > 0.0
    else:
        assert not hasattr(ours, "handoff_bytes")
    est = ours.cost_model()
    want = jax_cost.estimate(theirs, jax_specs.get_spec("cpu-sim"))
    horizon = JaxServingLoad._trace_horizon_s(theirs)
    assert _close(est.predicted_s, max(want.predicted_s, horizon))
    for name in ("compute_s", "comm_s", "hbm_s"):
        assert _close(getattr(est, name), getattr(want, name))
    assert est.bound == want.bound
    if rate == 5.0:  # a slow trace: the horizon is the floor
        assert est.predicted_s == horizon > want.predicted_s
    else:
        assert est.predicted_s == want.predicted_s > horizon


# -- attribution --------------------------------------------------------------------


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_attribute_equals_jax(schedule):
    rng = np.random.default_rng(len(schedule))
    for trial in range(40):
        terms = {name: float(rng.choice([0.0, rng.uniform(0, 2e-3)]))
                 for name in ("compute_s", "comm_s", "hbm_s")}
        est = SimpleNamespace(**terms) if trial % 2 else terms
        measured = float(rng.choice([float("nan"), 0.0, rng.uniform(0, 5e-3)]))
        chunks = rng.choice([None, 1, 2, 8])
        ours = attribution.attribute(est, schedule, measured, chunks=chunks)
        theirs = jax_attribution.attribute(est, schedule, measured, chunks=chunks)
        assert list(ours) == list(theirs) == list(attribution.ATTRIBUTION_ROW_DEFAULTS)
        for key in ours:
            assert _close(ours[key], theirs[key]), (key, trial)
    assert repr(attribution.ATTRIBUTION_ROW_DEFAULTS) == repr(
        jax_attribution.ATTRIBUTION_ROW_DEFAULTS)


def test_rows_from_a_port_trace_equal_jax(tmp_path, monkeypatch):
    """The per-row span groups of the port's merged ``trace.json``, by the
    port's ``rows_from_events`` and the JAX package's."""
    monkeypatch.setenv("DDLB_TPU_TRACE", str(tmp_path / "trace"))
    runner = PrimitiveBenchmarkRunner(
        "tp_columnwise", 64, 32, 32,
        {"pytorch_0": {"implementation": "pytorch"}, "overlap_1": {"implementation": "overlap"}},
        dtype="float32", num_iterations=3, num_warmups=1, device="cpu")
    rows = runner.run()
    assert all(r["valid"] for r in rows)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ours = attribution.rows_from_events(events)
    assert ours == jax_attribution.rows_from_events(events)
    assert [r["impl"] for r in ours] == ["pytorch_0", "overlap_1"]
    for r in ours:
        assert r["primitive"] == "tp_columnwise"
        assert {"setup", "warmup", "timing", "validate"} <= set(r["phases"])
        assert sum(r["phases"].values()) >= r["phases"]["timing"] > 0.0


# -- rows -------------------------------------------------------------------------


def _cpu_config(**over):
    cfg = {"primitive": "tp_columnwise", "impl_id": "pytorch_0",
           "base_implementation": "pytorch", "options": {}, "m": 64, "n": 32, "k": 32,
           "dtype": "float32", "num_iterations": 3, "num_warmups": 1, "validate": True,
           "time_measurement_backend": "host_clock", "barrier_at_each_iteration": True,
           "device": "cpu"}
    cfg.update(over)
    return cfg


def test_perf_columns_are_registered_jax_columns():
    from ddlb_tpu import schema as jax_schema
    from ddlb_tpu.benchmark import PERF_ROW_DEFAULTS as JAX_DEFAULTS

    assert set(PERF_ROW_DEFAULTS) == set(PERF_COLUMNS)
    # in the JAX runner's column order
    assert tuple(PERF_ROW_DEFAULTS) == tuple(k for k in JAX_DEFAULTS if k in PERF_COLUMNS)
    for key in PERF_COLUMNS:
        assert schema.ROW_COLUMNS[key].strip() and key in jax_schema.ROW_COLUMNS
        assert repr(PERF_ROW_DEFAULTS[key]) == repr(JAX_DEFAULTS[key])
    # the tuning trio comes with the tuner
    assert set(JAX_DEFAULTS) - set(PERF_ROW_DEFAULTS) == {"tuned", "tuning_version",
                                                          "prior_rank"}


@pytest.mark.parametrize("primitive,impl,mnk,options,bound", [
    ("tp_columnwise", "pytorch", (64, 32, 32), {}, "compute"),
    ("tp_rowwise", "compute_only", (64, 32, 32), {}, "compute"),
    ("dp_allreduce", "quantized", (64, 32, 32), {}, "compute"),
    ("cp_ring_attention", "compute_only", (64, 32, 16), {}, "compute"),
    ("collectives", "compute_only", (64, 8, 32), {}, "hbm"),
    ("transformer_decode", "spmd", (16, 64, 128),
     {"batch": 2, "vocab": 64, "n_heads": 4}, None),
])
def test_world_one_rows_carry_the_cost_model(primitive, impl, mnk, options, bound):
    row = benchmark_worker(_cpu_config(primitive=primitive, impl_id=f"{impl}_0",
                                       base_implementation=impl, options=options,
                                       m=mnk[0], n=mnk[1], k=mnk[2]))
    assert row["valid"] and not row["error"], row["error"]
    for key in PERF_COLUMNS:
        assert key in row
    member = registry.load_impl_class(primitive, impl)(*mnk, dtype="float32",
                                                       device="cpu", **options)
    est = cost.estimate(member)
    assert row["chip"] == "cpu" and row["bound"] == (bound or est.bound)
    assert row["predicted_s"] == est.predicted_s > 0.0
    assert row["roofline_frac"] == est.roofline_frac(row["median time (ms)"] * 1e-3)
    assert 0.0 < row["roofline_frac"] <= 1.0
    assert row["phase_idle_s"] >= 0.0 and math.isnan(row["measured_overlap_frac"])
    assert math.isnan(row["predicted_cal_s"]) and row["cal_version"] == ""
    if primitive == "dp_allreduce":  # the quantized member at the int8 rate
        assert member.cost_dtype() == "int8"


def test_one_rank_collective_predicts_nothing():
    """A collective over one rank moves no byte over a link: the JAX
    model prices nothing (``predicted_s`` 0, ``roofline_frac`` NaN)."""
    row = benchmark_worker(_cpu_config(primitive="collectives", impl_id="pytorch_0",
                                       options={"op": "all_gather"}, m=64, n=8, k=32))
    assert row["valid"] and row["predicted_s"] == 0.0 and math.isnan(row["roofline_frac"])
    for key in attribution.ATTRIBUTION_ROW_DEFAULTS:
        assert math.isnan(row[key]), key


def test_error_rows_carry_the_defaults_or_the_prediction():
    unbuilt = benchmark_worker(_cpu_config(options={"no_such_option": 1}))
    built = benchmark_worker(_cpu_config(num_warmups=0, base_implementation="compiled",
                                         impl_id="compiled_0"))
    assert unbuilt["error"] and built["error"]
    measured = benchmark_worker(_cpu_config())
    assert list(unbuilt) == list(built) == list(measured)
    for key, default in PERF_ROW_DEFAULTS.items():
        assert repr(unbuilt[key]) == repr(default), key
    # the prediction is shape-only: a row whose member was built keeps it
    assert built["predicted_s"] == measured["predicted_s"] > 0.0
    assert built["chip"] == "cpu" and math.isnan(built["roofline_frac"])


def test_failing_cost_model_warns_and_keeps_the_row(monkeypatch, capsys):
    from ddlb_tpu_torch.primitives.tp_columnwise.pytorch import PyTorchTPColumnwise

    def broken(self):
        raise ZeroDivisionError("no model")

    monkeypatch.setattr(PyTorchTPColumnwise, "cost_model", broken)
    row = benchmark_worker(_cpu_config())
    assert row["valid"] and not row["error"] and row["chip"] == ""
    assert math.isnan(row["predicted_s"])
    assert "perfmodel cost estimate failed: ZeroDivisionError: no model" in \
        capsys.readouterr().out


# -- scripts/perf_report.py over a port CSV -------------------------------------------


def _perf_report():
    spec = importlib.util.spec_from_file_location("perf_report",
                                                  REPO / "scripts" / "perf_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_perf_report_ranks_a_port_csv(tmp_path, capsys):
    out = tmp_path / "tp.csv"
    runner = PrimitiveBenchmarkRunner(
        "tp_columnwise", 64, 32, 32,
        {"pytorch_0": {"implementation": "pytorch"},
         "compute_only_1": {"implementation": "compute_only"}},
        dtype="float32", num_iterations=3, num_warmups=1, device="cpu",
        output_csv=str(out))
    rows = runner.run()
    # an overlap row at d = 4 with the wire the model prices, written by
    # the port's own make_result_row and CSV appender
    est = SimpleNamespace(compute_s=2e-4, comm_s=1e-4, hbm_s=0.0)
    perf = {"predicted_s": 2e-4, "roofline_frac": 0.8, "bound": "compute", "chip": "cpu",
            **attribution.attribute(est, "overlap", 2.5e-4, chunks=2)}
    cfg = {"impl_id": "overlap_2", "primitive": "tp_columnwise", "m": 64, "n": 32, "k": 32,
           "base_implementation": "overlap", "dtype": "float32"}
    overlap_row = make_result_row(cfg, np.array([0.25, 0.25]), 1e6,
                                  "algorithm=chunked;chunk_count=2", True, "", 4, 4, "cpu",
                                  perf=perf)
    append_csv(str(out), overlap_row)
    with open(out, newline="") as f:
        header = next(csv.reader(f))
    assert set(PERF_COLUMNS) <= set(header)
    report = _perf_report()
    assert report.main([str(out)]) == 0
    assert "tp_columnwise" in capsys.readouterr().out
    assert report.main([str(out), "--json"]) == 0
    ranked = json.loads(capsys.readouterr().out)["families"]["tp_columnwise"]
    assert [e["implementation"] for e in ranked][0] == "overlap"
    assert {e["implementation"] for e in ranked} == {"pytorch", "compute_only", "overlap"}
    for entry in ranked:
        assert entry["chip"] == "cpu" and 0.0 < entry["roofline_frac"] <= 1.0
    assert report.main([str(out), "--json", "--overlap"]) == 0
    (entry,) = json.loads(capsys.readouterr().out)["families"]["tp_columnwise"]
    assert entry["implementation"] == "overlap" and entry["chunk_count"] == 2
    assert entry["overlap_frac"] == pytest.approx(
        jax_attribution.attribute(est, "overlap", 2.5e-4, chunks=2)["measured_overlap_frac"])
    assert len(rows) == 2
