"""The port's telemetry against the JAX package's, on the CPU.

The clock fit and skew fold (``clocksync.fit_offsets``,
``skew_from_spans``) on seeded synthetic stamps against the JAX
package's to 1e-12; the metrics scope's row columns; the name registry
(a subset of JAX's, and every literal name the port emits registered);
the row columns against the port's ``schema.py`` and the JAX names; a
port trace shard read, merged and broken down by the JAX package's tools;
the rank-tagged logger; and world-1 rows of ``tp_columnwise`` and
``serving_load`` with their telemetry and skew columns and, with
``DDLB_TPU_TRACE`` set, their phase spans.
"""

import ast
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ddlb_tpu import schema as jax_schema
from ddlb_tpu import telemetry as jax_telemetry
from ddlb_tpu.telemetry import clocksync as jax_clocksync
from ddlb_tpu.telemetry import names as jax_names
from ddlb_tpu_torch import schema, telemetry
from ddlb_tpu_torch.benchmark import PrimitiveBenchmarkRunner, benchmark_worker
from ddlb_tpu_torch.telemetry import clocksync, names

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ddlb_tpu_torch"
#: the row columns this slice adds: the metric snapshot and the skew fold
TELEMETRY_COLUMNS = ("barrier_wait_s", "loop_overhead_s", "hbm_high_water_bytes",
                     "collective_bytes", "hbm_peak_gib")
SKEW_COLUMNS = tuple(clocksync.SKEW_ROW_DEFAULTS)


@pytest.fixture
def trace_dir(tmp_path, monkeypatch):
    d = tmp_path / "trace"
    monkeypatch.setenv("DDLB_TPU_TRACE", str(d))
    return d


def _same(a, b, tol=1e-12):
    """Equal to ``tol`` (NaN equal to NaN, inf to inf, ints exactly)."""
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= tol
    return a == b


# -- clocksync: the fit and the fold against the JAX package's ------------------


def _synthetic(case, seed=0):
    """(sites, enters, exits): seeded stamps of ``n`` collectives on ``R``
    ranks whose clocks stand ``offset`` apart (and drift), each
    collective released at one world instant."""
    rng = np.random.default_rng(seed)
    R, n = {"offsets": (3, 12), "drift": (2, 24), "skewed": (4, 10),
            "few": (3, 4), "three_ranks_one_late": (3, 9)}[case]
    offsets = rng.uniform(-0.05, 0.05, R)
    offsets[0] = 0.0
    drift = rng.uniform(-1e-4, 1e-4, R) if case == "drift" else np.zeros(R)
    t = 100.0 + np.cumsum(rng.uniform(0.02, 0.09, n))
    arrive = t[None, :] - rng.uniform(1e-5, 4e-4, (R, n))
    if case == "skewed":
        arrive[:, 5] -= 0.03  # one skewed exchange: rank 2 arrives 30 ms late
        arrive[2, 5] = t[5] - 1e-6
    if case == "three_ranks_one_late":
        arrive[1, 1::2] = t[1::2] - 1e-6  # rank 1 the last arrival every other time
    leave = t[None, :] + rng.uniform(1e-6, 5e-5, (R, n))
    local = lambda x: x + offsets[:, None] + drift[:, None] * (x - 100.0)  # noqa: E731
    enters, exits = local(arrive), local(leave)
    sites = ["runtime.barrier"] * n
    if case == "few":
        sites = ["runtime.barrier", "runtime.collective", "runtime.barrier",
                 "runtime.collective"]
    if case == "three_ranks_one_late":
        sites[-1] = "runtime.collective"
    return sites, enters.tolist(), exits.tolist()


@pytest.mark.parametrize("case", ["offsets", "drift", "skewed", "few",
                                  "three_ranks_one_late"])
def test_fit_and_fold_equal_jax(case):
    sites, enters, exits = _synthetic(case)
    spans = {r: list(zip(enters[r], exits[r])) for r in range(len(enters))}
    got = clocksync.fit_offsets(spans)
    want = jax_clocksync.fit_offsets(spans)
    assert sorted(got) == sorted(want)
    for r in want:
        g, w = got[r].as_dict(), want[r].as_dict()
        assert g.keys() == w.keys()
        assert all(_same(g[k], w[k]) for k in w), (r, g, w)
        assert _same(got[r].t0, want[r].t0)
    got = clocksync.skew_from_spans(sites, enters, exits)
    want = jax_clocksync.skew_from_spans(sites, enters, exits)
    assert got.keys() == want.keys() == clocksync.SKEW_ROW_DEFAULTS.keys()
    assert all(_same(got[k], want[k]) for k in want), (got, want)
    # the fold's own exchange site as the fit site, as the port's fold calls it
    fold_sites = [clocksync.FOLD_SITE if s == "runtime.barrier" else s for s in sites]
    got = clocksync.skew_from_spans(fold_sites, enters, exits,
                                    fit_sites=(clocksync.FOLD_SITE,))
    want = jax_clocksync.skew_from_spans(fold_sites, enters, exits,
                                         fit_sites=(clocksync.FOLD_SITE,))
    assert all(_same(got[k], want[k]) for k in want), (got, want)


def test_clocksync_constants_are_jax():
    assert clocksync.FIT_SITES == jax_clocksync.FIT_SITES
    assert clocksync.MAX_ROW_SPANS == jax_clocksync.MAX_ROW_SPANS
    assert clocksync.MIN_FIT_EXCHANGES == jax_clocksync.MIN_FIT_EXCHANGES
    assert repr(clocksync.SKEW_ROW_DEFAULTS) == repr(jax_clocksync.SKEW_ROW_DEFAULTS)
    sites = ["runtime.barrier", "runtime.collective", "runtime.init", "skew.fold"]
    assert clocksync.fit_exchange_count(sites) == jax_clocksync.fit_exchange_count(sites)
    clocksync.reset_row()
    for j in range(clocksync.MAX_ROW_SPANS + 3):
        clocksync.record_span("runtime.barrier", j, j + 0.5)
    spans = clocksync.row_spans()
    assert len(spans) == clocksync.MAX_ROW_SPANS and spans[0][1] == 3.0
    clocksync.reset_row()
    assert clocksync.row_spans() == []


class _StubRuntime:
    """A world of ``counts`` ranks as ``fold_row_skew`` sees it: the
    all-gather returns each rank's count, then ``stamps``."""

    def __init__(self, counts, stamps=None, fail=False):
        self.num_processes = len(counts)
        self.device = torch.device("cpu")
        self.counts, self.stamps, self.fail = counts, stamps, fail
        self.gathers = 0

    def all_reduce(self, x):
        return x

    def synchronize(self):
        pass

    def blocks_by_rank(self, x):
        return x

    def all_gather_rows(self, x):
        self.gathers += 1
        if self.fail:
            raise RuntimeError("peer lost")
        if self.gathers == 1:
            return torch.tensor(self.counts, dtype=torch.int64)
        return torch.as_tensor(self.stamps, dtype=torch.float64).reshape(-1, 2)


def test_fold_keeps_defaults_and_warns_on_mismatch_or_failure(capsys):
    clocksync.reset_row()
    assert clocksync.fold_row_skew(_StubRuntime([3, 3])) == clocksync.SKEW_ROW_DEFAULTS
    for j in range(3):
        clocksync.record_span("runtime.barrier", j, j + 0.1)
    n = 3 + clocksync.FOLD_EXCHANGES
    stub = _StubRuntime([n, n + 1])
    got = clocksync.fold_row_skew(stub)
    assert repr(got) == repr(clocksync.SKEW_ROW_DEFAULTS) and stub.gathers == 1
    assert "different numbers of collectives" in capsys.readouterr().out
    got = clocksync.fold_row_skew(_StubRuntime([n, n], fail=True))
    assert repr(got) == repr(clocksync.SKEW_ROW_DEFAULTS)
    assert "skew fold failed (RuntimeError: peer lost)" in capsys.readouterr().out
    clocksync.reset_row()


# -- metrics ---------------------------------------------------------------------


def test_row_fields_equal_jax():
    rng = np.random.default_rng(1)
    values = rng.uniform(0.0, 1e-3, 6)
    with telemetry.metrics_scope() as port, jax_telemetry.metrics_scope() as ref:
        for mod in (telemetry, jax_telemetry):
            for v in values:
                mod.record("barrier_wait_s", float(v))
            mod.record_max("loop_overhead_s", float(values[2]))
            mod.record_max("loop_overhead_s", float(values[1]))
            mod.record_max("hbm_high_water_bytes", 123456789.0)
            mod.record_max("collective_bytes", 2.5e6)
            mod.record("serve.ticks", 3)
    assert telemetry.ROW_METRIC_DEFAULTS == jax_telemetry.ROW_METRIC_DEFAULTS
    assert port.row_fields() == ref.row_fields()
    assert port.snapshot() == ref.snapshot()
    with telemetry.metrics_scope() as empty:
        pass
    assert empty.row_fields() == telemetry.ROW_METRIC_DEFAULTS


# -- names -----------------------------------------------------------------------

_EMITTERS = {"span", "instant", "record", "record_max", "completed_event"}


def _emitted_names():
    """(file, line, name) of every literal name the port passes to an
    emitter (``telemetry.span(...)``, ``trace.instant(...)``, ...)."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMITTERS and node.args):
                continue
            base = node.func.value
            if not (isinstance(base, ast.Name) and base.id in ("telemetry", "trace")):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                found.append((path.relative_to(REPO), node.lineno, arg.value))
    return found


def test_names_are_jax_names_and_every_emitted_name_is_registered():
    for mine, theirs in ((names.SPAN_NAMES, jax_names.SPAN_NAMES),
                         (names.INSTANT_NAMES, jax_names.INSTANT_NAMES),
                         (names.METRIC_NAMES, jax_names.METRIC_NAMES)):
        assert set(mine) <= set(theirs)
        assert all(mine[k] == theirs[k] for k in mine)
    emitted = _emitted_names()
    registered = names.all_names()
    assert not [e for e in emitted if e[2] not in registered]
    # the registry holds nothing the port never emits
    assert {e[2] for e in emitted} == set(registered)
    # the slice's sites are all there
    assert {"worker.row", "runtime.barrier", "serve.drain", "serve.handoff",
            "overlap.ring_step", "topo.recompose"} <= {e[2] for e in emitted}


# -- the row columns ----------------------------------------------------------


def _cpu_config(**over):
    cfg = {"primitive": "tp_columnwise", "impl_id": "pytorch_0",
           "base_implementation": "pytorch", "options": {}, "m": 64, "n": 32,
           "k": 32, "dtype": "float32", "num_iterations": 20, "num_warmups": 1,
           "validate": True, "time_measurement_backend": "host_clock",
           "barrier_at_each_iteration": True, "device": "cpu"}
    cfg.update(over)
    return cfg


def test_row_columns_are_registered_with_jax_names():
    measured = benchmark_worker(_cpu_config())
    failed = benchmark_worker(_cpu_config(options={"no_such_option": 1}))
    assert failed["error"] and not failed["valid"]
    for row in (measured, failed):
        for key in row:
            assert key in schema.ROW_COLUMNS and schema.ROW_COLUMNS[key].strip(), key
    assert list(measured) == list(failed)  # one CSV header on every path
    # every column of make_result_row but the port's device_kind is a JAX column
    assert set(measured) - {"device_kind"} <= set(jax_schema.ROW_COLUMNS)
    assert all(doc.strip() for doc in schema.ROW_COLUMNS.values())
    for key in TELEMETRY_COLUMNS + SKEW_COLUMNS:
        assert key in jax_schema.ROW_COLUMNS
    # an error row carries the defaults
    for key, default in {**telemetry.ROW_METRIC_DEFAULTS,
                         **clocksync.SKEW_ROW_DEFAULTS}.items():
        assert _same(failed[key], default), (key, failed[key])
    assert math.isnan(failed["hbm_peak_gib"])


def test_member_columns_are_registered():
    """The columns every port family adds (``extra_row_fields``) are in
    the registry: a static scan of the dict keys those methods return."""
    missing = []
    for path in sorted((PORT / "primitives").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name == "extra_row_fields":
                for sub in ast.walk(node):
                    keys = []
                    if isinstance(sub, ast.Dict):
                        keys = sub.keys
                    elif (isinstance(sub, ast.Subscript) and isinstance(sub.ctx, ast.Store)):
                        keys = [sub.slice]
                    for k in keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                                and k.value not in schema.ROW_COLUMNS:
                            missing.append((str(path.relative_to(REPO)), k.value))
    assert not missing


def test_world_one_tp_columnwise_row_columns():
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    row = benchmark_worker(_cpu_config())
    assert row["valid"] and not row["error"], row
    for key in TELEMETRY_COLUMNS + SKEW_COLUMNS:
        assert key in row
    assert row["barrier_wait_s"] > 0.0
    assert row["loop_overhead_s"] == 0.0  # host_clock rows
    assert row["hbm_high_water_bytes"] == 0 and math.isnan(row["hbm_peak_gib"])  # CPU
    impl = load_impl_class("tp_columnwise", "pytorch")(64, 32, 32, dtype="float32",
                                                      device="cpu")
    assert row["collective_bytes"] == impl.wire_bytes()
    assert repr({k: row[k] for k in SKEW_COLUMNS}) == repr(clocksync.SKEW_ROW_DEFAULTS)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_tp_wire_bytes_equal_jax(d):
    """The tp families' wire census (``collective_bytes``) against the
    JAX members' on the same (m, n, k, dtype, d)."""
    from types import SimpleNamespace

    from ddlb_tpu.primitives.tp_columnwise.base import TPColumnwise as JaxCol
    from ddlb_tpu.primitives.tp_columnwise.quantized import QuantizedTPColumnwise as JaxQCol
    from ddlb_tpu.primitives.tp_rowwise.base import TPRowwise as JaxRow
    from ddlb_tpu_torch.primitives.tp_columnwise.base import TPColumnwise
    from ddlb_tpu_torch.primitives.tp_columnwise.compute_only import ComputeOnlyTPColumnwise
    from ddlb_tpu_torch.primitives.tp_columnwise.quantized import QuantizedTPColumnwise
    from ddlb_tpu_torch.primitives.tp_rowwise.base import TPRowwise

    for dtype in ("bfloat16", "float32"):
        shape = SimpleNamespace(m=96 * d, n=40, k=72, dtype=dtype, num_partitions=d)
        for port, jax in ((TPColumnwise, JaxCol), (QuantizedTPColumnwise, JaxQCol),
                          (TPRowwise, JaxRow)):
            assert port.wire_bytes(shape) == jax.wire_bytes(shape), (port, d, dtype)
        assert ComputeOnlyTPColumnwise.wire_bytes(shape) == 0.0


def test_failing_wire_bytes_warns_and_keeps_the_row(monkeypatch, capsys):
    from ddlb_tpu_torch.primitives.tp_columnwise.pytorch import PyTorchTPColumnwise

    def broken(self):
        raise ArithmeticError("no census")

    monkeypatch.setattr(PyTorchTPColumnwise, "wire_bytes", broken)
    row = benchmark_worker(_cpu_config(num_iterations=2))
    assert row["valid"] and not row["error"] and row["collective_bytes"] == 0.0
    assert "wire_bytes() failed for pytorch_0: ArithmeticError: no census" in \
        capsys.readouterr().out


def _serving_config(**over):
    cfg = _cpu_config(
        primitive="serving_load", impl_id="engine_0", base_implementation="engine",
        m=16, n=64, k=128, num_iterations=2,
        options={"rate": 768.0, "batch": 4, "vocab": 128, "n_heads": 4, "n_requests": 8,
                 "out_mean": 4, "out_max": 8},
    )
    cfg.update(over)
    return cfg


def _spans(directory):
    return [e for e in jax_telemetry.read_events(str(directory)) if e.get("ph") == "X"]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"] + 1e-3
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


def test_world_one_serving_load_row_and_its_trace(trace_dir):
    before = telemetry.global_snapshot().get("serve.ticks", 0.0)
    row = benchmark_worker(_serving_config())
    ticks = telemetry.global_snapshot().get("serve.ticks", 0.0) - before
    assert row["valid"] and not row["error"], row
    for key in TELEMETRY_COLUMNS + SKEW_COLUMNS:
        assert key in row
    assert row["barrier_wait_s"] > 0.0 and row["collective_bytes"] == 0.0
    events = jax_telemetry.read_events(str(trace_dir))
    spans = [e for e in events if e.get("ph") == "X"]
    (outer,) = [e for e in spans if e["name"] == "worker.row"]
    phases = [e for e in spans if e["name"].startswith("worker.") and e is not outer]
    assert sorted(e["name"] for e in phases) == [
        "worker.setup", "worker.timing", "worker.validate", "worker.warmup"]
    assert all(_inside(e, outer) and e["args"]["depth"] == 1 for e in phases)
    drains = [e for e in spans if e["name"] == "serve.drain"]
    assert len(drains) == row["drains"] == 1 + 2 + 1  # warmup, timed, validation
    admits = [e for e in spans if e["name"] == "serve.admit"]
    assert admits and all(any(_inside(a, d) for d in drains) for a in admits)
    marks = [e for e in events if e["name"] == "serve.ticks" and e["ph"] == "i"]
    assert len(marks) == len(drains)
    assert sum(e["args"]["steps"] for e in marks) == ticks == row["drain_ticks"]
    assert len([e for e in events if e["name"] == "serve.slo"]) == len(drains)
    barriers = [e for e in spans if e["name"] == "runtime.barrier"]
    exchanges = [e for e in events if e["name"] == "clocksync.exchange"]
    assert len(barriers) == len(exchanges) == 2  # one per timed call


def test_phase_spans_nest_and_the_runner_merges(trace_dir, tmp_path):
    runner = PrimitiveBenchmarkRunner(
        "tp_columnwise", 64, 32, 32, {"pytorch_0": {"implementation": "pytorch"}},
        dtype="float32", num_iterations=3, num_warmups=1, device="cpu",
        output_csv=str(tmp_path / "rows.csv"), profile_dir=str(tmp_path / "prof"))
    (row,) = runner.run()
    assert row["valid"], row
    merged = trace_dir / "trace.json"
    assert merged.is_file()
    events = json.loads(merged.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    (outer,) = [e for e in spans if e["name"] == "worker.row"]
    assert outer["cat"] == "row" and outer["args"]["impl"] == "pytorch_0"
    names_in = sorted(e["name"] for e in spans
                      if e["name"].startswith("worker.") and e is not outer)
    assert names_in == ["worker.profile", "worker.setup", "worker.timing",
                        "worker.validate", "worker.warmup"]
    assert all(_inside(e, outer) for e in spans if e["name"].startswith("worker."))
    (timing,) = [e for e in spans if e["name"] == "worker.timing"]
    barriers = [e for e in spans if e["name"] == "runtime.barrier"]
    # one a timed call, then the runner's barrier before the merge
    assert [_inside(b, timing) for b in barriers] == [True, True, True, False]
    assert barriers[-1]["ts"] > outer["ts"] + outer["dur"]
    assert [e["name"] for e in spans].count("runner.csv_append") == 1
    # the profiler window's Chrome trace
    prof = json.loads((tmp_path / "prof" / "pytorch_0-p0.json").read_text())
    assert prof["traceEvents"]


def test_port_shard_loads_in_the_jax_tools(trace_dir):
    with telemetry.span("worker.row", cat="row", impl="x"):
        with telemetry.span("worker.timing", cat="timing"):
            telemetry.instant("clocksync.exchange", cat="clocksync", mono_t=1.0)
        telemetry.log("hello", name="n", level_of="x")
    shards = sorted(os.listdir(trace_dir))
    assert len(shards) == 1 and shards[0].startswith("trace-") and \
        shards[0].endswith(f"-p0-{os.getpid()}.jsonl")
    events = jax_telemetry.read_events(str(trace_dir))
    assert events == telemetry.read_events(str(trace_dir))
    assert events[0]["ph"] == "M" and events[0]["name"] == "process_name"
    assert [e["seq"] for e in events] == list(range(1, len(events) + 1))
    merged = jax_telemetry.merge_trace(str(trace_dir))
    assert json.loads(Path(merged).read_text())["traceEvents"][0]["ph"] == "M"
    spec = importlib.util.spec_from_file_location("trace_report",
                                                  REPO / "scripts" / "trace_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    phases, wall_ms = report.phase_breakdown(events)
    assert set(phases) == {"row", "timing"} and wall_ms > 0.0
    assert phases["row"]["count"] == phases["timing"]["count"] == 1


def test_unwritable_trace_dir_disables_tracing_once(tmp_path, monkeypatch, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("DDLB_TPU_TRACE", str(blocker / "sub"))
    with telemetry.span("worker.row"):
        telemetry.instant("log")
    assert telemetry.get_tracer() is None
    out = capsys.readouterr().out
    assert out.count("tracing disabled for this process") == 1
    row = benchmark_worker(_cpu_config(num_iterations=2))
    assert row["valid"] and not row["error"]


# -- the logger ------------------------------------------------------------------


def test_logger_format_and_mirror(trace_dir, capsys, monkeypatch):
    monkeypatch.setenv("RANK", "3")
    telemetry.log("done", b=2, a="x")
    telemetry.warn("two\nlines", name="clash", cat=1)
    telemetry.error("bad")
    telemetry.log("quiet", mirror=False)
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "[ddlb_tpu_torch][p3] done  a=x b=2",
        "[ddlb_tpu_torch][p3] WARNING: two",
        "[ddlb_tpu_torch][p3] lines  cat=1 name=clash",
        "[ddlb_tpu_torch][p3] ERROR: bad",
        "[ddlb_tpu_torch][p3] quiet",
    ]
    logs = [e for e in telemetry.read_events(str(trace_dir)) if e["name"] == "log"]
    assert [e["args"]["message"] for e in logs] == ["done", "two\nlines", "bad"]
    assert [e["args"]["level"] for e in logs] == ["info", "warning", "error"]
    assert logs[0]["args"]["a"] == "x" and logs[0]["args"]["rank"] == 3
    assert logs[1]["args"]["field_name"] == "clash" and logs[1]["args"]["field_cat"] == 1
    assert logs[1]["cat"] == "log"
