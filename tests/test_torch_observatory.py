"""The port's observatory against the JAX package's, on the CPU.

The regression detector (``regress.detect_all`` and each of its gates) on
one set of seeded synthetic history and current rows, the health
verdict, the live stream's fold of a port sweep's events, the
``DDLB_TPU_RUN_ID`` override, ``sim_report``'s world, and the four
report CLIs' ``--json`` documents (``sweep_dash``'s text and HTML
frames) against the JAX scripts called in-process, with their exit codes.
"""

import importlib.util
import json
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from ddlb_tpu.observatory import health as jax_health
from ddlb_tpu.observatory import live as jax_live
from ddlb_tpu.observatory import regress as jax_regress
from ddlb_tpu_torch.benchmark import PrimitiveBenchmarkRunner
from ddlb_tpu_torch.cli import calib_report, observatory_report, sim_report, sweep_dash
from ddlb_tpu_torch.observatory import health, live, regress, store
from ddlb_tpu_torch.primitives.registry import _RENAMED

REPO = Path(__file__).resolve().parent.parent

#: the port's member names -> the JAX package's
JAX_MEMBER = {port: jax for jax, port in _RENAMED.items()}

#: a world-1 CPU sweep a run: both tp families, every member with a plain
#: CPU path, at m = n = k <= 256
BANK_SWEEPS = (
    ("tp_columnwise", (128, 64, 64)),
    ("tp_rowwise", (128, 64, 64)),
)
BANK_MEMBERS = {
    "pytorch_0": {"implementation": "pytorch"},
    "compute_only_0": {"implementation": "compute_only"},
    "cuda_0": {"implementation": "cuda"},
    "overlap_0": {"implementation": "overlap", "algorithm": "chunked", "chunk_count": 2},
    "overlap_1": {"implementation": "overlap", "algorithm": "chunked", "chunk_count": 1},
}


def run_sweeps(run_id, sweeps=BANK_SWEEPS, members=BANK_MEMBERS):
    """The port's runner over ``sweeps`` under ``DDLB_TPU_RUN_ID=run_id``
    (the caller sets ``DDLB_TPU_HISTORY`` / ``DDLB_TPU_LIVE``)."""
    os.environ[store.RUN_ID_ENV] = run_id
    try:
        rows = []
        for primitive, (m, n, k) in sweeps:
            rows += PrimitiveBenchmarkRunner(
                primitive, m, n, k, dict(members), dtype="float32", num_iterations=2,
                num_warmups=1, device="cpu").run()
        return rows
    finally:
        del os.environ[store.RUN_ID_ENV]


def write_bank(directory, runs=("run-a", "run-b")):
    """A bank the port's runner writes on the CPU: one sweep a run id."""
    saved = os.environ.get(store.HISTORY_ENV)
    os.environ[store.HISTORY_ENV] = str(directory)
    try:
        for run in runs:
            run_sweeps(run)
    finally:
        if saved is None:
            del os.environ[store.HISTORY_ENV]
        else:
            os.environ[store.HISTORY_ENV] = saved
    return str(directory)


def jax_bank(port_dir, jax_dir):
    """The port's bank with its rows named as the JAX package names them
    (members, the ``cpu`` entry's ``cpu-sim``), for the JAX gates."""
    os.makedirs(jax_dir, exist_ok=True)
    with open(os.path.join(port_dir, store.HISTORY_FILENAME)) as f, \
            open(os.path.join(jax_dir, store.HISTORY_FILENAME), "w") as out:
        for line in f:
            record = json.loads(line)
            row = record["row"]
            row["base_implementation"] = JAX_MEMBER.get(row["base_implementation"],
                                                        row["base_implementation"])
            row["chip"] = "cpu-sim"
            record["key"] = store.row_key(row)
            out.write(json.dumps(record) + "\n")
    return str(jax_dir)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    return write_bank(tmp_path_factory.mktemp("bank"))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dumps(obj):
    return json.dumps(obj, sort_keys=True, default=str)


# -- the store's run id -------------------------------------------------------------


def test_run_id_override_names_the_banked_rows(tmp_path, monkeypatch):
    monkeypatch.delenv(store.RUN_ID_ENV, raising=False)
    own = store.run_id()
    assert own and store.run_id() == own
    monkeypatch.setenv(store.RUN_ID_ENV, "  shared-run  ")
    assert store.run_id() == "shared-run"
    assert store.bank_row({"primitive": "tp_columnwise", "m": 1}, str(tmp_path))
    (record,) = store.load_history(str(tmp_path))
    assert record["run_id"] == "shared-run"
    monkeypatch.setenv(store.RUN_ID_ENV, "")
    assert store.run_id() == own


# -- the detector ---------------------------------------------------------------------


def _row(impl, m, median_ms, **extra):
    row = {"chip": "cpu", "primitive": "tp_columnwise", "base_implementation": impl,
           "implementation": f"{impl}_0", "option": "transport=ici", "m": m, "n": 64,
           "k": 64, "dtype": "float32", "world_size": 4, "num_processes": 4,
           "time_measurement_backend": "host_clock", "median time (ms)": median_ms,
           "predicted_s": 1e-4}
    row.update(extra)
    return row


def synthetic_bank(seed):
    """(history records, current rows) with every gate's signal: a time
    regression, a key with no history (the prior), an SLO tail, a skew
    and a calibration drift, and a persistent straggler."""
    rng = np.random.default_rng(seed)
    history, current = [], []
    for run in range(5):
        rid = f"r{run}"
        rows = [
            _row("pytorch", 128, 10.0 + rng.normal(0.0, 0.2)),
            _row("pytorch", 256, 20.0 + rng.normal(0.0, 0.3)),
            _row("overlap", 128, 8.0 + rng.normal(0.0, 0.1),
                 slo_ttft_p99_ms=50.0 + rng.normal(0.0, 1.0), slo_goodput_rps=4.0,
                 serve_topology="single"),
            _row("cuda", 128, 5.0 + rng.normal(0.0, 0.05),
                 straggler_frac=0.05 + rng.uniform(0.0, 0.01),
                 skew_enter_s=0.01 + rng.uniform(0.0, 0.002), clock_unc_s=0.001,
                 straggler_rank=2 if run < 3 else -1),
            _row("compute_only", 128, 4.0 + rng.normal(0.0, 0.05),
                 cal_residual_frac=0.01 + rng.normal(0.0, 0.005), cal_version="v1"),
            _row("quantized", 128, 6.0, straggler_rank=2, skew_enter_s=0.2,
                 clock_unc_s=0.01),
        ]
        history += [{"key": store.row_key(r), "run_id": rid, "kind": "row", "row": r}
                    for r in rows]
    current = [
        _row("pytorch", 128, 15.0),
        _row("pytorch", 256, 20.1),
        _row("overlap", 128, 8.0, slo_ttft_p99_ms=120.0, slo_goodput_rps=1.0,
             serve_topology="single"),
        _row("cuda", 128, 5.0, straggler_frac=0.5, skew_enter_s=0.4,
             clock_unc_s=0.001, straggler_rank=1),
        _row("compute_only", 128, 4.0, cal_residual_frac=0.4, cal_version="v1"),
        _row("quantized", 128, 6.0, straggler_rank=2, skew_enter_s=0.3,
             clock_unc_s=0.01),
        _row("pytorch", 512, 50.0, predicted_s=1e-3),
        _row("pytorch", 1024, 5.0, predicted_s=1e-3, predicted_cal_s=5e-4),
        _row("pytorch", 2048, float("nan")),
    ]
    return history, current


DETECTORS = ("detect_all", "detect", "detect_slo", "detect_skew", "detect_calibration",
             "detect_health")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", DETECTORS)
def test_detectors_equal_jax(name, seed):
    """Each gate, and their union, gives the JAX package's findings in
    the same order, field for field."""
    history, current = synthetic_bank(seed)
    for exclude in (None, "r4"):
        ours = getattr(regress, name)(current, history, exclude_run=exclude)
        theirs = getattr(jax_regress, name)(current, history, exclude_run=exclude)
        assert _dumps(ours) == _dumps(theirs)
    if name == "detect_all":
        sources = {f["source"] for f in ours}
        metrics = {f["metric"] for f in ours}
        assert sources == {"health", "history", "perfmodel_prior"}
        assert {"median time (ms)", "slo_ttft_p99_ms", "straggler_frac",
                "cal_residual_frac", "persistent_straggler"} <= metrics


def test_detector_thresholds_are_jax_thresholds():
    for name in ("Z_TOL", "MIN_EXCESS", "REL_FLOOR", "PRIOR_FACTOR", "MEASURE_COLUMN",
                 "SLO_METRICS", "SLO_ABS_DEFAULT", "SLO_ABS", "SLO_MIN_HISTORY",
                 "SKEW_METRICS", "CAL_METRICS"):
        assert getattr(regress, name) == getattr(jax_regress, name), name
    for values in ([], [1.0], [3.0, 1.0, 2.0], [1.0, 2.0, 3.0, 10.0]):
        for fn in ("median", "mad"):
            ours, theirs = getattr(regress, fn)(values), getattr(jax_regress, fn)(values)
            assert ours == theirs or (math.isnan(ours) and math.isnan(theirs))
    for value in (1, "2.5", None, "x", float("inf"), float("nan")):
        assert regress.finite(value) == jax_regress.finite(value)


# -- the health verdict ---------------------------------------------------------------


def _obs(rank, skew, unc=0.001, run="r0"):
    return {"rank": rank, "skew_s": skew, "unc_s": unc, "run_id": run}


VERDICT_CASES = {
    "empty": [],
    "one skewed row": [_obs(1, 0.5)],
    "persistent": [_obs(2, 0.2, run=f"r{i}") for i in range(4)] + [_obs(1, 0.1)],
    "alternating": [_obs(i % 3, 0.2, run=f"r{i}") for i in range(6)],
    "below the floor": [_obs(2, 0.01) for _ in range(5)],
    "inside the uncertainty": [_obs(2, 0.2, unc=0.5) for _ in range(5)],
    "no alignment claim": [_obs(2, 0.2, unc=float("nan")) for _ in range(5)],
    "no rank": [_obs(-1, 0.3) for _ in range(5)] + [_obs(None, 0.3)],
    "two of three": [_obs(2, 0.3), _obs(2, 0.3), _obs(0, 0.3)],
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
@pytest.mark.parametrize("world", [None, 1, 4])
def test_health_verdict_equals_jax(case, world):
    observations = VERDICT_CASES[case]
    ours = health.verdict_from_observations(observations, world=world)
    theirs = jax_health.verdict_from_observations(observations, world=world)
    assert _dumps(ours) == _dumps(theirs)
    for obs in observations:
        args = (obs["rank"], obs["skew_s"], obs["unc_s"], health.MIN_SKEW_S)
        assert health.qualifying_rank(*args) == jax_health.qualifying_rank(*args)


def test_health_observations_and_constants_equal_jax():
    history, current = synthetic_bank(3)
    assert _dumps(health.observations_from_history(history)) == _dumps(
        jax_health.observations_from_history(history))
    assert _dumps(health.observations_from_history(history, run_id="r1")) == _dumps(
        jax_health.observations_from_history(history, run_id="r1"))
    assert _dumps(health.observations_from_rows(current)) == _dumps(
        jax_health.observations_from_rows(current))
    for rank, world in ((0, None), (0, 1), (0, 4), (3, 4)):
        assert health.link_candidates(rank, world) == jax_health.link_candidates(rank, world)
    for name in ("MIN_OBSERVATIONS", "DOMINANCE", "MIN_SKEW_S", "HEALTHY", "TRANSIENT",
                 "PERSISTENT"):
        assert getattr(health, name) == getattr(jax_health, name)


# -- the live stream ------------------------------------------------------------------


def test_live_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(live.LIVE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    assert live.post_event("row_start", impl="x") is False
    run_sweeps("quiet", sweeps=(("tp_columnwise", (64, 32, 32)),),
               members={"pytorch_0": {"implementation": "pytorch"}})
    assert list(tmp_path.iterdir()) == []


def test_live_fold_of_a_port_sweep_equals_jax(tmp_path, monkeypatch):
    """A world-1 sweep and two serving rows post the runner's events and
    the drains' ticks; both packages read and fold them alike."""
    path = tmp_path / "live" / "stream.jsonl"
    monkeypatch.setenv(live.LIVE_ENV, str(path))
    rows = run_sweeps("live")
    serving = dict(batch=4, vocab=64, n_heads=4, n_requests=8, out_mean=4, out_max=8,
                   n_kv_heads=2, prefix_pop=3, prefix_len=6, rate=1e9)
    rows += PrimitiveBenchmarkRunner(
        "serving_load", 8, 32, 64,
        {"engine_0": {"implementation": "engine", **serving},
         "router_0": {"implementation": "router", **serving}},
        dtype="float32", num_iterations=2, num_warmups=1, device="cpu").run()
    events, offset = live.read_events(str(path))
    assert (events, offset) == jax_live.read_events(str(path))
    kinds = [e["kind"] for e in events]
    assert kinds.count("sweep_start") == kinds.count("sweep_done") == 3
    assert kinds.count("row_start") == kinds.count("row_done") == len(rows) == 12
    assert {e["stage"] for e in events if e["kind"] == "row_phase"} == {
        "setup", "warmup", "timing", "validate"}
    ticks = [e for e in events if e["kind"] == "serving_tick"]
    assert ticks and any("shard_depths" in e for e in ticks)
    ours, theirs = live.fold(events), jax_live.fold(events)
    assert _dumps(ours) == _dumps(theirs)
    assert ours["totals"]["done"] == ours["totals"]["total"] == 12
    assert ours["sweep_done"] and not ours["unknown"] and not ours["current"]
    done = [e for e in events if e["kind"] == "row_done"]
    assert [e["roofline_frac"] for e in done[:10]] == [r["roofline_frac"] for r in rows[:10]]
    # folded incrementally from a byte offset, as the dashboard tails it
    half = len(events) // 2
    state = live.fold(events[:half])
    assert _dumps(live.fold(events[half:], state)) == _dumps(ours)


# -- sim_report's world ------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["h100-sxm:4x2x4", "h100-sxm:0x8", "v5p:4x16x16"])
def test_sim_report_refuses_a_bad_world(spec, capsys):
    """A malformed spec, a TPU chip the port does not price, and an H100
    node of two dimensions are usage errors."""
    with pytest.raises(SystemExit) as exc:
        sim_report.main(["--topology", spec, "--json"])
    assert exc.value.code == 2
    capsys.readouterr()


def test_sim_report_default_world_is_the_h100_preset(capsys):
    assert sim_report.main(["--json", "--families", "dp_allreduce"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["topology"] == {"spec": "h100-sxm:128x8", "chip": "h100-sxm", "pods": 128,
                               "ici_mesh": [8], "chips": 1024}


# -- the report CLIs against the JAX scripts -------------------------------------------


def _both(capsys, ours, theirs, argv, jax_argv=None):
    """(our exit code, stdout), (the JAX script's exit code, stdout)."""
    rc_ours = ours.main(list(argv))
    out_ours = capsys.readouterr().out
    rc_theirs = theirs.main(list(jax_argv if jax_argv is not None else argv))
    out_theirs = capsys.readouterr().out
    return (rc_ours, out_ours), (rc_theirs, out_theirs)


@pytest.mark.parametrize("args", [[], ["--run", "run-a"], ["--prior-factor", "1e9"],
                                  ["--z-tol", "0.5", "--min-excess", "0"]])
def test_observatory_report_equals_jax(bank, capsys, args):
    (rc, out), (jax_rc, jax_out) = _both(
        capsys, observatory_report, _script("observatory_report"),
        ["--history", bank, "--json", *args])
    assert rc == jax_rc
    assert json.loads(out) == json.loads(jax_out)
    report = json.loads(out)
    assert report["history_runs"] == 2 and report["current_rows"] == 10
    # text frames too
    (rc, out), (jax_rc, jax_out) = _both(
        capsys, observatory_report, _script("observatory_report"),
        ["--history", bank, *args])
    assert (rc, out) == (jax_rc, jax_out)


def test_observatory_report_current_csv_and_usage(bank, tmp_path, capsys, monkeypatch):
    csv_path = tmp_path / "current.csv"
    monkeypatch.setenv(store.HISTORY_ENV, str(tmp_path / "cur"))
    os.environ[store.RUN_ID_ENV] = "run-c"
    try:
        PrimitiveBenchmarkRunner("tp_columnwise", 128, 64, 64, dict(BANK_MEMBERS),
                                 dtype="float32", num_iterations=2, num_warmups=1,
                                 device="cpu", output_csv=str(csv_path)).run()
    finally:
        del os.environ[store.RUN_ID_ENV]
    shutil.copy(os.path.join(bank, store.HISTORY_FILENAME), tmp_path / "cur" / "merged")
    with open(tmp_path / "cur" / store.HISTORY_FILENAME, "a") as f:
        f.write((tmp_path / "cur" / "merged").read_text())
    for args in (["--history", str(tmp_path / "cur"), "--current", str(csv_path), "--json"],
                 ["--history"], [], ["--history", bank, "--bogus"]):
        monkeypatch.delenv(store.HISTORY_ENV, raising=False)
        if args == ["--history"]:
            with pytest.raises(SystemExit):
                observatory_report.main(list(args))
            with pytest.raises(SystemExit):
                _script("observatory_report").main(list(args))
            continue
        (rc, out), (jax_rc, jax_out) = _both(
            capsys, observatory_report, _script("observatory_report"), args)
        assert rc == jax_rc
        if "--json" in args:
            report = json.loads(out)
            assert report == json.loads(jax_out)
            assert report["self_excluded"] == 5 and report["current_rows"] == 5
        else:
            assert rc == 2 and out == jax_out


def test_calib_report_equals_jax(bank, tmp_path, capsys):
    ours_path, jax_path = str(tmp_path / "ours.json"), str(tmp_path / "jax.json")
    rc = calib_report.main(["--history", bank, "--json", "--fit", "--calib", ours_path])
    out = json.loads(capsys.readouterr().out)
    jax_script = _script("calib_report")
    jax_rc = jax_script.main(["--history", bank, "--json", "--fit", "--calib", jax_path])
    jax_out = json.loads(capsys.readouterr().out)
    assert rc == jax_rc == 0
    assert out["fitted"] and out["table"] is not None
    for doc in (out, jax_out):
        doc.pop("calib_path")
        doc["table"].pop("banked_at")
    assert out == jax_out
    # the table written, read back by both
    for argv in (["--history", bank, "--json", "--calib", ours_path],
                 ["--history", bank, "--calib", ours_path, "--top", "3"],
                 ["--history", bank, "--json"], ["--bogus"]):
        (rc, text), (jax_rc, jax_text) = _both(capsys, calib_report, jax_script, argv)
        assert rc == jax_rc
        if "--json" in argv:
            assert json.loads(text) == json.loads(jax_text)
        else:
            assert text == jax_text


SIM_ARGS = [
    ["--topology", "{chip}:4x2x4"],
    ["--topology", "{chip}:2x8", "--payload-mib", "8", "--families", "dp_allreduce,collectives"],
    ["--topology", "{chip}:16x16x16", "--families", "ep_alltoall"],
    ["--topology", "{chip}:4x2x4", "--degrade", "dcn=0.25", "--degrade", "ici1=0"],
    ["--topology", "{chip}:2x4x4", "--degrade", "dcn=0,ici0=0.5"],
]


@pytest.mark.parametrize("args", SIM_ARGS, ids=lambda a: " ".join(a[1:]))
def test_sim_report_ranking_equals_jax(capsys, args):
    """The ranking and the degraded ranking on ``cpu`` worlds: the JAX
    script's documents with its ``cpu-sim`` name read as ``cpu``."""
    ours_argv = [a.format(chip="cpu") for a in args] + ["--json"]
    jax_argv = [a.format(chip="cpu-sim") for a in args] + ["--json", "--no-members"]
    (rc, out), (jax_rc, jax_out) = _both(capsys, sim_report, _script("sim_report"),
                                         ours_argv, jax_argv)
    assert rc == jax_rc == 0
    assert json.loads(out) == json.loads(jax_out.replace("cpu-sim", "cpu"))
    (rc, out), (jax_rc, jax_out) = _both(
        capsys, sim_report, _script("sim_report"), ours_argv[:-1], jax_argv[:-2] + [
            "--no-members"])
    assert rc == jax_rc == 0
    assert out == jax_out.replace("cpu-sim", "cpu")


def test_sim_report_validate_equals_jax(bank, tmp_path, capsys, monkeypatch):
    """``--validate`` over the bank: gate 1 on every family, gate 2 over
    the bank (the JAX script over the same rows named as it names them),
    the same exit codes; an empty bank fails gate 2 in both."""
    monkeypatch.delenv("DDLB_TPU_CALIB", raising=False)
    jax_dir = jax_bank(bank, tmp_path / "jax")
    (rc, out), (jax_rc, jax_out) = _both(
        capsys, sim_report, _script("sim_report"), ["--validate", "--json", "--history", bank],
        ["--validate", "--json", "--history", jax_dir])
    ours, theirs = json.loads(out), json.loads(jax_out)
    assert rc == jax_rc == 0 and ours["ok"] and theirs["ok"]
    cf, jax_cf = ours["validation"]["closed_form"], theirs["validation"]["closed_form"]
    assert cf["checked"] == jax_cf["checked"] == 22 and cf["failures"] == []
    assert cf["max_rel_err"] <= 1e-9
    assert ours["validation"]["history"] == theirs["validation"]["history"]
    assert ours["validation"]["history"]["checked"] == 10
    empty = str(tmp_path / "empty")
    (rc, out), (jax_rc, jax_out) = _both(capsys, sim_report, _script("sim_report"),
                                         ["--validate", "--history", empty])
    assert rc == jax_rc == 1 and "VALIDATION FAILED" in out
    for bad in (["--topology", "v5p:4x16x16"], ["--degrade", "dcn=2"], ["--families", "x"]):
        with pytest.raises(SystemExit) as exc:
            sim_report.main(bad)
        assert exc.value.code == 2
    capsys.readouterr()


def test_sweep_dash_equals_jax(tmp_path, capsys, monkeypatch):
    path = tmp_path / "stream.jsonl"
    monkeypatch.setenv(live.LIVE_ENV, str(path))
    run_sweeps("dash", sweeps=(("tp_columnwise", (64, 32, 32)),))
    live.post_event("row_done", impl="serve_0", slo_ttft_p50_ms=4.0, slo_ttft_p95_ms=9.0,
                    slo_ttft_p99_ms=12.0, slo_goodput_rps=3.5, slo_attainment=0.9,
                    straggler_rank=1, skew_enter_s=0.2, straggler_frac=0.4)
    for depth in (0, 3, 5, 2):
        live.post_event("serving_tick", queue_depth=depth, active=2, done=1, total=8,
                        shard_depths=[depth, -1])
    live.post_event("future_kind", x=1)
    monkeypatch.delenv(live.LIVE_ENV)
    jax_script = _script("sweep_dash")
    (rc, out), (jax_rc, jax_out) = _both(capsys, sweep_dash, jax_script,
                                         [str(path), "--once"])
    assert rc == jax_rc == 0 and out == jax_out
    assert "rank lanes" in out and "serving:" in out and "future_kind x1" in out
    ours_html, jax_html = tmp_path / "ours.html", tmp_path / "jax.html"
    assert sweep_dash.main([str(path), "--html", str(ours_html)]) == 0
    assert jax_script.main([str(path), "--html", str(jax_html)]) == 0
    capsys.readouterr()

    def unstamped(p):
        return [line for line in p.read_text().splitlines() if "rendered" not in line]

    assert unstamped(ours_html) == unstamped(jax_html)
    missing = str(tmp_path / "none.jsonl")
    (rc, _), (jax_rc, _) = _both(capsys, sweep_dash, jax_script, [missing, "--once"])
    assert rc == jax_rc == 1
    (rc, _), (jax_rc, _) = _both(capsys, sweep_dash, jax_script, ["--once"])
    assert rc == jax_rc == 2
