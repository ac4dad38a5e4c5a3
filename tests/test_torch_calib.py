"""The port's history bank and calibration against the JAX package's.

The same seeded synthetic bank through both packages' fitters gives the
same constants (to 1e-9) and the same ``version``; the features, census
and ``predict_row`` agree row by row; the table round-trips and
``DDLB_TPU_CALIB`` gates it; ``bank_row`` / ``iter_history`` /
``load_history`` read what they wrote, and the JAX reader reads the
port's bank; the runner banks its rows under ``DDLB_TPU_HISTORY``; the
calibrated prediction and the handoff's calibrated price equal JAX's; and
a row under ``DDLB_TPU_CALIB`` carries the calibrated trio.
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from ddlb_tpu.observatory import calibrate as jax_calibrate
from ddlb_tpu.observatory import store as jax_store
from ddlb_tpu.perfmodel import calib as jax_calib
from ddlb_tpu.perfmodel import cost as jax_cost
from ddlb_tpu.perfmodel import specs as jax_specs
from ddlb_tpu_torch.benchmark import PrimitiveBenchmarkRunner, benchmark_worker
from ddlb_tpu_torch.observatory import calibrate, store
from ddlb_tpu_torch.perfmodel import calib, cost, specs

FAMILIES = ("tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall",
            "cp_ring_attention", "pp_pipeline", "collectives", "transformer_step")
#: what the synthetic rows were measured with
TRUE = {"dispatch_s": 4e-5, "step_s": 6e-6, "ici": 9e-6, "dcn": 3e-5,
        "kv_setup_s": 2e-4, "kv_per_byte_s": 2.5e-12}


def _synthetic_bank(seed, rows=120, chips=("cpu", "h100-sxm")):
    """Banked records of rows whose medians follow the residual model
    (the true constants plus Laplace noise and a few gross outliers), and
    serving rows with a handoff ledger; some rows the fitter must refuse."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(rows):
        family = FAMILIES[i % len(FAMILIES)]
        d = int(rng.choice([1, 2, 4, 8]))
        transport = "dcn" if i % 5 == 0 else "ici"
        chunked = family == "tp_columnwise" and i % 3 == 0
        option = f"transport={transport}"
        if family == "collectives":
            option += f";op={['all_gather', 'all_reduce', 'reduce_scatter'][i % 3]}"
        if chunked:
            option += ";algorithm=chunked;chunk_count=" + str(int(rng.integers(1, 5)))
        compute = float(rng.uniform(1e-4, 5e-3)) if family != "collectives" else 0.0
        comm = float(rng.uniform(1e-5, 2e-3)) if d > 1 and i % 7 else 0.0
        row = {
            "chip": chips[i % len(chips)], "primitive": family,
            "base_implementation": "pytorch", "option": option,
            "m": 64 * (i % 4 + 1), "n": 64, "k": 64, "dtype": "bfloat16",
            "world_size": d, "time_measurement_backend": ("host_clock", "device_loop")[i // 2 % 2],
            "predicted_s": compute + comm, "phase_compute_s": compute,
            "phase_comm_s": comm, "error": "", "valid": True,
        }
        features = jax_calib.row_features({**row, "median time (ms)": 1.0})
        overhead = TRUE["dispatch_s"] + TRUE["step_s"] * features["steps"] + sum(
            TRUE[c] * h for c, h in features["hops"].items())
        noise = float(rng.laplace(0.0, 2e-6))
        if i % 17 == 0:
            noise += 5e-3  # a grossly slow row on a shared host
        row["median time (ms)"] = (row["predicted_s"] + overhead + noise) * 1e3
        records.append({"kind": "row", "row": row})
    for i in range(24):
        handoffs = int(rng.integers(4, 60))
        nbytes = float(handoffs * rng.uniform(1e5, 4e6))
        ms = (TRUE["kv_setup_s"] * handoffs + TRUE["kv_per_byte_s"] * nbytes) * 1e3
        records.append({"kind": "row", "row": {
            "chip": chips[i % len(chips)], "primitive": "serving_load",
            "base_implementation": "disagg", "option": f"rate={i}", "m": 8, "n": 32,
            "k": 64, "dtype": "bfloat16", "world_size": 1,
            "time_measurement_backend": "host_clock", "median time (ms)": 900.0,
            "predicted_s": 0.5, "serve_handoffs": handoffs, "serve_handoff_bytes": nbytes,
            "serve_handoff_ms": ms * float(rng.uniform(0.98, 1.02)), "error": ""}})
    # rows the fits refuse
    records.append({"kind": "row", "row": {**records[0]["row"], "error": "boom"}})
    records.append({"kind": "row", "row": {**records[1]["row"], "median time (ms)": "nan"}})
    records.append({"kind": "row", "row": {**records[2]["row"], "world_degraded": True}})
    return records


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fitters_give_equal_constants_and_version(seed):
    records = _synthetic_bank(seed)
    ours = calibrate.calibrate_history(records=records)
    theirs = jax_calibrate.calibrate_history(records=records)
    assert ours.version == theirs.version
    assert sorted(ours.groups) == sorted(theirs.groups) == [
        (chip, backend) for chip in ("cpu", "h100-sxm")
        for backend in ("device_loop", "host_clock")]
    for key, group in ours.groups.items():
        want = theirs.groups[key].to_json()
        for name, value in group.to_json().items():
            if isinstance(value, dict):
                assert value.keys() == want[name].keys()
                for cls in value:
                    assert value[cls] == pytest.approx(want[name][cls], rel=1e-9, abs=1e-18)
            elif isinstance(value, float):
                assert value == pytest.approx(want[name], rel=1e-9, abs=1e-18), name
            else:
                assert value == want[name], name
        assert group.rows > calib.MIN_ROWS
    # the host_clock groups fitted the handoff constants from the serving rows
    for chip in ("cpu", "h100-sxm"):
        group = ours.groups[(chip, "host_clock")]
        assert group.kv_rows == 12
        assert group.kv_per_byte_s > 0.0 and group.kv_setup_s > 0.0
    assert json.dumps(ours.to_json()["groups"], sort_keys=True) == json.dumps(
        theirs.to_json()["groups"], sort_keys=True)


def test_fit_recovers_the_constants_it_was_made_with():
    table = calibrate.calibrate_history(records=_synthetic_bank(5, rows=400, chips=("cpu",)))
    group = table.group("cpu", "host_clock")
    assert group.dispatch_s == pytest.approx(TRUE["dispatch_s"], rel=0.15)
    assert group.wire_overhead_s("ici") == pytest.approx(TRUE["step_s"] + TRUE["ici"], rel=0.15)
    assert group.wire_overhead_s("dcn") == pytest.approx(TRUE["step_s"] + TRUE["dcn"], rel=0.15)
    assert group.residual_mad_s < 1e-5
    assert calibrate.calibrate_history(records=[]) is None


def test_features_census_and_prediction_equal_jax():
    records = _synthetic_bank(11)
    group = calibrate.calibrate_history(records=records).group("cpu", "host_clock")
    jax_group = jax_calib.GroupCalibration.from_json(group.to_json())
    seen = 0
    for record in records:
        row = record["row"]
        assert calib.row_features(row) == jax_calib.row_features(row)
        assert calib.kv_row_features(row) == jax_calib.kv_row_features(row)
        assert calib.predict_row(row, group) == jax_calib.predict_row(row, jax_group)
        seen += calib.row_features(row) is not None
    assert seen == 120
    for op in ("all_gather", "all_reduce", "reduce_scatter", "all_to_all", "ppermute"):
        for d in (1, 2, 3, 8):
            for chunks in (None, 1, 4):
                for link in ("ici", "dcn"):
                    kw = dict(has_compute=d % 2 == 0, has_wire=d > 1, chunks=chunks,
                              link_class=link)
                    assert calib.schedule_census(op, d, **kw) == \
                        jax_calib.schedule_census(op, d, **kw)
    for family in FAMILIES + ("serving_load", "transformer_decode"):
        assert calib.family_op(family, {"op": "all_to_all"}) == \
            jax_calib.family_op(family, {"op": "all_to_all"})


def test_table_round_trip_and_env_gating(tmp_path, monkeypatch, capsys):
    table = calibrate.calibrate_history(records=_synthetic_bank(2))
    path = calibrate.write_table(table, str(tmp_path / "calib.json"))
    again = calib.load_table(path)
    assert again.to_json() == table.to_json() and again.version == table.version
    # the JAX package reads the port's table and fingerprints it alike
    theirs = jax_calib.load_table(path)
    assert theirs.version == table.version == jax_calib.table_version(theirs.groups)
    monkeypatch.delenv("DDLB_TPU_CALIB", raising=False)
    assert calib.get_table() is None
    monkeypatch.setenv("DDLB_TPU_CALIB", path)
    first = calib.get_table()
    assert first.version == table.version and calib.get_table() is first  # cached
    monkeypatch.setenv("DDLB_TPU_CALIB", str(tmp_path / "missing.json"))
    assert calib.get_table() is None
    (tmp_path / "broken.json").write_text("{not json")
    monkeypatch.setenv("DDLB_TPU_CALIB", str(tmp_path / "broken.json"))
    assert calib.get_table() is None
    out = capsys.readouterr().out
    assert "missing file" in out and "unreadable" in out


def test_bank_and_read_history(tmp_path, monkeypatch):
    monkeypatch.delenv("DDLB_TPU_HISTORY", raising=False)
    row = {"chip": "cpu", "primitive": "tp_columnwise", "base_implementation": "pytorch",
           "option": "order=AG_before", "m": 64, "n": 32, "k": 32, "dtype": "float32",
           "world_size": 1, "time_measurement_backend": "host_clock",
           "median time (ms)": 0.5, "extra": [1, 2]}
    assert not store.bank_row(row) and store.load_history() == []
    assert store.row_key(row) == jax_store.row_key(row)
    monkeypatch.setenv("DDLB_TPU_HISTORY", str(tmp_path / "bank"))
    assert store.bank_row(row)
    assert store.bank_row({**row, "primitive": "collectives", "chip": "h100-sxm"})
    with open(store.history_path(), "a") as f:
        f.write('{"torn": ')  # a process killed mid-write
    records = store.load_history()
    assert [r["row"]["primitive"] for r in records] == ["tp_columnwise", "collectives"]
    assert records[0]["run_id"] == records[1]["run_id"] == store.run_id()
    assert records[0]["kind"] == "row"
    assert records[0]["key"] == store.row_key(row) and records[0]["row"] == row
    assert [r["row"]["chip"] for r in store.iter_history(chip="h100-sxm")] == ["h100-sxm"]
    assert len(list(store.iter_history(family=("tp_columnwise", "collectives")))) == 2
    assert list(store.iter_history(impl="cuda")) == []
    assert list(store.iter_history(kind="bench")) == []
    assert len(list(store.iter_history(predicate=lambda r: r["row"]["m"] == 64))) == 2
    # the JAX package reads the port's bank
    assert [r["row"] for r in jax_store.iter_history(str(tmp_path / "bank"))] == \
        [r["row"] for r in records]
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert not store.bank_row(row, directory=str(blocked / "sub"))


def test_runner_banks_rank_0_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("DDLB_TPU_HISTORY", str(tmp_path / "bank"))
    runner = PrimitiveBenchmarkRunner(
        "tp_columnwise", 64, 32, 32,
        {"pytorch_0": {"implementation": "pytorch"}, "bad_1": {"implementation": "pytorch",
                                                                "no_such": 1}},
        dtype="float32", num_iterations=2, num_warmups=1, device="cpu")
    rows = runner.run()
    banked = [r["row"] for r in store.iter_history()]
    assert [r["implementation"] for r in banked] == ["pytorch_0", "bad_1"]
    assert json.loads(json.dumps(rows[0], default=str)) == banked[0]
    assert banked[0]["chip"] == "cpu" and banked[0]["predicted_s"] > 0
    # the fitter keeps the measured row and refuses the error row
    assert calib.row_features(banked[0]) is not None
    assert calib.row_features(banked[1]) is None


def _stand_in(family, schedule, d, transport, chunks=None, dtype="bfloat16"):
    options = {"transport": transport, "op": "all_gather"}
    if chunks is not None:
        options.update(algorithm="chunked", chunk_count=chunks)
    return SimpleNamespace(
        primitive_name=family, dtype=dtype, num_partitions=d, options=options,
        COST_SCHEDULE=schedule, flops=lambda: 3e12, wire_bytes=lambda: 8e8 if d > 1 else 0.0,
        hbm_bytes=lambda: 2e9, overlap_chunks=lambda: chunks,
        runtime=SimpleNamespace(slice_ids=(0,) * max(1, d // 2) + (1,) * (d - max(1, d // 2))))


@pytest.mark.parametrize("schedule,chunks", [("sequential", None), ("overlap", None),
                                             ("overlap", 3), ("compute_only", None)])
def test_calibrated_estimate_equals_jax(schedule, chunks):
    table = calibrate.calibrate_history(records=_synthetic_bank(4))
    jax_table = jax_calib.CalibrationTable.from_json(table.to_json())
    for family in ("tp_columnwise", "collectives", "transformer_decode", "pp_pipeline"):
        for d in (1, 4):
            for transport in ("ici", "dcn"):
                impl = _stand_in(family, schedule, d, transport, chunks)
                for backend in ("host_clock", "device_loop", "none"):
                    ours = cost.calibrated_estimate(impl, specs.CHIP_SPECS["cpu"], table,
                                                    backend)
                    theirs = jax_cost.calibrated_estimate(impl, jax_specs.get_spec("cpu-sim"),
                                                          _renamed(jax_table), backend)
                    assert ours.predicted_cal_s == pytest.approx(theirs.predicted_cal_s,
                                                                 rel=1e-12)
                    assert ours.overhead_s == pytest.approx(theirs.overhead_s, rel=1e-9,
                                                            abs=1e-18)
                    assert (ours.version, ours.backend) == (theirs.version, theirs.backend)
                    for measured in (float("nan"), ours.predicted_cal_s * 1.3):
                        a, b = ours.residual_frac(measured), theirs.residual_frac(measured)
                        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b)
    assert cost.calibrated_estimate(_stand_in("tp_columnwise", schedule, 2, "ici"),
                                    specs.CHIP_SPECS["cpu"],
                                    calib.make_table({})) is None


def _renamed(table):
    """The table with the JAX package's name for the CPU entry, ``cpu-sim``."""
    groups = {}
    for (chip, backend), group in table.groups.items():
        name = "cpu-sim" if chip == "cpu" else chip
        groups[(name, backend)] = jax_calib.GroupCalibration.from_json(
            {**group.to_json(), "chip": name})
    return jax_calib.CalibrationTable(version=table.version, groups=groups)


def test_calibrated_handoff_price_equals_jax():
    table = calibrate.calibrate_history(records=_synthetic_bank(6))
    group = table.group("cpu", "host_clock")
    jax_group = jax_calib.GroupCalibration.from_json(group.to_json())
    spec, jax_spec = specs.CHIP_SPECS["cpu"], jax_specs.get_spec("cpu-sim")
    for nbytes in (0.0, 1.0, 3.7e6, 2e9):
        for g, jg in ((None, None), (group, jax_group)):
            assert cost.kv_handoff_seconds(nbytes, spec, calib=g) == \
                jax_cost.kv_handoff_seconds(nbytes, jax_spec, calib=jg)
    assert cost.kv_handoff_seconds(3.7e6, spec, calib=group) == pytest.approx(
        group.kv_setup_s + group.kv_per_byte_s * 3.7e6)
    unfitted = calib.GroupCalibration(chip="cpu", backend="host_clock", dispatch_s=1.0,
                                      step_s=1.0)
    assert cost.kv_handoff_seconds(3.7e6, spec, calib=unfitted) == \
        cost.kv_handoff_seconds(3.7e6, spec)


def test_row_under_a_table_carries_the_calibrated_trio(tmp_path, monkeypatch):
    group = calib.GroupCalibration(chip="cpu", backend="host_clock", dispatch_s=2e-5,
                                   step_s=3e-6, hop_s={"ici": 1e-6, "dcn": 0.0}, rows=9)
    table = calib.make_table({("cpu", "host_clock"): group})
    path = calibrate.write_table(table, str(tmp_path / "calib.json"))
    cfg = {"primitive": "tp_columnwise", "impl_id": "pytorch_0",
           "base_implementation": "pytorch", "options": {}, "m": 64, "n": 32, "k": 32,
           "dtype": "float32", "num_iterations": 3, "num_warmups": 1, "device": "cpu"}
    monkeypatch.delenv("DDLB_TPU_CALIB", raising=False)
    plain = benchmark_worker(cfg)
    assert math.isnan(plain["predicted_cal_s"]) and plain["cal_version"] == ""
    monkeypatch.setenv("DDLB_TPU_CALIB", path)
    row = benchmark_worker(cfg)
    assert row["valid"] and not row["error"]
    # one compute step, no wire at world 1: the bound plus one step and the
    # dispatch constant
    assert row["predicted_cal_s"] == pytest.approx(row["predicted_s"] + 3e-6 + 2e-5,
                                                   rel=1e-12)
    assert row["cal_version"] == table.version
    measured = row["median time (ms)"] * 1e-3
    assert row["cal_residual_frac"] == pytest.approx(
        (measured - row["predicted_cal_s"]) / row["predicted_cal_s"])
    # a backend the table has no group for falls back to host_clock's
    loop = benchmark_worker({**cfg, "time_measurement_backend": "device_loop",
                             "device_loop_windows": 2})
    assert loop["cal_version"] == table.version
