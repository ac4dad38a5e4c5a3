"""The ``compiled`` members through the CLI on the CPU: two sweeps back to
back in one process, and ``scripts/config_transformer_step.json``'s
``xla_gspmd`` entry as shipped. Split from ``test_torch_compiled.py`` so
that the test runner's workers can share the compiled tests (a file is
one unit of work).
"""

import csv
import json

from test_torch_compiled import K, M, N, REPO, STEP_SHAPE, port_cli

def _sweep(tmp_path, name, argv):
    path = tmp_path / f"{name}.csv"
    port_cli.main(argv + ["--device", "cpu", "--num-iterations", "2", "--num-warmups", "1",
                          "--csv", str(path)])
    with open(path) as f:
        return list(csv.DictReader(f))


def test_two_sweeps_in_one_process(tmp_path):
    """Two CLI runs back to back, each with a compiled train step: the
    first drops its compiled graphs on the way out (``runtime.shutdown``;
    at world 1 the one-rank group and its meshes stay for the process), and
    the second compiles anew on them."""
    for i, (family, shape, impl) in enumerate((
            ("tp_rowwise", (M, N, K), "xla_gspmd"),
            ("transformer_step", STEP_SHAPE, "xla_gspmd;vocab=64;n_heads=4;batch=2;"
                                             "microbatches=1;layers_per_stage=2"),
            ("transformer_step", STEP_SHAPE, "xla_gspmd;vocab=64;n_heads=8"))):
        rows = _sweep(tmp_path, f"sweep{i}", [
            "--primitive", family, "--impl", impl, "--impl", "compute_only"]
            + [a for flag, v in zip("mnk", shape) for a in (f"-{flag}", str(v))]
            + ["--dtype", "float32"])
        assert [r["base_implementation"] for r in rows] == ["compiled", "compute_only"]
        assert all(r["valid"] == "True" and not r["error"] for r in rows), rows


def test_transformer_step_config_runs_on_the_cpu(tmp_path):
    """``scripts/config_transformer_step.json``'s ``xla_gspmd`` entry as
    shipped (``latency_hiding_scheduler`` true and false) through the CLI
    at a small shape: two valid ``compiled`` rows."""
    cfg = json.loads((REPO / "scripts" / "config_transformer_step.json").read_text())["benchmark"]
    cfg.update(m=[16], n=[32], k=[64], num_iterations=1, device="cpu",
               time_measurement_backend="host_clock",  # device_loop needs the card
               implementations={"xla_gspmd": cfg["implementations"]["xla_gspmd"]},
               output_csv=str(tmp_path / "rows.csv"))
    path = tmp_path / "config_transformer_step.json"
    path.write_text(json.dumps({"benchmark": cfg}))
    rows = port_cli.run_benchmark(port_cli.load_config(str(path)))
    assert len(rows) == 2
    for row in rows:
        assert row["base_implementation"] == "compiled"
        assert row["valid"] and not row["error"], row["error"]
    assert {"latency_hiding_scheduler=True" in r["option"] for r in rows} == {True, False}
