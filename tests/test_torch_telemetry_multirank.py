"""The cross-rank skew fold on a 2-rank gloo world.

One world for the file, spawned with a deadline. Both ranks trace to one
directory and run two ``tp_columnwise`` ``pytorch`` rows through the
sweep runner, per-iteration barriers on: a clean row, then a row in which
rank 1 sleeps ``DELAY_S`` before each barrier (a hook on
``Runtime.barrier`` set in the child, not in the package). The delayed
row must name rank 1 the straggler and carry at least 0.8 of the injected
seconds in ``skew_enter_s``, with a finite clock bound; the clean row's
waits must stay under half its collective time; every rank's row carries
the same skew columns; both ranks write shards, and rank 0's merge holds
both.
"""

import json
import math
import multiprocessing as mp
import os
import queue
import socket
import traceback

WORLD = 2
#: rank 1's sleep before each barrier of the delayed row, seconds
DELAY_S = 0.03
ITERATIONS = 10
#: seconds the world may take; the test fails when it runs out
DEADLINE_S = 180
SKEW_KEYS = ("skew_enter_s", "skew_exit_s", "straggler_rank", "straggler_frac",
             "clock_unc_s")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, tmp, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      DDLB_TPU_TRACE=os.path.join(tmp, "trace"))
    import time

    import torch
    import torch.distributed as dist

    # one intra-op thread a rank: the tiny GEMMs gain nothing from more, and
    # a rank's spare threads would compete with its peer for the cores
    torch.set_num_threads(1)

    from ddlb_tpu_torch.cli.benchmark import run_benchmark
    from ddlb_tpu_torch.runtime import Runtime

    def config(name):
        return {"primitive": "tp_columnwise", "m": 64, "n": 32, "k": 32,
                "dtype": "float32", "num_iterations": ITERATIONS, "num_warmups": 1,
                "time_measurement_backend": "host_clock",
                "barrier_at_each_iteration": True, "device": "cpu",
                "output_csv": os.path.join(tmp, f"{name}_rank{rank}.csv"),
                "implementations": {"pytorch": [{}]}}

    try:
        (clean,) = run_benchmark(config("clean"))
        barrier = Runtime.barrier

        def late_barrier(self):
            if self.rank == 1:
                time.sleep(DELAY_S)
            barrier(self)

        Runtime.barrier = late_barrier
        (late,) = run_benchmark(config("late"))
        Runtime.barrier = barrier
        keep = ("valid", "error", "world_size", "barrier_wait_s") + SKEW_KEYS
        results.put((rank, "ok", [{k: row[k] for k in keep} for row in (clean, late)]))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_rank_skew_fold_names_the_late_rank(tmp_path):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(tmp_path), results),
                         daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, status, payload = results.get(timeout=DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {WORLD}-rank world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank in range(WORLD):
        for row in got[rank]:
            assert row["valid"] and not row["error"] and row["world_size"] == WORLD, row
    # every rank folds the same gathered stamps into the same columns
    skew = {r: [{k: row[k] for k in SKEW_KEYS} for row in got[r]] for r in got}
    assert json.dumps(skew[0]) == json.dumps(skew[1])
    clean, late = got[0]
    for row in (clean, late):
        assert math.isfinite(row["clock_unc_s"]) and row["clock_unc_s"] >= 0.0, row
        assert row["straggler_rank"] in (-1, 0, 1)
    assert clean["straggler_frac"] < 0.5, clean
    assert late["straggler_rank"] == 1, late
    assert late["skew_enter_s"] >= 0.8 * DELAY_S * ITERATIONS, late
    assert late["straggler_frac"] > 0.5, late
    # rank 0 waited at every barrier of the late row
    assert got[0][1]["barrier_wait_s"] >= 0.8 * DELAY_S * ITERATIONS

    from ddlb_tpu import telemetry as jax_telemetry

    trace = tmp_path / "trace"
    shards = sorted(p.name for p in trace.glob("trace-*.jsonl"))
    assert [s.split("-")[-2] for s in shards] == ["p0", "p1"], shards
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert {e["args"]["rank"] for e in events if e.get("ph") == "X"} == {0, 1}
    # the shards as the JAX package reads them hold every merged event (a
    # rank's last barrier instant may land after rank 0 merged)
    shard_events = jax_telemetry.read_events(str(trace))
    keys = {(e["pid"], e.get("seq")) for e in shard_events}
    assert all((e["pid"], e.get("seq")) in keys for e in events)
    rows = [e for e in events if e.get("name") == "worker.row"]
    assert sorted(e["args"]["rank"] for e in rows) == [0, 0, 1, 1]
    folds = [e for e in events if e.get("name") == "skew.fold"]
    assert len(folds) == 2 * WORLD
