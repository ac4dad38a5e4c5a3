"""The cross-rank skew fold and the world's trace on one node of four cards.

Run from the repository root:

    torchrun --standalone --nproc_per_node 4 scripts/telemetry_cards.py

(rehearse on the CPU with ``--device cpu``: four gloo ranks, the same rows
at a small shape in float32).

Two runs of the same rows through the port's sweep runner, each with
``DDLB_TPU_TRACE`` set to a directory of its own under ``OUT`` (default
``results/telemetry_cards``): ``tp_columnwise`` ``pytorch`` and ``cuda``
(NCCL's all-gather and K1) at 4096^3 bf16, on the host clock with a
barrier before each of ``ITERATIONS`` timed calls. The first run is clean;
in the second, rank ``LATE_RANK`` sleeps ``DELAY_S`` before every barrier
(a hook this script sets on ``Runtime.barrier``; the package has none).
The checks, each run:

- four trace shards, merged by rank 0 into one ``trace.json`` that holds
  every rank's events;
- every rank's row carries the same skew columns (one gather of them);
- ``straggler_rank`` is -1 or a rank of the world, ``clock_unc_s`` finite
  and, the ranks on one node, below 1 ms;
- the second run names ``LATE_RANK`` the straggler of both rows, with
  ``skew_enter_s`` at least 0.8 of ``DELAY_S`` times the row's barriers.

Each rank writes one JSON line a row to ``OUT/rank{r}.jsonl``; rank 0
prints the card's name and power limit, then every rank's lines. Exits 1
when a check fails on a rank.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the rows' shape on the card and in the CPU rehearsal
CARD_MNK, SMALL_MNK = 4096, 64
ITERATIONS, WARMUPS = 10, 3
#: the rank that arrives late at every barrier of the second run, and by how much
LATE_RANK, DELAY_S = 2, 0.02
#: the bound on clock_unc_s when the ranks share one node's clock
ONE_NODE_UNC_S = 1e-3
SKEW_KEYS = ("skew_enter_s", "skew_exit_s", "straggler_rank", "straggler_frac",
             "clock_unc_s")


def card_identity():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def check_run(label, rows, gathered, trace_dir, world, late):
    """The failures of one run, as rank 0 sees them: ``gathered`` is every
    rank's skew columns of each row, ``trace_dir`` the run's traces."""
    failures = []
    for i, row in enumerate(rows):
        name = f"{label} {row['implementation']}"
        if not (row["valid"] and not row["error"] and row["world_size"] == world):
            failures.append(f"{name}: valid={row['valid']} error={row['error']!r}")
        mine = {k: row[k] for k in SKEW_KEYS}
        if any(repr(g[i]) != repr(mine) for g in gathered):
            failures.append(f"{name}: the ranks' skew columns differ: {gathered}")
        if row["straggler_rank"] not in range(-1, world):
            failures.append(f"{name}: straggler_rank {row['straggler_rank']}")
        if not (math.isfinite(row["clock_unc_s"]) and row["clock_unc_s"] < ONE_NODE_UNC_S):
            failures.append(f"{name}: clock_unc_s {row['clock_unc_s']}")
        if late and not (row["straggler_rank"] == LATE_RANK
                         and row["skew_enter_s"] >= 0.8 * DELAY_S * ITERATIONS):
            failures.append(f"{name}: rank {LATE_RANK} late by {DELAY_S} s at "
                            f"{ITERATIONS} barriers gave {mine}")
    shards = sorted(f for f in os.listdir(trace_dir) if f.startswith("trace-"))
    if sorted(f.split("-")[-2] for f in shards) != [f"p{r}" for r in range(world)]:
        failures.append(f"{label}: trace shards {shards}")
    merged = os.path.join(trace_dir, "trace.json")
    if not os.path.isfile(merged):
        failures.append(f"{label}: rank 0 merged no trace.json")
    else:
        with open(merged) as f:
            events = json.load(f)["traceEvents"]
        ranks = {e["args"]["rank"] for e in events
                 if e.get("ph") == "X" and e["name"] == "worker.row"}
        if ranks != set(range(world)):
            failures.append(f"{label}: trace.json holds worker.row spans of ranks {ranks}")
    return failures


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", default=os.path.join("results", "telemetry_cards"))
    args = parser.parse_args(argv)

    from ddlb_tpu_torch.cli.benchmark import run_benchmark
    from ddlb_tpu_torch.runtime import Runtime, env_rank, shutdown

    rank = env_rank()
    on_card = args.device == "cuda"
    if on_card:
        from ddlb_tpu_torch.ops import _build

        _build.build("matmul")
    card = card_identity() if on_card else "cpu"
    mnk = CARD_MNK if on_card else SMALL_MNK
    os.makedirs(args.out, exist_ok=True)
    out = open(os.path.join(args.out, f"rank{rank}.jsonl"), "w")
    barrier = Runtime.barrier

    def late_barrier(self):
        if self.rank == LATE_RANK:
            time.sleep(DELAY_S)
        barrier(self)

    failures, lines = [], []
    for label, late in (("clean", False), ("late", True)):
        trace_dir = os.path.abspath(os.path.join(args.out, f"trace_{label}"))
        os.environ["DDLB_TPU_TRACE"] = trace_dir
        Runtime.barrier = late_barrier if late else barrier
        t0 = time.perf_counter()
        try:
            rows = run_benchmark({
                "primitive": "tp_columnwise", "m": mnk, "n": mnk, "k": mnk,
                "dtype": "bfloat16" if on_card else "float32", "validate": True,
                "num_iterations": ITERATIONS, "num_warmups": WARMUPS,
                "time_measurement_backend": "host_clock",
                "barrier_at_each_iteration": True, "device": args.device,
                "output_csv": os.path.join(args.out, f"{label}.csv"),
                "implementations": {"pytorch": [{}], "cuda": [{}]},
            })
        finally:
            Runtime.barrier = barrier
        seconds = time.perf_counter() - t0
        rt = Runtime(args.device)
        gathered = rt.gather_objects([{k: row[k] for k in SKEW_KEYS} for row in rows])
        if rank == 0:
            failures += check_run(label, rows, gathered, trace_dir, rt.world_size, late)
        for row in rows:
            line = {"run": label, "rank": rank, "world": rt.world_size,
                    "implementation": row["implementation"], "option": row["option"],
                    "shape": [mnk] * 3, "median_ms": row["median time (ms)"],
                    "barrier_wait_s": row["barrier_wait_s"],
                    "hbm_high_water_bytes": row["hbm_high_water_bytes"],
                    "collective_bytes": row["collective_bytes"],
                    **{k: row[k] for k in SKEW_KEYS}, "run_s": round(seconds, 2),
                    "delay_s": DELAY_S if late else 0.0, "late_rank": LATE_RANK if late else -1,
                    "barriers": ITERATIONS, "card": card}
            out.write(json.dumps(line) + "\n")
            lines.append(line)
    out.close()
    rt = Runtime(args.device)
    everyone = rt.gather_objects(lines)
    verdicts = rt.gather_objects(failures)
    if rank == 0:
        print(card)
        for per_rank in everyone:
            for line in per_rank:
                print(json.dumps(line))
    shutdown()
    if rank == 0 and verdicts[0]:
        print("telemetry_cards: FAILED:\n" + "\n".join(verdicts[0]), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
