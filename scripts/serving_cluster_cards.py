"""The serving cluster's rows on one node of four cards, each rank's
kernel launches held to its own engines.

Run from the repository root:

    torchrun --standalone --nproc_per_node 4 scripts/serving_cluster_cards.py

(rehearse on the CPU with ``--device cpu``: four gloo ranks, the same
rows at a small width, and no launch check, since a CPU tensor takes the
kernels' plain versions). ``scripts/config_serving_load.json``'s entries
as written launch no kernel; run them through the CLI:

    torchrun --standalone --nproc_per_node 4 -m ddlb_tpu_torch.cli.benchmark \
        --config scripts/config_serving_load.json

One row at a time through the port's sweep runner, at ``chip_smoke.py``'s
serving width (d_model 2048, d_ff 8192, 16 heads, vocab 16384, batch 8,
m = 512, a paged pool of half size, a 256-token shared prefix, 48
requests, flash admissions and pallas ticks) at 20 and 400 requests/s:
``router`` dp 2 (two cards an engine) and dp 4 (one card an engine, a
full pool),
``disagg`` p1+d1 (two cards an engine), and the ``engine`` and ``static``
members beside them (one engine over the four cards). Around each row
every rank reads its own launch counts and holds them to its own engines:
K8a once a layer per prompt prefill (each engine's shared prefix, and the
row's ``drain_prefills`` and ``prewarm_prefills``) and K12 once a layer
per decode tick (``drain_ticks``, ``prewarm_ticks``), the counts being
those of the engines the rank runs (``local_engines``). It also times the
cluster's exchanges (``EnginePlacement.share``) and the drain clock's
readings (``Runtime.broadcast_host``) in the drains, and at the end both
alone with every rank ready.

Each rank writes one JSON line a row to ``OUT/rank{r}.jsonl`` (default
``results/serving_cluster_cards``); rank 0 prints the card's name and
power limit, then its lines. Exits 1 on a rank whose row is not valid or
whose launches are off.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the rows at the serving width (``chip_smoke.py``'s serving_load rows)
RATES = [20.0, 400.0]
SERVE = {"batch": 8, "vocab": 16384, "n_heads": 16, "n_requests": 48, "out_mean": 32,
         "out_max": 64, "cache_layout": "paged", "page_size": 128, "page_pool_frac": 0.5,
         "prefix_pop": 4, "prefix_len": 256, "decode_kernel": "pallas",
         "attn_kernel": "flash"}
SERVE_SHAPE = (512, 2048, 8192)
#: the same rows at the CPU rehearsal's width
SMALL = {"batch": 8, "vocab": 128, "n_heads": 4, "n_requests": 12, "out_mean": 4,
         "out_max": 8, "cache_layout": "paged", "page_size": 16, "page_pool_frac": 0.5,
         "prefix_pop": 4, "prefix_len": 16}
SMALL_SHAPE = (16, 64, 128)
#: the exchange and clock timed alone: calls a rank
ALONE_CALLS = 200


def rows_at(common):
    """The rows at a width. ``router`` dp 4 takes the full pool: half the
    pool of an engine of two slots is one slot's worst case, which the
    shared prefix's pinned pages leave no room for (``check_fits``)."""
    return {
        "router": [{"rate": RATES, "dp": 2, **common},
                   {"rate": RATES, "dp": 4, **common, "page_pool_frac": 1.0}],
        "disagg": [{"rate": RATES, "prefill_shards": 1, "decode_shards": 1, **common}],
        "engine": [{"rate": RATES, **common}],
        "static": [{"rate": RATES, **common}],
    }


def card_identity():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


class Timers:
    """Seconds and calls of the exchange and the clock, and the pumps."""

    def __init__(self):
        from ddlb_tpu_torch.runtime import Runtime
        from ddlb_tpu_torch.serve.cluster import ServingCluster
        from ddlb_tpu_torch.serve.placement import EnginePlacement

        self.reset()
        for cls, name, key in ((EnginePlacement, "share", "exchange"),
                               (Runtime, "broadcast_host", "clock"),
                               (ServingCluster, "pump", "pump")):
            setattr(cls, name, self._timed(getattr(cls, name), key))

    def reset(self):
        self.calls = {"exchange": 0, "clock": 0, "pump": 0}
        self.seconds = {"exchange": 0.0, "clock": 0.0, "pump": 0.0}

    def _timed(self, fn, key):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.calls[key] += 1
                self.seconds[key] += time.perf_counter() - t0
        return timed

    def summary(self):
        c, s = self.calls, self.seconds
        return {"pumps": c["pump"], "exchanges": c["exchange"], "clock_reads": c["clock"],
                "exchange_ms": round(1e3 * s["exchange"], 3),
                "exchange_us_per_pump": round(1e6 * s["exchange"] / max(c["pump"], 1), 1),
                "clock_us_per_read": round(1e6 * s["clock"] / max(c["clock"], 1), 1),
                "pump_ms_mean": round(1e3 * s["pump"] / max(c["pump"], 1), 4)}


def expected_launches(row, got):
    """K8a (``tri``) and K12 (``paged``; K11, ``decode``, on a contiguous
    cache) of this rank's engines in the row; every other count 0."""
    opts = dict(item.split("=", 1) for item in row["option"].split(";") if "=" in item)
    layers = int(opts["layers"])
    engines = int(row.get("local_engines", 1))
    want = {k: 0 for k in got}
    if opts["attn_kernel"] == "flash":
        want["tri"] = layers * (engines * int(opts["prefix_pop"] != "0")
                                + row["drain_prefills"] + row.get("prewarm_prefills", 0))
    if opts["decode_kernel"] == "pallas":
        key = "paged" if opts["cache_layout"] == "paged" else "decode"
        want[key] = layers * (row["drain_ticks"] + row.get("prewarm_ticks", 0))
    return want


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", default=os.path.join("results", "serving_cluster_cards"))
    args = parser.parse_args(argv)
    import numpy as np

    from ddlb_tpu_torch.cli.benchmark import (
        assign_impl_ids,
        generate_config_combinations,
        run_benchmark,
    )
    from ddlb_tpu_torch.ops import decode_attention as da
    from ddlb_tpu_torch.ops import flash_attention as fa
    from ddlb_tpu_torch.runtime import Runtime, env_rank, shutdown

    rank = env_rank()
    card = card_identity() if args.device == "cuda" else "cpu"
    on_card = args.device == "cuda"
    if on_card:
        from ddlb_tpu_torch.ops import _build

        _build.build("flash_attention", "decode_attention")
    os.makedirs(args.out, exist_ok=True)
    out = open(os.path.join(args.out, f"rank{rank}.jsonl"), "w")
    timers = Timers()
    shape = SERVE_SHAPE if on_card else SMALL_SHAPE
    dtype = "bfloat16" if on_card else "float32"
    impls = rows_at(SERVE if on_card else SMALL)
    if rank == 0:
        print(card)
    failures = []
    for spec in assign_impl_ids(generate_config_combinations(impls)).values():
        name = spec.pop("implementation")
        before = {**fa.LAUNCHES, **da.LAUNCHES}
        timers.reset()
        t0 = time.perf_counter()
        (row,) = run_benchmark({
            "primitive": "serving_load", "m": shape[0], "n": shape[1], "k": shape[2],
            "dtype": dtype, "validate": True, "num_iterations": 1,
            "num_warmups": 1, "time_measurement_backend": "host_clock",
            "barrier_at_each_iteration": True, "device": args.device,
            "output_csv": os.path.join(args.out, f"rows_rank{rank}.csv"),
            "implementations": {name: [spec]},
        })
        after = {**fa.LAUNCHES, **da.LAUNCHES}
        got = {k: after[k] - before[k] for k in after}
        want = expected_launches(row, got) if on_card else got
        ok = bool(row["valid"]) and not row["error"] and got == want
        line = {"rank": rank, "member": name, "shape": list(shape), "option": row["option"],
                "valid": row["valid"], "error": row["error"],
                "median_ms": row["median time (ms)"],
                "seconds": round(time.perf_counter() - t0, 1), "launches": got,
                "expected": want, "ok": ok, "card": card, **timers.summary(),
                **{k: v for k, v in row.items()
                   if k.startswith(("slo_", "serve_")) or k in (
                       "drains", "drain_ticks", "drain_prefills", "prewarm_ticks",
                       "prewarm_prefills", "local_engines")}}
        out.write(json.dumps(line) + "\n")
        out.flush()
        if rank == 0:
            print(json.dumps(line))
        if not ok:
            failures.append(f"{name} {row['option']}: valid={row['valid']} "
                            f"error={row['error']!r} launches {got} expected {want}")
    # the exchange and the clock alone, every rank ready: a pump's report
    # of one engine (a view, its admissions, its tick and two completions)
    rt = Runtime(args.device)
    report = {rank: ((1200, 3, tuple(range(13))), [1, 2, 3, 4], 0.0025,
                     [(5, np.arange(32, dtype=np.int32), "max_new")] * 2)}
    alone = {}
    for key, call in (("exchange", lambda: rt.gather_objects(report)),
                      ("clock", lambda: rt.broadcast_host(1.0, 0))):
        rt.gather_objects(None)
        t0 = time.perf_counter()
        for _ in range(ALONE_CALLS):
            call()
        alone[f"{key}_us_alone"] = round(1e6 * (time.perf_counter() - t0) / ALONE_CALLS, 1)
    line = {"rank": rank, "world": rt.world_size, "calls": ALONE_CALLS, **alone, "card": card}
    out.write(json.dumps(line) + "\n")
    out.close()
    print(json.dumps(line))
    shutdown()
    if failures:
        print(f"serving_cluster_cards: rank {rank} FAILED:\n" + "\n".join(failures),
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
