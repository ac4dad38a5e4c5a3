"""Time the learned routers' training rows across the cards of one node.

    torchrun --standalone --nproc_per_node 4 scripts/time_router_rows.py

(rehearsed on the CPU with ``python -m torch.distributed.run ... --device
cpu --shape 32 64 64 --vocab 256``).

Runs, through the port's sweep runner with validation (bf16, 2 warm-ups,
8 timed iterations, host clock with a barrier a step, the slowest rank's
median), ``scripts/config_router.json``'s first entry as shipped (the
``spmd`` member's auto mesh: (dp 1, tp 2, pp 2) on four ranks, so E = 2
experts) and the same full width on an explicit (1, 4, 1) mesh (E = 4)
with ``router=block``, ``topk`` and ``expert_choice``. Each row runs in
its own ``run_benchmark`` call with the card's peak-memory counter reset
before it. Rank 0 prints one JSON line a row: the option, ms per step,
tokens/s (batch x sequence over the median), model-FLOPs utilisation
(the row's ``flops()`` rate over the node's bf16 peak, 989 TFLOP/s a
card), the largest peak allocation over the ranks, the validity, and
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), a card
PEAK_BF16_FLOPS = 989e12
CONFIG = os.path.join("scripts", "config_router.json")


def rows(shape=None, vocab=None):
    """Each row's (shape, implementations): the config's first entry, one
    row a router, then the explicit (1, 4, 1) mesh; ``shape`` and
    ``vocab`` replace the config's for a rehearsal."""
    with open(CONFIG) as f:
        cfg = json.load(f)["benchmark"]
    shape = shape or (cfg["m"][0], cfg["n"][0], cfg["k"][0])
    entry = {key: value for key, value in cfg["implementations"][0].items() if key != "name"}
    if vocab:
        entry["vocab"] = [vocab]
    out = [(shape, dict(entry, router=[router])) for router in entry["router"]]
    explicit = dict(entry, dp=[1], tp=[4], pp=[1])
    out += [(shape, dict(explicit, router=[router]))
            for router in ("block", "topk", "expert_choice")]
    return out


def mesh_of(opts, world):
    """The (dp, tp, pp) a row ran on: its options, or the member's auto
    factors (pp 2 where the world is even, tp 2 where the rest is)."""
    dp, tp, pp = (int(opts[a]) for a in ("dp", "tp", "pp"))
    if dp and tp and pp:
        return [dp, tp, pp]
    pp = 2 if world % 2 == 0 else 1
    tp = 2 if world % (2 * pp) == 0 else 1
    return [world // (pp * tp), tp, pp]


def main() -> None:
    import argparse

    import numpy as np
    import torch

    from ddlb_tpu_torch.cli.benchmark import run_benchmark
    from ddlb_tpu_torch.runtime import Runtime, shutdown

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--shape", type=int, nargs=3, default=None, metavar=("M", "N", "K"))
    parser.add_argument("--vocab", type=int, default=None)
    args = parser.parse_args()
    cuda = args.device == "cuda"
    runtime = Runtime(args.device)
    card = "cpu"
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    try:
        for shape, spec in rows(args.shape, args.vocab):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            (row,) = run_benchmark({
                "primitive": "transformer_step", "m": shape[0], "n": shape[1],
                "k": shape[2], "dtype": "bfloat16", "validate": True,
                "num_iterations": 8, "num_warmups": 2,
                "time_measurement_backend": "host_clock",
                "barrier_at_each_iteration": True, "device": args.device,
                "output_csv": None, "implementations": {"spmd": [spec]},
            })
            mine = torch.cuda.max_memory_allocated() if cuda else 0
            peak = runtime.max_over_ranks(np.array([mine], dtype=np.float64))[0]
            ms = row["median time (ms)"]
            opts = dict(item.split("=", 1) for item in row["option"].split(";"))
            if runtime.rank == 0:
                print(json.dumps({
                    "router_row": opts["router"], "mesh": mesh_of(opts, runtime.world_size),
                    "option": row["option"], "ms_per_step": ms,
                    "tokens_per_s": int(opts["batch"]) * shape[0] / (ms / 1e3),
                    "mfu": row["Throughput (TFLOPS)"] * 1e12
                    / (PEAK_BF16_FLOPS * runtime.world_size),
                    "peak_bytes_max_rank": int(peak), "valid": row["valid"],
                    "error": row["error"], "world_size": runtime.world_size, "card": card,
                }), flush=True)
            if cuda:
                torch.cuda.empty_cache()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
