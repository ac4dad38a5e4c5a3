"""The cost model's comm term on one node of four cards.

Run from the repository root:

    torchrun --standalone --nproc_per_node 4 scripts/perfmodel_cards.py

(rehearse on the CPU with ``--device cpu``: four gloo ranks, the same rows
at a small shape in float32, priced against the ``cpu`` entry).

At one rank every row's wire is zero, so only a world of several ranks
prices the comm term. Through the port's sweep runner, with validation:
``tp_columnwise`` and ``tp_rowwise`` ``pytorch`` and ``cuda`` at 8192^3
bf16; ``collectives`` ``pytorch`` ``all_gather``, ``reduce_scatter`` and
``all_reduce`` at ``scripts/config_collectives.json``'s shapes (m = 8192
and 65536, n = 8, k = 8192); and one ``transport=dcn`` row
(``tp_columnwise`` ``pytorch``), which on one node the model prices at the
link inside the node. Rank 0 prints the card's name and power limit, then
each row's prediction, median, unclamped ratio, bound and chip and a
summary a family (``chip_smoke.check_predictions``), and fails as
``chip_smoke.py``'s perfmodel phase does: on a row priced against
another spec, a non-finite or non-positive prediction, a
``roofline_frac`` outside (0, 1] or a compute- or comm-bound ratio over
1.05. Every rank writes its rows to ``OUT/rank{r}.jsonl`` (default
``results/perfmodel_cards``).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the checks, from the repository root)

#: the GEMM rows' shape on the card and in the CPU rehearsal
CARD_MNK, SMALL_MNK = 8192, 64
#: config_collectives.json's shapes on the card, and the rehearsal's
CARD_COLLECTIVES = ([8192, 65536], [8], [8192])
SMALL_COLLECTIVES = ([64, 128], [8], [64])
ITERATIONS, WARMUPS = 10, 3


def sweeps(on_card):
    """(primitive, m, n, k, implementations) of every sweep."""
    mnk = CARD_MNK if on_card else SMALL_MNK
    m, n, k = CARD_COLLECTIVES if on_card else SMALL_COLLECTIVES
    return [
        ("tp_columnwise", mnk, mnk, mnk,
         {"pytorch": [{}, {"transport": "dcn"}], "cuda": [{}]}),
        ("tp_rowwise", mnk, mnk, mnk, {"pytorch": [{}], "cuda": [{}]}),
        ("collectives", m, n, k,
         {"pytorch": [{"op": ["all_gather", "reduce_scatter", "all_reduce"]}]}),
    ]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", default=os.path.join("results", "perfmodel_cards"))
    args = parser.parse_args(argv)

    from ddlb_tpu_torch.cli.benchmark import run_benchmark
    from ddlb_tpu_torch.runtime import Runtime, env_rank, shutdown

    rank = env_rank()
    on_card = args.device == "cuda"
    if on_card:
        from ddlb_tpu_torch.ops import _build

        _build.build("matmul")
    card = chip_smoke.card_identity() if on_card else "cpu"
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for primitive, m, n, k, implementations in sweeps(on_card):
        rows += run_benchmark({
            "primitive": primitive, "m": m, "n": n, "k": k,
            "dtype": "bfloat16" if on_card else "float32", "validate": True,
            "num_iterations": ITERATIONS, "num_warmups": WARMUPS,
            "time_measurement_backend": "host_clock", "barrier_at_each_iteration": True,
            "device": args.device,
            "output_csv": os.path.join(args.out, f"{primitive}.csv"),
            "implementations": implementations,
        })
    with open(os.path.join(args.out, f"rank{rank}.jsonl"), "w") as out:
        for row in rows:
            out.write(json.dumps(row, default=str) + "\n")
    failures = [f"{r['primitive']} {r['implementation']} {r['option']}: "
                f"valid={r['valid']} error={r['error']!r}"
                for r in rows if not (r["valid"] and not r["error"])]
    world = Runtime(args.device).world_size
    if rank == 0:
        print(card)
        wrong, _ = chip_smoke.check_predictions(rows, "h100-sxm" if on_card else "cpu")
        failures += wrong
        if world < 2:
            failures.append(f"world {world}: the comm term needs several ranks")
    shutdown()
    if rank == 0 and failures:
        print("perfmodel_cards: FAILED:\n" + "\n".join(failures), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
