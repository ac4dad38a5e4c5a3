"""Time some ring kernels alone across the cards of one node, for one
checkout.

    torchrun --standalone --nproc_per_node 4 scripts/time_ring_alone.py \
        --tree DIR [--kernels ring_matmul_rs,ring_reduce_scatter] [--label NAME]

Builds the calls of ``ddlb_tpu_torch.cli.time_ring_kernels`` (its shapes,
m = n = k = 8192 bf16, and its operands) with the package of the
checkout at ``DIR``, and times only the ``--kernels`` named, in the order
named, with that module's timer: after a barrier, the median of
``--iterations`` CUDA-event times, the slowest rank's median reported.
``time_ring_kernels`` runs K2 first, so K3 and the others follow K2's
launches there; here they can run with nothing before them, or after K2
(``--kernels ring_ag_matmul,ring_matmul_rs``), to tell a kernel's own
time from what an earlier kernel left on the card. Rank 0 samples every
card's SM clock and power draw with ``nvidia-smi`` every quarter second
while the calls run and prints one JSON line.

To compare two commits, unpack the other one with ``git archive`` into a
directory ``.gitignore`` lists and run this script in turns, parent,
change, change, parent, in one command: one ``torchrun`` a tree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

from time_loopback import sample_clocks

KERNELS = ("ring_ag_matmul", "ring_matmul_rs", "ring_all_gather", "ring_reduce_scatter",
           "alltoall_expert_matmul")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="root of the checkout to time")
    parser.add_argument("--kernels", default="ring_matmul_rs,ring_reduce_scatter",
                        help=f"comma-separated, in the order to run, of {', '.join(KERNELS)}")
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    names = args.kernels.split(",")
    unknown = [name for name in names if name not in KERNELS]
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; choose from {KERNELS}")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import torch.distributed as dist

    import chip_smoke
    import ddlb_tpu_torch
    from ddlb_tpu_torch.cli.time_ring_kernels import _median_ms
    from ddlb_tpu_torch.ops import alltoall_matmul as am
    from ddlb_tpu_torch.ops import collective_matmul as cm
    from ddlb_tpu_torch.ops import ring_collectives as rc
    from ddlb_tpu_torch.runtime import Runtime

    if not os.path.abspath(ddlb_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {ddlb_tpu_torch.__file__}, not the checkout at {tree}")
    rt = Runtime("cuda")
    d, r = rt.world_size, rt.rank
    m = n = k = 8192
    gen = torch.Generator(device=rt.device).manual_seed(r)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=rt.device) * 2 - 1).to(torch.bfloat16)

    # time_ring_kernels' operands, drawn in its order
    a_ag, b_ag = uniform(m // d, k), uniform(k, n)
    a_rs, b_rs = uniform(m, k // d), uniform(k // d, n)

    def call(name):
        """The timed call of ``name`` on its own ring or buffers."""
        if name == "ring_ag_matmul":
            ring = cm.peer_ring(rt, "ag", a_ag.numel(), torch.bfloat16)
            return lambda: cm.ring_ag_matmul(a_ag, b_ag, rt, ring)
        if name == "ring_matmul_rs":
            ring = cm.peer_ring(rt, "rs", (m // d) * n, torch.bfloat16)
            return lambda: cm.ring_matmul_rs(a_rs, b_rs, rt, ring)
        if name == "ring_all_gather":
            ring = rc.peer_ring(rt, "all_gather", a_ag.numel(), torch.bfloat16)
            return lambda: rc.ring_all_gather(a_ag, rt, ring)
        if name == "ring_reduce_scatter":
            ring = rc.peer_ring(rt, "reduce_scatter", a_ag.numel() // d, torch.bfloat16)
            return lambda: rc.ring_reduce_scatter(a_ag, rt, ring)
        bufs = am.peer_buffers(rt, m // d // d, k, n, torch.bfloat16)
        return lambda: am.alltoall_expert_matmul(a_ag, b_ag, rt, bufs)

    calls = {name: call(name) for name in names}
    card = chip_smoke.card_identity() if r == 0 else None
    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_clocks, args=(samples, stop), daemon=True)
    if r == 0:
        sampler.start()
    try:
        medians = {name: _median_ms(fn, rt, args.iterations) for name, fn in calls.items()}
    finally:
        stop.set()
        if r == 0:
            sampler.join()
    slowest = rt.max_over_ranks(torch.tensor(list(medians.values()), dtype=torch.float64).numpy())
    if r == 0:
        print(json.dumps({
            "label": args.label or tree, "world": d, "m": m, "n": n, "k": k,
            "dtype": "bfloat16", "card": card, "order": names,
            "median_ms_slowest_rank": dict(zip(medians, (float(x) for x in slowest))),
            "sm_mhz_min_max": [min(c for c, _ in samples), max(c for c, _ in samples)]
            if samples else None,
            "power_w_max": max(w for _, w in samples) if samples else None,
        }))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
