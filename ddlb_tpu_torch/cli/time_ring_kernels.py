"""Time the ring and all-to-all kernels (K2-K6) across the cards of one
node beside their yardsticks.

    torchrun --standalone --nproc_per_node 4 -m ddlb_tpu_torch.cli.time_ring_kernels

On each rank, at m = n = k = 8192 bf16 (``-m/-n/-k`` to change), times with
CUDA events, after a barrier, the median of ``--iterations`` calls of:

- ``ring_ag_matmul``: K2 (``[m/d, k] @ [k, n] -> [m, n]``) on its peer ring;
- ``ring_matmul_rs``: K3 (``[m, k/d] @ [k/d, n] -> [m/d, n]``);
- ``ring_all_gather``: K4 (``[m/d, k] -> [m, k]``);
- ``ring_reduce_scatter``: K5 (``[m/d, k] -> [m/d^2, k]``);
- ``alltoall_expert_matmul``: K6 (``[m/d, k]`` tokens, a ``[k, n]``
  expert ``-> [m/d, n]``);
- the ``pytorch`` members' steps: NCCL all-gather then ``torch.matmul``,
  ``torch.matmul`` then NCCL reduce-scatter, NCCL's all-gather
  (``all_gather_into_tensor``) and reduce-scatter (``reduce_scatter_tensor``)
  alone, and all-to-all, ``torch.matmul``, all-to-all;
- where this torch has them, symmetric memory's fused operators
  (``torch.ops.symm_mem.fused_all_gather_matmul`` and
  ``fused_matmul_reduce_scatter``): timed only, as a library yardstick;
  the port never calls them.

Prints one JSON line on rank 0 with the slowest rank's median of each, in
milliseconds, the card's name, and the GEMM tile K2 and K6 ran on
(``tiles``: their launches by tile in this run, every one of them on the
tile named, and the blocks a launch of each ran).
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from ddlb_tpu_torch.ops import alltoall_matmul as am
from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops import ring_collectives as rc
from ddlb_tpu_torch.runtime import Runtime


def _median_ms(fn, rt: Runtime, iterations: int) -> float:
    fn()
    rt.barrier()
    times = []
    for _ in range(iterations):
        rt.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _fused_ops(rt: Runtime):
    """Symmetric memory's fused operators on the world group, or None
    where this torch lacks them."""
    ops = getattr(torch.ops, "symm_mem", None)
    if ops is None or not hasattr(ops, "fused_all_gather_matmul"):
        return None
    from torch.distributed import _symmetric_memory as symm

    name = dist.group.WORLD.group_name
    enable = getattr(symm, "enable_symm_mem_for_group", None)
    if enable is not None:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            enable(name)
    return ops, name


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-m", type=int, default=8192)
    parser.add_argument("-n", type=int, default=8192)
    parser.add_argument("-k", type=int, default=8192)
    parser.add_argument("--iterations", type=int, default=20)
    args = parser.parse_args(argv)
    rt = Runtime("cuda")
    d, r = rt.world_size, rt.rank
    m, n, k = args.m, args.n, args.k
    gen = torch.Generator(device=rt.device).manual_seed(r)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=rt.device) * 2 - 1).to(torch.bfloat16)

    a_ag, b_ag = uniform(m // d, k), uniform(k, n)
    a_rs, b_rs = uniform(m, k // d), uniform(k // d, n)
    ring_ag = cm.peer_ring(rt, "ag", a_ag.numel(), torch.bfloat16)
    ring_rs = cm.peer_ring(rt, "rs", (m // d) * n, torch.bfloat16)
    # K4/K5 move a_ag, the [m/d, k] shard; K6 routes it to the experts
    ring_k4 = rc.peer_ring(rt, "all_gather", a_ag.numel(), torch.bfloat16)
    ring_k5 = rc.peer_ring(rt, "reduce_scatter", a_ag.numel() // d, torch.bfloat16)
    bufs = am.peer_buffers(rt, m // d // d, k, n, torch.bfloat16)
    calls = {
        "ring_ag_matmul": lambda: cm.ring_ag_matmul(a_ag, b_ag, rt, ring_ag),
        "ring_matmul_rs": lambda: cm.ring_matmul_rs(a_rs, b_rs, rt, ring_rs),
        "ring_all_gather": lambda: rc.ring_all_gather(a_ag, rt, ring_k4),
        "ring_reduce_scatter": lambda: rc.ring_reduce_scatter(a_ag, rt, ring_k5),
        "alltoall_expert_matmul": lambda: am.alltoall_expert_matmul(a_ag, b_ag, rt, bufs),
        "pytorch_ag_matmul": lambda: rt.all_gather_rows(a_ag) @ b_ag,
        "pytorch_matmul_rs": lambda: rt.reduce_scatter_rows(a_rs @ b_rs),
        "nccl_all_gather": lambda: rt.all_gather_rows(a_ag),
        "nccl_reduce_scatter": lambda: rt.reduce_scatter_rows(a_ag),
        "pytorch_alltoall_matmul": lambda: rt.all_to_all_rows(rt.all_to_all_rows(a_ag) @ b_ag),
    }
    cm.reset_launches()
    am.reset_launches()
    medians = {key: _median_ms(fn, rt, args.iterations) for key, fn in calls.items()}
    tiles = {
        "ring_ag_matmul": {"tile": cm.tile_for(torch.bfloat16, k, n), "launches": dict(cm.TILES),
                           "blocks": cm.grid_blocks("ag", torch.bfloat16, k, n, 1)},
        "alltoall_expert_matmul": {"tile": am.tile_for(torch.bfloat16),
                                   "launches": dict(am.TILES),
                                   "blocks": am.grid_blocks(torch.bfloat16, 1)},
    }
    library = {}
    fused = _fused_ops(rt)
    if fused is None:
        library["unavailable"] = "torch.ops.symm_mem has no fused_all_gather_matmul"
    else:
        ops, name = fused
        try:  # a yardstick only: its failure is reported, not raised
            medians["fused_all_gather_matmul"] = _median_ms(
                lambda: ops.fused_all_gather_matmul(a_ag, [b_ag], 0, name), rt,
                args.iterations)
            medians["fused_matmul_reduce_scatter"] = _median_ms(
                lambda: ops.fused_matmul_reduce_scatter(a_rs, b_rs, "sum", 0, name), rt,
                args.iterations)
        except Exception as exc:
            library["error"] = f"{type(exc).__name__}: {exc}"[:300]
    if library:
        medians = {key: medians[key] for key in calls}
    slowest = rt.max_over_ranks(torch.tensor(list(medians.values()), dtype=torch.float64).numpy())
    if r == 0:
        print(json.dumps({
            "world": d, "m": m, "n": n, "k": k, "dtype": "bfloat16",
            "median_ms_slowest_rank": dict(zip(medians, (float(x) for x in slowest))),
            "library": library, "device": rt.device_kind, "tiles": tiles,
            "launches": {**cm.LAUNCHES, "k4": rc.LAUNCHES["ag"], "k5": rc.LAUNCHES["rs"],
                         "k6": am.LAUNCHES["a2a"]},
        }))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
