"""The serving cluster's per-pump exchange and the drain clock's reading,
timed alone on one node, over each channel they could take.

Run from the repository root on four cards:

    torchrun --standalone --nproc_per_node 4 scripts/time_host_exchange.py

(``--device cpu`` rehearses it on gloo ranks, without the NCCL rows).

With every rank ready, ``CALLS`` times each (after ``WARMUP`` calls):
``Runtime.gather_objects`` of a pump's report (an engine's view,
admissions, tick and two completions) and ``Runtime.broadcast_host`` of a
float, as the port runs them (on the card over an NCCL group and a CUDA
stream of their own, on the CPU over gloo); the same all-gather of a 2 KiB host buffer
and broadcast of a float64 over a gloo group on the loopback device and
over a gloo group on the interface the host name resolves to; and, on
the card, an all-gather of a 2 KiB card buffer and a broadcast of a
float64 card scalar over the default NCCL group on the current stream,
each read back to the host (a sync of the card included). Prints one JSON line a
rank of mean microseconds a call, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CALLS, WARMUP = 500, 50
BUF_BYTES = 2048


def card_identity():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def mean_us(call):
    for _ in range(WARMUP):
        call()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    return round(1e6 * (time.perf_counter() - t0) / CALLS, 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from ddlb_tpu_torch.runtime import Runtime, shutdown

    rt = Runtime(args.device)
    rank, world = rt.rank, rt.world_size
    report = {rank: ((1200, 3, tuple(range(13))), [1, 2, 3, 4], 0.0025,
                     [(5, np.arange(32, dtype=np.int32), "max_new")] * 2)}
    rows = {"port_gather_objects": mean_us(lambda: rt.gather_objects(report)),
            "port_broadcast_host": mean_us(lambda: rt.broadcast_host(1.0, 0)),
            "gloo_socket_ifname": os.environ.get("GLOO_SOCKET_IFNAME")}
    # a gloo group a device: created on every rank in one order
    groups = {}
    saved = os.environ.pop("GLOO_SOCKET_IFNAME", None)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    groups["gloo_lo"] = dist.new_group(backend="gloo")
    del os.environ["GLOO_SOCKET_IFNAME"]
    groups["gloo_hostname"] = dist.new_group(backend="gloo")
    if saved is not None:
        os.environ["GLOO_SOCKET_IFNAME"] = saved
    host = torch.zeros(BUF_BYTES, dtype=torch.uint8)
    host_out = torch.empty(world * BUF_BYTES, dtype=torch.uint8)
    scalar = torch.zeros(1, dtype=torch.float64)
    for name, group in groups.items():
        rows[f"{name}_all_gather"] = mean_us(
            lambda: dist.all_gather_into_tensor(host_out, host, group=group))
        rows[f"{name}_broadcast"] = mean_us(lambda: dist.broadcast(scalar, 0, group=group))
    if args.device == "cuda":
        card = torch.zeros(BUF_BYTES, dtype=torch.uint8, device=rt.device)
        card_out = torch.empty(world * BUF_BYTES, dtype=torch.uint8, device=rt.device)
        card_scalar = torch.zeros(1, dtype=torch.float64, device=rt.device)

        def nccl_gather():
            card.copy_(host)
            dist.all_gather_into_tensor(card_out, card)
            return card_out.cpu()

        def nccl_broadcast():
            dist.broadcast(card_scalar, 0)
            return card_scalar.item()

        rows["nccl_all_gather_to_host"] = mean_us(nccl_gather)
        rows["nccl_broadcast_to_host"] = mean_us(nccl_broadcast)
    print(json.dumps({"rank": rank, "world": world, "calls": CALLS, "us_per_call": rows,
                      "card": card_identity() if args.device == "cuda" else "cpu"}))
    shutdown()


if __name__ == "__main__":
    main()
