#!/usr/bin/env python3
"""The topology compositions and the transport axis through the port's
sweep runner, on every rank of a ``torchrun`` world.

Runs ``ddlb_tpu_torch.cli.benchmark``'s ``run_benchmark`` on
``scripts/config_collectives.json``, ``config_dp_allreduce.json``,
``config_ep_alltoall.json`` and ``config_transport_sweep.json``, first on
the world as the launcher lays it out, then again with
``DDLB_TPU_SIM_SLICES=2`` (two simulated nodes; the runtime reads the knob
at every member's construction, so one process runs both passes). Rank 0
prints the card (``nvidia-smi`` name and power limit, first and last; also
in ``chiprun_out/topology/card.txt``), one JSON line a row (member,
options, composition, median ms, throughput, validity) and each pass's
CSV under ``chiprun_out/topology/``.

It keeps, of the three configs, the flat baseline (``jax_spmd``, the
port's ``pytorch``) and the composed entries (``jax_spmd_hier``,
``jax_spmd_striped``), and every entry of the transport sweep. It adds the
hand-kernel members that walk their own ring (``RING_KERNELS``) under both
transports: ``cuda`` collectives (K4, K5), ``dp_allreduce`` and
``ep_alltoall`` (``ring_rdma``: K4/K5; ``a2a_rdma``: K6), and
``cuda;algorithm=ring_rdma`` of both tp families (K2, K3), so with two
simulated nodes their peer tables are in the ``dcn`` order across cards.
``--iterations`` overrides the configs' counts, ``--shape-cap`` caps the
sizes.

    torchrun --standalone --nproc_per_node 4 scripts/topology_sweeps.py
    torchrun ... scripts/topology_sweeps.py --device cpu --shape-cap 64  # gloo rehearsal
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CONFIGS = ("config_collectives.json", "config_dp_allreduce.json",
           "config_ep_alltoall.json", "config_transport_sweep.json")
MEMBERS = ("jax_spmd", "jax_spmd_hier", "jax_spmd_striped")
BOTH = {"transport": ["ici", "dcn"]}
#: the ring-walking kernel members added to each config, under both transports
RING_KERNELS = {
    "config_collectives.json": [
        {"name": "pallas", "op": ["all_gather", "reduce_scatter", "all_reduce"], **BOTH}],
    "config_dp_allreduce.json": [{"name": "pallas", "algorithm": "ring_rdma", **BOTH}],
    "config_ep_alltoall.json": [{"name": "pallas", "algorithm": "a2a_rdma", **BOTH}],
    "config_transport_sweep.json": [{"name": "pallas", "algorithm": "ring_rdma", **BOTH}],
}
OUT = os.path.join("chiprun_out", "topology")


def load(config, cap):
    """The config's benchmark block, its entries cut to ``MEMBERS`` and
    ``RING_KERNELS``, and its sizes to at most ``cap`` (None: as shipped)."""
    with open(os.path.join(HERE, config)) as f:
        cfg = json.load(f)["benchmark"]
    impls = cfg["implementations"]
    if isinstance(impls, dict):  # {name: [blocks]}
        impls = [{"name": name, **block} for name, blocks in impls.items() for block in blocks]
    if config != "config_transport_sweep.json":
        impls = [block for block in impls if block["name"] in MEMBERS]
    cfg["implementations"] = impls + RING_KERNELS[config]
    if cap:
        for key in ("m", "n", "k"):
            cfg[key] = sorted({min(v, cap) for v in cfg[key]})
    return cfg


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--iterations", type=int)
    parser.add_argument("--shape-cap", type=int, help="cap m, n and k (a CPU rehearsal)")
    args = parser.parse_args()

    from ddlb_tpu_torch.cli.benchmark import run_benchmark
    from ddlb_tpu_torch.runtime import env_rank, shutdown

    rank0 = env_rank() == 0
    os.makedirs(OUT, exist_ok=True)
    card = ""
    if rank0 and args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        with open(os.path.join(OUT, "card.txt"), "w") as f:
            f.write(card + "\n")
        print(card, flush=True)
    for slices in ("", "2"):
        os.environ["DDLB_TPU_SIM_SLICES"] = slices
        tag = f"sim_slices={slices or 'unset'}"
        for config in CONFIGS:
            cfg = load(config, args.shape_cap)
            if args.iterations:
                cfg["num_iterations"] = args.iterations
            if args.device == "cpu":
                cfg["time_measurement_backend"] = "host_clock"
            cfg.update(device=args.device, output_csv=os.path.join(
                OUT, f"{config[:-5]}_{slices or 'unset'}.csv"))
            primitives = [cfg["primitive"]]
            if config == "config_transport_sweep.json":
                primitives.append("tp_rowwise")
            for primitive in primitives:
                run_cfg = dict(cfg, primitive=primitive)
                if primitive == "tp_rowwise":
                    run_cfg["implementations"] = [b for b in cfg["implementations"]
                                                  if b["name"] == "pallas"]
                    run_cfg["output_csv"] = cfg["output_csv"].replace(".csv", "_rowwise.csv")
                rows = run_benchmark(run_cfg)
                if rank0:
                    for row in rows:
                        print(json.dumps({"pass": tag, **{key: row.get(key) for key in (
                            "primitive", "implementation", "option", "m", "n", "k",
                            "composition", "median time (ms)", "Throughput (TFLOPS)",
                            "unit", "world_size", "valid", "error")}}), flush=True)
    if card:
        print(card, flush=True)  # again, where the end of the output shows it
    shutdown()


if __name__ == "__main__":
    main()
