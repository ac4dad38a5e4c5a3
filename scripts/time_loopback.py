"""Time the ring kernels (K2-K6) in loopback on one card, for one checkout.

    python scripts/time_loopback.py --tree DIR [--label NAME]

Runs ``chip_smoke.py``'s two loopback phases of the checkout at ``DIR``
(``kernel_phase_ring``: K2 and K3; ``kernel_phase_trio``: K4, K5 and K6),
with that checkout's own package and kernels (built into
``DIR/build/ddlb_tpu_torch``), and prints one JSON line: the card's name
and power limit and each kernel's entry (ms, plain ms, library ms, bound,
max |err|), with the card's SM clock and power draw sampled by
``nvidia-smi`` every quarter second while the phases run (a card at its
power limit lowers its clock). Each phase checks its loopback cases
against the plain versions first and fails as ``chip_smoke.py`` does.

To compare two commits on one card, unpack the other one with ``git
archive`` into a directory ``.gitignore`` lists and run this script in
turns, parent, change, change, parent, in one command: one process a
tree, since each process imports one checkout's package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path


def ptxas_usage(log: str) -> dict:
    """``_build.ptxas_usage`` of the checkout that holds this script, loaded
    by path: it reads the build log of any checkout, the parent's too,
    while the package imported is the tree's."""
    source = Path(__file__).resolve().parents[1] / "ddlb_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("_build_of_this_checkout", source)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.ptxas_usage(log)


def sample_clocks(samples: list, stop: threading.Event) -> None:
    """Append (SM MHz, W) of every card from ``nvidia-smi`` every quarter
    second until ``stop`` is set."""
    while not stop.is_set():
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout
        for line in out.splitlines():
            fields = line.split(",")
            if len(fields) == 2:
                samples.append((float(fields[0]), float(fields[1])))
        stop.wait(0.25)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="root of the checkout to time")
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no card: torch.cuda.is_available() is false")
    import chip_smoke
    import ddlb_tpu_torch
    from ddlb_tpu_torch.ops import _build
    from ddlb_tpu_torch.ops import alltoall_matmul as am
    from ddlb_tpu_torch.ops import collective_matmul as cm
    from ddlb_tpu_torch.ops import matmul as k1
    from ddlb_tpu_torch.ops import ring_collectives as rc

    if not os.path.abspath(ddlb_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {ddlb_tpu_torch.__file__}, not the checkout at {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.card_identity()
    t0 = time.perf_counter()
    _build.build("matmul", "collective_matmul", "ring_collectives", "alltoall_matmul")
    built = time.perf_counter() - t0
    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_clocks, args=(samples, stop), daemon=True)
    sampler.start()
    try:
        entries = chip_smoke.kernel_phase_ring(cm, k1, smi)
        entries += chip_smoke.kernel_phase_trio(rc, am, k1, smi)
    finally:
        stop.set()
        sampler.join()
    print(json.dumps({
        "label": args.label or tree, "card": smi, "build_s": built,
        "sm_mhz_min_max": [min(c for c, _ in samples), max(c for c, _ in samples)]
        if samples else None,
        "power_w_max": max(w for _, w in samples) if samples else None,
        "ptxas": {name: ptxas_usage(_build.build_log(name))
                  for name in ("collective_matmul", "alltoall_matmul")},
        "kernels": {e["name"]: {key: e[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "mode")}
            for e in entries},
    }))


if __name__ == "__main__":
    main()
