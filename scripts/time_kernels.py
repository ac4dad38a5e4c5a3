"""Time K1, K8a, K8b, K9 and K10a-K10d, or K7, on one card, for one checkout.

    python scripts/time_kernels.py --tree DIR \
        [--phase flash|int8|quantized_path|flash_paths] [--label NAME]

Runs ``chip_smoke.py``'s kernel phases of the checkout at ``DIR``: with
``--phase flash`` (the default) ``kernel_phase_matmul`` (K1),
``kernel_phase_flash`` (K8a, K8b and K9), ``kernel_phase_flash_serving``
(K8a at the serving prefill's shape) and ``kernel_phase_flash_backward``
(K10a-K10d); with ``--phase int8`` ``kernel_phase_int8`` alone (K7 at the
GEMM path's, the decode MLP's and the prefill MLP's shapes, with its
timed variants); with ``--phase quantized_path`` the rows of
``chip_smoke.py``'s quantized path (``QUANT_SWEEPS`` at 8192^3 bf16
through the sweep runner, validated; each row's median host-clock ms
under ``rows``); with ``--phase flash_paths`` the rows that run the flash
kernels: ``chip_smoke.py``'s attention path (``ATTN_SWEEPS`` at m =
16384, n = 1024, k = 128 bf16) and its training rows (``training_rows``),
each row's median host-clock ms under ``rows``. It uses that checkout's own
package and kernels (built into ``DIR/build/ddlb_tpu_torch``), and prints
one JSON line: the card's name and power limit, each kernel's entry (ms,
plain ms, library ms, bound, max |err|), the build logs' ``ptxas``
registers and spill stores, and the card's SM clock and power draw
sampled while the phases run. Each phase checks its cases against the
plain versions first and fails as ``chip_smoke.py`` does.

To compare two commits on one card, unpack the other one with ``git
archive`` into a directory ``.gitignore`` lists and run this script in
turns, parent, change, change, parent, in one command: one process a
tree, since each process imports one checkout's package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from time_loopback import ptxas_usage, sample_clocks  # noqa: E402

KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
#: the libraries each phase builds and reads the build logs of
LIBRARIES = {"flash": ("matmul", "flash_attention"), "int8": ("quantized_matmul",),
             "quantized_path": ("quantized_matmul",),
             "flash_paths": ("matmul", "flash_attention", "decode_attention",
                             "quantized_matmul")}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="root of the checkout to time")
    parser.add_argument("--phase", choices=sorted(LIBRARIES), default="flash")
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
    from ddlb_tpu_torch.ops import flash_attention as fa
    from ddlb_tpu_torch.ops import matmul as k1
    from ddlb_tpu_torch.ops import quantized_matmul as qm

    if not os.path.abspath(ddlb_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {ddlb_tpu_torch.__file__}, not the checkout at {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.card_identity()
    t0 = time.perf_counter()
    libraries = LIBRARIES[args.phase]
    _build.build(*libraries)
    built = time.perf_counter() - t0
    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_clocks, args=(samples, stop), daemon=True)
    sampler.start()
    rows = {}
    try:
        if args.phase in ("quantized_path", "flash_paths"):
            from ddlb_tpu_torch.cli.benchmark import run_benchmark

            entries = []
            if args.phase == "quantized_path":
                runs = [(primitive, (chip_smoke.PATH_MNK,) * 3, implementations, {})
                        for primitive, implementations in chip_smoke.QUANT_SWEEPS.items()]
            else:
                attn = (chip_smoke.ATTN_M, chip_smoke.ATTN_N, chip_smoke.ATTN_K)
                train = {"warmups": chip_smoke.TRAIN_WARMUPS,
                         "iterations": chip_smoke.TRAIN_ITERATIONS}
                runs = [("cp_ring_attention", attn, impls, {})
                        for impls in chip_smoke.ATTN_SWEEPS]
                runs += [("transformer_step", shape, impls, train)
                         for shape, impls in chip_smoke.training_rows()]
            for primitive, shape, implementations, kw in runs:
                for row in chip_smoke.drive_path(run_benchmark, "cuda", primitive, shape,
                                                 implementations, **kw):
                    rows[f"{primitive} {list(shape)} {row['implementation']} "
                         f"{row['option']}"] = row["median time (ms)"]
                torch.cuda.empty_cache()
        elif args.phase == "int8":
            entries = [chip_smoke.kernel_phase_int8(qm, smi)]
        else:
            entries = [chip_smoke.kernel_phase_matmul(k1, smi)]
            forward, chunk = chip_smoke.kernel_phase_flash(fa, smi)
            entries += [forward, forward["rect"], chunk]
            serving = chip_smoke.kernel_phase_flash_serving(fa, smi)
            torch.cuda.empty_cache()
            entries += [serving, *chip_smoke.kernel_phase_flash_backward(fa, smi)]
    finally:
        stop.set()
        sampler.join()
    print(json.dumps({
        "label": args.label or tree, "card": smi, "build_s": built,
        "sm_mhz_min_max": [min(c for c, _ in samples), max(c for c, _ in samples)]
        if samples else None,
        "power_w_max": max(w for _, w in samples) if samples else None,
        "ptxas": {name: ptxas_usage(_build.build_log(name)) for name in libraries},
        "kernels": {e["name"]: {key: e.get(key) for key in (*KEYS, "mma_ms", "sdpa_ms", "variants")
                                if key in e or key in KEYS}
                    for e in entries},
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
