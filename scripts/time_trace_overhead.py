"""What tracing costs a timed row, and why: one card.

Run from the repository root on one H100 (``python
scripts/time_trace_overhead.py``; ``--device cpu`` rehearses it):

The runner's host-clock loop (``utils.timing.host_clock``, a barrier
before every timed call) over ``tp_columnwise`` ``cuda`` at 4096^3 bf16
(K1), ``ITERATIONS`` calls a sample, in turns over ``ROUNDS`` rounds:

- ``off``: tracing off;
- ``on``: ``DDLB_TPU_TRACE`` set, so every barrier writes its span and its
  ``clocksync.exchange`` instant;
- ``gap_<us>``: tracing off, the barrier followed by a busy wait of that
  many microseconds: a host gap before the timed call like the one the
  trace writes leave, without the writes.

Prints, per variant, the medians of the per-call times and the barrier's
host microseconds (``on`` against ``off``), then the card's name and power
limit. If the ``gap`` rows move as ``on`` does, the cost is the idle gap
before the timed launch, not the trace's writes.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MNK, ITERATIONS, ROUNDS = 4096, 50, 3
GAPS_US = (50, 150, 500)


def busy_wait(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    import numpy as np

    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.runtime import Runtime
    from ddlb_tpu_torch.utils import timing

    on_card = args.device == "cuda"
    if on_card:
        from ddlb_tpu_torch.ops import _build

        _build.build("matmul")
    mnk = MNK if on_card else 64
    impl = load_impl_class("tp_columnwise", "cuda")(
        mnk, mnk, mnk, dtype="bfloat16" if on_card else "float32", device=args.device)
    runtime = Runtime(args.device)
    for _ in range(5):
        impl.run()
    runtime.synchronize()
    trace_dir = tempfile.mkdtemp(prefix="trace_overhead_")

    class GapRuntime:
        """The runtime, its barrier followed by a busy wait."""

        def __init__(self, gap_s):
            self.gap_s = gap_s

        def barrier(self):
            runtime.barrier()
            busy_wait(self.gap_s)

        def synchronize(self):
            runtime.synchronize()

    variants = ["off", "on"] + [f"gap_{us}" for us in GAPS_US]
    medians = {v: [] for v in variants}
    barrier_us = {"off": [], "on": []}
    for r in range(ROUNDS):
        order = variants if r % 2 == 0 else variants[::-1]
        for v in order:
            if v == "on":
                os.environ["DDLB_TPU_TRACE"] = trace_dir
            else:
                os.environ.pop("DDLB_TPU_TRACE", None)
            rt = GapRuntime(int(v.split("_")[1]) * 1e-6) if v.startswith("gap") else runtime
            times = timing.host_clock(impl.run, rt, ITERATIONS, True)
            medians[v].append(float(np.median(times)))
            if v in barrier_us:
                t0 = time.perf_counter()
                for _ in range(ITERATIONS):
                    runtime.barrier()
                barrier_us[v].append(1e6 * (time.perf_counter() - t0) / ITERATIONS)
    os.environ.pop("DDLB_TPU_TRACE", None)
    card = "cpu"
    if on_card:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    for v in variants:
        print(json.dumps({"variant": v, "shape": [mnk] * 3, "iterations": ITERATIONS,
                          "median_ms_by_round": medians[v],
                          "barrier_us_by_round": barrier_us.get(v), "card": card}))


if __name__ == "__main__":
    main()
