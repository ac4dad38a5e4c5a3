"""Where a compiled decode step spends its time, by MLP kernel, on one card.

    python scripts/profile_compiled_decode.py

Builds the ``transformer_decode`` ``compiled`` member at the serving
path's width (m = 2048, d_model 2048, d_ff 8192, 16 heads of 128, vocab
16384, batch 8, bf16) with ``mlp_kernel`` bf16, ``int8_weights`` and
``int8``, warms each up, times 20 steps back to back (host clock around
them, one synchronise at the end: no barrier and no per-step wait, so the
card's queue stays fed), then records five steps with ``torch.profiler``
and prints the ten operators with the most host time and the ten with the
most card time. In the int8 rows the MLP's products are the K7 operators
``ddlb::int8_matmul`` / ``ddlb::int8_ste_matmul``, opaque nodes of the
compiled graph; ``int8`` quantizes both expert weights inside its
operator at every step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 20


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddlb_tpu_torch.primitives.registry import load_impl_class

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    for mlp_kernel in ("bf16", "int8_weights", "int8"):
        impl = load_impl_class("transformer_decode", "compiled")(
            2048, 2048, 8192, dtype="bfloat16", device="cuda", phase="decode", batch=8,
            vocab=16384, n_heads=16, mlp_kernel=mlp_kernel)
        for _ in range(3):
            impl.run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            impl.run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STEPS * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                impl.run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the kernels' own records (an operator's record repeats its kernels' time)
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA) / 5
        print(json.dumps({"compiled_decode": mlp_kernel, "ms_per_step": ms,
                          "device_us_per_step": device_us, "card": card}), flush=True)
        print(events.table(sort_by="self_cpu_time_total", row_limit=10))
        print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)
        del impl
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
