"""Time K8a's two kernels for the causal triangle side by side on one card.

    python scripts/time_flash_forward.py

The flash library still compiles ``flash_mma``, the forward that ran the
triangle before ``flash_fwd_wgmma`` took it over: ``ddlb_flash_forward``
with a causal mask at offset 0 and ``sq == skv`` reaches it, while the
port's wrapper sends that case to ``ddlb_flash_forward_tri``. This script
calls both entry points on the same bf16 inputs at the main paths' shapes
(the training step's merged heads, the attention path's 16384² with 8
heads, the serving prefill's 8192² with 128), in four turns that
alternate which runs first, and prints CUDA-event milliseconds per launch
with the card's name and power limit. It checks nothing; ``chip_smoke.py``
and the card tests hold the kernels against their plain version.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

#: (sequence, heads) of bf16 [s, h, 128] q, k, v
SHAPES = ((2048, 16), (2048, 32), (2048, 64), (4096, 64), (16384, 8), (8192, 128))


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no card: torch.cuda.is_available() is false")
    from ddlb_tpu_torch.ops import flash_attention as fa

    lib = fa._lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for s, h in SHAPES:
        q, k, v = ((torch.rand((s, h, 128), generator=gen, device="cuda") * 2 - 1).bfloat16()
                   for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty((h, s, 1), device="cuda")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
        calls = {
            "flash_mma": lambda: lib.ddlb_flash_forward(2, *ptrs, s, s, h, h, 128, 128 ** -0.5,
                                                        0, 1, 0, stream),
            "flash_fwd_wgmma": lambda: lib.ddlb_flash_forward_tri(2, *ptrs, s, h, h, 128,
                                                                  128 ** -0.5, stream),
        }
        times = {name: [] for name in calls}
        for turn in range(4):
            for name in list(calls)[:: 1 if turn % 2 == 0 else -1]:
                call = calls[name]
                if call() != 0:
                    raise SystemExit(f"{name} launch failed at {s}, {h}")
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
        print(json.dumps({"s": s, "heads": h, "card": card, "ms": times}))


if __name__ == "__main__":
    main()
