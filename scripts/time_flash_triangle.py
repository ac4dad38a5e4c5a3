"""Time the causal triangle's flash kernels side by side on one card.

    python scripts/time_flash_triangle.py

The port's wrappers send the triangle (causal, offset 0, ``sq == skv``) in
bf16/fp16 to ``ddlb_flash_forward_tri`` (K8a, ``tri::flash_fwd_wgmma``)
and ``ddlb_flash_bwd_dq_tri`` / ``ddlb_flash_bwd_dkv_tri`` (K10a
``tri_bwd::flash_bwd_dq_wgmma``, K10b ``tri_bwd::flash_bwd_dkv_wgmma``).
Other kernels of the library take the same work at offset 0 with a causal
band: ``ddlb_flash_forward_band`` (the rectangle's ``band::flash_fwd_wgmma``)
and ``ddlb_flash_bwd_dq_band`` / ``ddlb_flash_bwd_dkv_band`` (the
rectangle's backward, ``band_bwd::flash_bwd_dq_wgmma`` and
``band_bwd::flash_bwd_dkv_wgmma``). This script calls them on the same bf16
inputs at the main
paths' shapes: the forward at the training step's merged heads, the
attention path's 16384² with 8 heads and the serving prefill's 8192² with
128 query heads (and 32 kv heads); the backward's two passes at the
training step's shapes, beside ``attention_delta`` (the ``rowsum(dO o)``
the wrapper computes before them) and SDPA's backward
(``scaled_dot_product_attention`` with ``is_causal``, forward and backward
through autograd less the forward, all three gradients, per turn). Each
set runs in four turns that alternate which goes first; it prints
CUDA-event milliseconds per launch with the card's name and power limit,
one JSON line a shape. It checks nothing; ``chip_smoke.py`` and the card
tests hold the kernels against their plain versions. To time an older
generation of a kernel, run ``scripts/time_kernels.py`` on both trees.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

#: (sequence, query heads, kv heads) of bf16 [s, h, 128] q, k, v for the forward
FORWARD_SHAPES = ((2048, 16, 16), (2048, 32, 32), (2048, 64, 64), (4096, 64, 64),
                  (16384, 8, 8), (8192, 128, 128), (8192, 128, 32))
#: (sequence, heads) for the backward: the training step's triangles
#: (``chip_smoke.TRAIN_BWD_SHAPES``)
BACKWARD_SHAPES = ((2048, 16), (2048, 32), (4096, 64))
TURNS, CALLS = 4, 20


def time_turns(calls):
    """CUDA-event ms per launch of each call, TURNS times, alternating order."""
    import torch

    times = {name: [] for name in calls}
    for turn in range(TURNS):
        for name in list(calls)[:: 1 if turn % 2 == 0 else -1]:
            call = calls[name]
            rc = call()  # a C entry point's cudaError, or a tensor
            if isinstance(rc, int) and rc != 0:
                raise SystemExit(f"{name} launch failed: cudaError {rc}")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                call()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / CALLS)
    return times


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("no card: torch.cuda.is_available() is false")
    from ddlb_tpu_torch.ops import flash_attention as fa

    lib = fa._lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    scale = 128 ** -0.5

    def draw(s, h):
        return (torch.rand((s, h, 128), generator=gen, device="cuda") * 2 - 1).bfloat16()

    for s, h, h_kv in FORWARD_SHAPES:
        q, k, v = draw(s, h), draw(s, h_kv), draw(s, h_kv)
        o = torch.empty_like(q)
        lse = torch.empty((h, s, 1), device="cuda")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
        times = time_turns({
            "tri": lambda: lib.ddlb_flash_forward_tri(2, *ptrs, s, h, h_kv, 128, scale, stream),
            "band": lambda: lib.ddlb_flash_forward_band(2, *ptrs, s, s, h, h_kv, 128, scale, 0,
                                                        1, 0, stream),
        })
        print(json.dumps({"pass": "forward", "s": s, "heads": [h, h_kv], "card": card,
                          "ms": times}))
        del q, k, v, o, lse
    for s, h in BACKWARD_SHAPES:
        q, k, v, do = draw(s, h), draw(s, h), draw(s, h), draw(s, h)
        o, lse = fa.flash_forward(q, k, v, scale=scale)
        delta = fa.attention_delta(o, do)
        dq = torch.empty((s, h, 128), device="cuda")
        dk, dv = torch.empty_like(dq), torch.empty_like(dq)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               delta.data_ptr())
        dq_out, dkv_out = (dq.data_ptr(),), (dk.data_ptr(), dv.data_ptr())
        times = time_turns({
            "band_bwd_dq": lambda: lib.ddlb_flash_bwd_dq_band(
                2, *ins, *dq_out, s, s, h, h, 128, scale, 0, 0, 1, 0, stream),
            "tri_bwd_dq": lambda: lib.ddlb_flash_bwd_dq_tri(
                2, *ins, *dq_out, s, h, h, 128, scale, stream),
        })
        times.update(time_turns({
            "band_bwd_dkv": lambda: lib.ddlb_flash_bwd_dkv_band(
                2, *ins, *dkv_out, s, s, h, h, 128, scale, 0, 0, 1, 0, stream),
            "tri_bwd_dkv": lambda: lib.ddlb_flash_bwd_dkv_tri(
                2, *ins, *dkv_out, s, h, h, 128, scale, stream),
        }))
        times.update(time_turns({"attention_delta": lambda: fa.attention_delta(o, do)}))
        qt, kt, vt = (x.transpose(0, 1)[None].contiguous().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(0, 1)[None].contiguous()

        def sdpa_forward():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

        sdpa = time_turns({
            "sdpa_forward": sdpa_forward,
            "sdpa_forward_backward": lambda: torch.autograd.grad(sdpa_forward(), (qt, kt, vt), dot),
        })
        times.update(sdpa)
        times["sdpa_backward"] = [both - fwd for fwd, both in
                                  zip(sdpa["sdpa_forward"], sdpa["sdpa_forward_backward"])]
        print(json.dumps({"pass": "backward", "s": s, "heads": h, "card": card, "ms": times}))
        del q, k, v, do, o, lse, delta, dq, dk, dv, qt, kt, vt, dot


if __name__ == "__main__":
    main()
