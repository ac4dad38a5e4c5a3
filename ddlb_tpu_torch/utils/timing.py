"""Timing backends: a host clock around synchronised runs, and CUDA events.

- ``host_clock``: ``time.perf_counter_ns`` around work that ends in a
  device sync. With ``barrier_each`` every iteration starts at a barrier
  and is one sample; without it, the N iterations run back to back between
  one barrier and one sync and make ONE sample (their mean), so no spread
  is invented. Exactly the JAX runner's ``_timing_loop`` host paths.
- ``device_loop``: CUDA events recorded around ``num_iterations``
  back-to-back runs, one sample (milliseconds per run) per window. It needs
  the card; on the CPU it raises. Each window is a ``device_loop.window``
  span, and the row's ``loop_overhead_s`` is the median over windows of
  the window's host-clock seconds less its CUDA-event seconds: the
  dispatch and fence slack the events leave out. ``host_clock`` rows leave
  that column at 0.0.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ddlb_tpu_torch import telemetry


def host_clock(
    run: Callable[[], object],
    runtime,
    num_iterations: int,
    barrier_each: bool,
) -> np.ndarray:
    """Per-run milliseconds measured on the host clock."""
    if barrier_each:
        times = np.empty(num_iterations, dtype=np.float64)
        for i in range(num_iterations):
            runtime.barrier()
            t0 = time.perf_counter_ns()
            run()
            runtime.synchronize()
            times[i] = (time.perf_counter_ns() - t0) * 1e-6
        return times
    runtime.barrier()
    t0 = time.perf_counter_ns()
    for _ in range(num_iterations):
        run()
    runtime.synchronize()
    return np.array([(time.perf_counter_ns() - t0) * 1e-6 / num_iterations])


def device_loop(
    run: Callable[[], object],
    runtime,
    num_iterations: int,
    num_windows: int = 5,
) -> np.ndarray:
    """Per-run milliseconds from CUDA events, one sample per window."""
    if runtime.platform != "cuda":
        raise ValueError(
            "time_measurement_backend='device_loop' times with CUDA events "
            f"and needs the card; this runtime is on {runtime.platform}"
        )
    windows = np.empty(max(1, int(num_windows)), dtype=np.float64)
    slack = np.empty_like(windows)
    for w in range(windows.size):
        runtime.barrier()
        with telemetry.span("device_loop.window", cat="timing", window=w,
                            iterations=num_iterations):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(num_iterations):
                run()
            end.record()
            end.synchronize()
            host_s = time.perf_counter() - t0
        event_ms = start.elapsed_time(end)
        windows[w] = event_ms / num_iterations
        slack[w] = host_s - event_ms * 1e-3
    telemetry.record_max("loop_overhead_s", float(np.median(slack)))
    return windows
