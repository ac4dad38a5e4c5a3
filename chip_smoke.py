#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check what comes out.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. the card: ``nvidia-smi``'s name and power limit;
2. kernels: build every kernel of the main path from ``ddlb_tpu_torch/csrc``
   (one ``nvcc`` each, in parallel), hold each against its plain PyTorch
   version on the card at the stated tolerance, and time it beside the
   plain version, the one PyTorch call that computes the same function
   (``library_ms``) and its bound;
3. the main path: the port's sweep runner (``run_benchmark``) on both
   tensor-parallel families at m = n = k = 8192 bf16 with validation, every
   member; every row must be valid with finite times, and the kernel launch
   counts, zeroed just before, must match what the ``cuda`` rows launch;
4. one ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

SEED = 0
#: the main path's shape and dtype
PATH_MNK = 8192
NUM_WARMUPS = 3
NUM_ITERATIONS = 10
#: H100 SXM dense bf16 tensor-core peak and memory rate (NVIDIA data
#: sheet) at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
OUT_DIR = os.path.join("results", "chip_smoke")


def fail(message):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr)
    sys.exit(1)


def card_identity():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        fail(f"nvidia-smi did not run: {exc}")
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iterations, windows=3):
    """Median over windows of CUDA-event milliseconds per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iterations)
    samples.sort()
    return samples[len(samples) // 2]


def check_matmul(k1, m, n, k, dtype_name):
    """K1 against its plain version on the card, twice:

    - integer-valued operands in [-4, 4]: bit for bit equal, since every
      product and partial sum is an integer below 2**24, exact in float32
      in any order, and both sides round the same value once;
    - uniform [-1, 1] operands: bf16/fp16 within ``k1.plain_gap_bound``
      (two float32 summation orders plus one output rounding), f32 within
      atol 1e-5 * k (a tenth of the repo's f32 validation contract).

    Returns (max |err| on the uniform operands, tolerance text, operands).
    """
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randint(-4, 5, (m, k), generator=gen, device="cuda").to(dtype)
    b = torch.randint(-4, 5, (k, n), generator=gen, device="cuda").to(dtype)
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, k1.matmul_plain(a, b)):
        fail(f"K1 {m}x{n}x{k} {dtype_name}: not exact on integer operands")

    a = (torch.rand((m, k), generator=gen, device="cuda") * 2 - 1).to(dtype)
    b = (torch.rand((k, n), generator=gen, device="cuda") * 2 - 1).to(dtype)
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    want = k1.matmul_plain(a, b)
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    if dtype_name == "float32":
        bad = int((err > 1e-5 * k).sum())
        text = f"exact on integers; atol {1e-5 * k:g}"
    else:
        bad = int((err > k1.plain_gap_bound(a, b, got, want)).sum())
        text = "exact on integers; plain_gap_bound"
    if not math.isfinite(max_err) or bad:
        fail(
            f"K1 {m}x{n}x{k} {dtype_name}: {bad} elements beyond {text}, "
            f"max |err| {max_err}"
        )
    return max_err, text, (a, b)


#: every member of both families, each option of the sweep
MAIN_PATH_SWEEPS = {
    "tp_columnwise": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{"order": ["AG_before", "AG_after"]}],
        "cuda": [{"order": ["AG_before", "AG_after"]}],
    },
    "tp_rowwise": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{}],
        "cuda": [{}],
    },
}


def drive_main_path(run_benchmark, device, mnk):
    """The port's sweep runner over both families at m = n = k = ``mnk``
    bf16 with validation; prints every row and fails unless each is valid
    on ``device`` with a finite time. Returns the rows."""
    os.makedirs(OUT_DIR, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    rows = []
    t0 = time.perf_counter()
    for primitive, implementations in MAIN_PATH_SWEEPS.items():
        rows += run_benchmark({
            "primitive": primitive,
            "m": mnk,
            "n": mnk,
            "k": mnk,
            "dtype": "bfloat16",
            "validate": True,
            "num_iterations": NUM_ITERATIONS,
            "num_warmups": NUM_WARMUPS,
            "time_measurement_backend": "host_clock",
            "barrier_at_each_iteration": True,
            "device": device,
            "output_csv": os.path.join(OUT_DIR, f"{primitive}_{stamp}.csv"),
            "implementations": implementations,
        })
    print(f"main path: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    for row in rows:
        print(json.dumps({key: row[key] for key in (
            "primitive", "implementation", "option", "median time (ms)",
            "Throughput (TFLOPS)", "platform", "device_kind", "valid", "error",
        )}))
    bad = [
        r["implementation"] for r in rows
        if not (r["valid"] and not r["error"] and r["platform"] == device
                and math.isfinite(r["median time (ms)"]))
    ]
    if bad:
        fail(f"rows not valid on {device}: {bad}")
    return rows


def main():
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is not importable: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import ddlb_tpu_torch
        from ddlb_tpu_torch.cli.benchmark import run_benchmark
        from ddlb_tpu_torch.ops import _build
        from ddlb_tpu_torch.ops import matmul as k1
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repo ({exc})")
    # the port under test is the checkout's, never an installed copy
    if not os.path.abspath(ddlb_tpu_torch.__file__).startswith(here + os.sep):
        fail(f"ddlb_tpu_torch imported from {ddlb_tpu_torch.__file__}, not {here}")

    # 1. the card
    smi = card_identity()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernels: build, check, time
    t0 = time.perf_counter()
    _build.build("matmul")
    print(f"built matmul in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("matmul").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    main_err = None
    for m, n, k, dtype_name in (
        (PATH_MNK, PATH_MNK, PATH_MNK, "bfloat16"),
        (2048, 2048, 2048, "float16"),
        (2048, 2048, 2048, "float32"),
        (1000, 776, 520, "bfloat16"),
    ):
        max_err, tol, operands = check_matmul(k1, m, n, k, dtype_name)
        print(
            f"K1 {m}x{n}x{k} {dtype_name}: max |err| {max_err!r} vs plain "
            f"({tol}): ok"
        )
        if main_err is None:
            main_err, (a, b) = max_err, operands
    timings = {"ms": [], "library_ms": [], "plain_ms": []}
    calls = {
        "ms": lambda: k1.matmul(a, b),
        "library_ms": lambda: torch.matmul(a, b),
        "plain_ms": lambda: k1.matmul_plain(a, b),
    }
    for order in (("ms", "library_ms", "plain_ms"), ("plain_ms", "library_ms", "ms")):
        for key in order:
            timings[key].append(cuda_ms(calls[key], iterations=20))
    times = {key: min(v) for key, v in timings.items()}
    m = n = k = PATH_MNK
    flops = 2.0 * m * n * k
    bytes_moved = (m * k + k * n + m * n) * a.element_size()
    bound_ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    print(
        f"K1 {m}^3 bf16: kernel {times['ms']!r} ms, torch.matmul "
        f"{times['library_ms']!r} ms, plain {times['plain_ms']!r} ms, bound "
        f"{max(bound_ops_ms, bound_bytes_ms)!r} ms ({smi}); windows {timings}"
    )
    del a, b

    # 3. the main path, counts zeroed just before
    k1.LAUNCHES = 0
    rows = drive_main_path(run_benchmark, "cuda", PATH_MNK)
    launches = k1.LAUNCHES
    cuda_rows = sum(1 for r in rows if r["base_implementation"] == "cuda")
    # each cuda row runs K1 once per warmup, per timed iteration and for
    # validation; no other row may launch it
    expected = cuda_rows * (NUM_WARMUPS + NUM_ITERATIONS + 1)
    if launches != expected or launches == 0:
        fail(f"K1 launched {launches} times on the main path, expected {expected}")

    # 4. results
    print(json.dumps({"kernels": [{
        "name": "matmul",
        "route": "cuda",
        "source": "ddlb_tpu_torch/csrc/matmul.cu",
        "replaces": "ddlb_tpu/ops/matmul.py:25",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": max(bound_ops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": times["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
