#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check what comes out.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. the card: ``nvidia-smi``'s name and power limit;
2. kernels: build every kernel of the main paths from ``ddlb_tpu_torch/csrc``
   (one ``nvcc`` each, in parallel), hold each against its plain PyTorch
   version on the card at the stated tolerance, and time it beside the
   plain version, the one PyTorch call that computes the same function
   (``library_ms``) and its bound: K1 (the tiled GEMM), K8a/K8b (the flash
   forward, triangle and rectangle, at the attention path's shapes and at
   the serving path's prefill and admission shapes), K9 (the
   carried-chunk fold), K11 and K12 (single-token decode attention,
   contiguous and paged), K7 (the int8 GEMM, bit for bit at the GEMM
   path's 8192^3, the decode and prefill MLP's shapes and ragged ones,
   each output dtype), K10a-K10d (the flash backward's dQ and dK/dV
   passes, triangle and rectangle, within ``backward_gap_bound`` at the
   training path's shapes and ragged, GQA, offset, past, diagonal and
   windowed cases; each pass timed beside SDPA's backward);
3. the main paths, each with the launch counts zeroed just before it and
   read just after, through the port's sweep runner (``run_benchmark``)
   with validation: both tensor-parallel families at m = n = k = 8192 bf16,
   every member (K1 in the ``cuda`` rows); then the quantized path at the
   same shape (``scripts/config_quantized.json``'s ``kernel`` x
   ``quantize`` grid of every family's ``quantized`` member, and the
   ``compute_only`` and ``pytorch`` members of ``dp_allreduce`` and
   ``ep_alltoall``; K7 in the ``kernel=pallas`` rows); then
   ``cp_ring_attention`` at m = 16384, n = 1024, k = 128 bf16, every member
   and option of ``scripts/config_cp_ring_attention.json`` plus
   ``ring_flash`` and one windowed GQA ``flash`` row (K8a, K8b, K9); then
   the serving path, ``transformer_decode`` at the full width of
   ``scripts/config_transformer_decode.json`` (``SERVE_ROWS``: the decode
   grid of ``config_serving_fast_decode.json``, prefill, generate, the
   serve entries of ``config_serving_paged.json``, and the int8 MLP rows:
   the fast-decode config's ``int8_weights`` entry beside its bf16 twin,
   ``int8_weights`` decode and prefill, an ``int8`` decode; K8a, K11,
   K12, K7), one row at a time with its launches checked exactly; then
   the training path, ``transformer_step`` one row at a time
   (``training_rows``: ``scripts/config_transformer_step.json``'s ``spmd``
   and ``compute_only`` entries, the full width of
   ``scripts/config_router.json``'s first entry with the block router,
   train and forward, the same train with ``attn_window=1024``, and an
   ``mlp_kernel=int8`` train row; K8a, K8b, K9, K10a-K10d, K7), with each
   row's ms per step, tokens/s and model-FLOPs utilisation. Every row must
   be valid with a finite time, and the counts must be exactly what the
   rows launch;
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
#: the GEMM path's shape and dtype
PATH_MNK = 8192
#: the attention path's shape (sequence, width, head_dim), bf16: the
#: largest of scripts/config_cp_ring_attention.json
ATTN_M, ATTN_N, ATTN_K = 16384, 1024, 128
#: the windowed GQA row, which takes K8b at world 1
ATTN_WINDOW = {"window": 4096, "n_kv_heads": 2}
NUM_WARMUPS = 3
NUM_ITERATIONS = 10
#: H100 SXM dense bf16 tensor-core peak and memory rate (NVIDIA data
#: sheet) at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
#: the decode kernels at the serving path's shapes: batch 8, 16 heads of
#: 128, a decode cache of m + 1 = 8193 positions, the serve pool's pages
DECODE_B, DECODE_H, DECODE_DH, DECODE_S = 8, 16, 128, 8193
PAGE_SIZE, SERVE_PAGES = 128, 17
OUT_DIR = os.path.join("results", "chip_smoke")
#: the flash backward's launch counts: the dQ and dK/dV passes of the
#: triangle (K10a, K10b) and of the rectangle (K10c, K10d)
BWD_KEYS = ("bwd_dq_tri", "bwd_dkv_tri", "bwd_dq_rect", "bwd_dkv_rect")


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
GEMM_SWEEPS = {
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

#: scripts/config_quantized.json's grid, for the quantized member of every
#: GEMM family, and the other members of the data- and expert-parallel
#: families (scripts/config_dp_allreduce.json, config_ep_alltoall.json)
QUANT_GRID = {"kernel": ["xla", "pallas"], "quantize": ["static", "dynamic"]}
QUANT_SWEEPS = {
    "tp_columnwise": {"quantized": [QUANT_GRID]},
    "tp_rowwise": {"quantized": [QUANT_GRID]},
    "dp_allreduce": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{"strategy": ["all_reduce", "rs_ag"]}],
        "quantized": [QUANT_GRID],
    },
    "ep_alltoall": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{}],
        "quantized": [QUANT_GRID],
    },
}

#: the members and options of scripts/config_cp_ring_attention.json, plus
#: ring_flash (both skip settings); then, in a run of its own (another
#: oracle), the windowed GQA flash row
ATTN_SWEEPS = [
    {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "ring": [{"skip_masked_blocks": [True, False]}],
        "allgather": [{}],
        "flash": [{}],
        "ulysses": [{"compute": ["einsum", "flash"]}],
        "ring_flash": [{"skip_masked_blocks": [True, False]}],
    },
    {"flash": [ATTN_WINDOW]},
]


def drive_path(run_benchmark, device, primitive, shape, implementations,
               warmups=NUM_WARMUPS, iterations=NUM_ITERATIONS, extra_keys=()):
    """The port's sweep runner over one family at ``shape`` bf16 with
    validation; prints every row (with ``extra_keys`` where present) and
    fails unless each is valid on ``device`` with a finite time. Returns
    the rows."""
    os.makedirs(OUT_DIR, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    m, n, k = shape
    t0 = time.perf_counter()
    rows = run_benchmark({
        "primitive": primitive,
        "m": m,
        "n": n,
        "k": k,
        "dtype": "bfloat16",
        "validate": True,
        "num_iterations": iterations,
        "num_warmups": warmups,
        "time_measurement_backend": "host_clock",
        "barrier_at_each_iteration": True,
        "device": device,
        "output_csv": os.path.join(OUT_DIR, f"{primitive}_{stamp}.csv"),
        "implementations": implementations,
    })
    print(f"{primitive}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    for row in rows:
        print(json.dumps({key: row[key] for key in (
            "primitive", "implementation", "option", "median time (ms)",
            "Throughput (TFLOPS)", "platform", "device_kind", "valid", "error",
            *extra_keys,
        ) if key in row}))
    bad = [
        r["implementation"] for r in rows
        if not (r["valid"] and not r["error"] and r["platform"] == device
                and math.isfinite(r["median time (ms)"]))
    ]
    if bad:
        fail(f"{primitive} rows not valid on {device}: {bad}")
    return rows


def row_options(row):
    """A row's resolved options (``k=v;...``) as a dict of strings."""
    return dict(item.split("=", 1) for item in row["option"].split(";") if "=" in item)


def expected_flash_launches(rows):
    """Kernel launches the attention rows make: one per warmup, per timed
    iteration and for validation, in the case each row takes at world 1."""
    per_row = NUM_WARMUPS + NUM_ITERATIONS + 1
    want = {"tri": 0, "rect": 0, "chunk": 0, **dict.fromkeys(BWD_KEYS, 0)}
    for row in rows:
        base, opts = row["base_implementation"], row_options(row)
        if base == "ring_flash":
            want["chunk"] += per_row
        elif base == "flash" or (base == "ulysses" and opts["compute"] == "flash"):
            # offset 0 at world 1: the triangle unless a window cuts it
            windowed = 0 < int(opts["window"]) < row["m"]
            want["rect" if windowed else "tri"] += per_row
    return want


# -- flash attention (K8a, K8b, K9) ------------------------------------------


def band_inputs(sq, skv, h, h_kv, dh, dtype, gen):
    """q = 0 and integer-valued k, v in [-4, 4]: every live score is 0, so
    p is exactly 1 on the live band and 0 off it, sums of v are exact in
    float32, and l counts the live keys. Kernel and plain version then
    agree bit for bit, and a wrong band shows as another count or sum."""
    import torch

    q = torch.zeros((sq, h, dh), dtype=dtype, device="cuda")
    k = torch.randint(-4, 5, (skv, h_kv, dh), generator=gen, device="cuda")
    v = torch.randint(-4, 5, (skv, h_kv, dh), generator=gen, device="cuda")
    return q, k.to(dtype), v.to(dtype)


def uniform_inputs(sq, skv, h, h_kv, dh, dtype, gen):
    import torch

    def draw(shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(dtype)

    return draw((sq, h, dh)), draw((skv, h_kv, dh)), draw((skv, h_kv, dh))


def peaked_inputs(sq, skv, h, h_kv, dh, dtype, gen, shift):
    """Uniform [-1, 1] k, v and q = 4 * k at key ``(i + shift) % skv`` of
    its kv head (exact in every operand type). That key scores about 15,
    the others about 0 ± 1.3, so where it is live the row's softmax puts
    nearly all its weight there and |o| stays near max|v| however long the
    band: a wrong score, scale or exp moves o far beyond
    ``plain_gap_bound``, which on uniform inputs can exceed |o| of a late
    row of a long band."""
    import torch

    _, k, v = uniform_inputs(sq, skv, h, h_kv, dh, dtype, gen)
    rows = (torch.arange(sq, device="cuda") + shift) % skv
    return (4 * k[rows]).repeat_interleave(h // h_kv, dim=1), k, v


def check_flash_forward(fa, sq, skv, h, h_kv, dh, dtype_name, row_offset,
                        window):
    """K8a/K8b against ``flash_forward_plain`` on the card: bit for bit on
    band inputs; on uniform [-1, 1] inputs and on peaked ones (q aligned
    with the key at the query's own position) the output within
    ``fa.plain_gap_bound`` and lse within ``4*Δs + 2*skv*2**-23 + 1e-5``
    (the score gap and two summation orders of l; empty rows exactly
    NEG_INF on both). Returns (max |err| of o over both, the uniform
    inputs, keyword arguments)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kw = {"scale": dh ** -0.5, "row_offset": row_offset, "window": window}
    what = f"flash forward {sq}x{skv} h={h}/{h_kv} dh={dh} off={row_offset} w={window} {dtype_name}"
    q, k, v = band_inputs(sq, skv, h, h_kv, dh, dtype, gen)
    o, lse = fa.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    if not torch.equal(o, o_p):
        fail(f"{what}: not exact on band inputs "
             f"({int((o != o_p).sum())} elements differ)")
    if not torch.allclose(lse, lse_p, rtol=1e-6, atol=0.0):
        fail(f"{what}: lse not within 1e-6 on band inputs")
    print(f"{what}: exact on band inputs: ok")

    uniform = uniform_inputs(sq, skv, h, h_kv, dh, dtype, gen)
    peaked = peaked_inputs(sq, skv, h, h_kv, dh, dtype, gen, row_offset)
    errs = []
    for name, (q, k, v) in (("uniform", uniform), ("peaked", peaked)):
        o, lse = fa.flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
        err = (o.float() - o_p.float()).abs()
        bound = fa.plain_gap_bound(q, k, v, o, o_p, scale=kw["scale"],
                                   n_terms=skv)
        bad = int((err > bound).sum())
        empty = lse_p == fa.NEG_INF
        lse_tol = 4 * fa.score_gap(q, k, kw["scale"]) + 2 * skv * 2.0**-23 + 1e-5
        bad_lse = int(((lse - lse_p).abs() > lse_tol)[~empty].sum())
        if not torch.equal(lse == fa.NEG_INF, empty):
            bad_lse += 1
        max_err = float(err.max())
        if not math.isfinite(max_err) or bad or bad_lse:
            fail(f"{what}, {name} inputs: {bad} outputs beyond "
                 f"plain_gap_bound, {bad_lse} lse beyond {lse_tol:g}; max "
                 f"|err| {max_err}")
        # how much of o the bound leaves unchecked: the share of outputs
        # whose |o| is below their bound
        loose = float((o_p.float().abs() < bound).float().mean())
        print(f"{what}, {name} inputs: max |err| {max_err!r} within "
              f"plain_gap_bound (largest bound {float(bound.max())!r}, median "
              f"|o| {float(o_p.float().abs().median())!r}, share of |o| "
              f"below its bound {loose!r}): ok")
        errs.append(max_err)
    return max(errs), uniform, kw


def check_flash_chunk(fa, sq, skv, h, h_kv, dh, dtype_name, row_offset,
                      col_offset, mode, window):
    """K9 against ``flash_chunk_plain`` on the card: two folds into one
    carry (the second reads what the first wrote in place), bit for bit
    on band inputs; on uniform inputs, one fold, the normalised output
    within ``fa.plain_gap_bound``, m within the score gap Δs and l within
    a relative ``4*Δs + 2*skv*2**-23 + 2**-20``. Returns (max |err| of the
    output, inputs, keyword arguments)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    scale = dh ** -0.5
    kw = {"scale": scale, "row_offset": row_offset, "col_offset": col_offset,
          "causal": mode, "window": window}
    what = (f"flash chunk {mode} {sq}x{skv} h={h}/{h_kv} dh={dh} "
            f"off={row_offset}/{col_offset} w={window} {dtype_name}")
    q, k, v = band_inputs(sq, skv, h, h_kv, dh, dtype, gen)
    carry = fa.init_flash_carry(sq, h, dh, "cuda")
    want = fa.flash_chunk_plain(q, k, v, carry, **kw)
    want = fa.flash_chunk_plain(q, k, v, want, **kw)
    got = fa.flash_attention_chunk(q, k, v, carry, **kw)
    got = fa.flash_attention_chunk(q, k, v, got, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{what}: carry not exact on band inputs")
    print(f"{what}: exact on band inputs: ok")

    uniform = uniform_inputs(sq, skv, h, h_kv, dh, dtype, gen)
    shift = row_offset - col_offset if mode == "offset" else 0
    peaked = peaked_inputs(sq, skv, h, h_kv, dh, dtype, gen, shift)
    errs = []
    for name, (q, k, v) in (("uniform", uniform), ("peaked", peaked)):
        start = fa.init_flash_carry(sq, h, dh, "cuda")
        want = fa.flash_chunk_plain(q, k, v, start, **kw)
        got = fa.flash_attention_chunk(q, k, v, start, **kw)
        torch.cuda.synchronize()
        o = fa.finalize_flash_carry(got, torch.float32)
        o_p = fa.finalize_flash_carry(want, torch.float32)
        err = (o - o_p).abs()
        bound = fa.plain_gap_bound(q, k, v, o, o_p, scale=scale, n_terms=skv)
        bad = int((err > bound).sum())
        ds = fa.score_gap(q, k, scale)
        m, l, m_p, l_p = got[1], got[2], want[1], want[2]
        bad += int(((m - m_p).abs() > ds + 1e-6).sum())
        rel = 4 * ds + 2 * skv * 2.0**-23 + 2.0**-20
        bad += int(((l - l_p).abs() > rel * l_p).sum())
        max_err = float(err.max())
        if not math.isfinite(max_err) or bad:
            fail(f"{what}, {name} inputs: {bad} entries beyond their bounds, "
                 f"max |err| {max_err}")
        print(f"{what}, {name} inputs: max |err| {max_err!r} within "
              f"plain_gap_bound (median |o| "
              f"{float(o_p.abs().median())!r}), m and l within their "
              f"bounds: ok")
        errs.append(max_err)
    return max(errs), uniform, kw


def check_ring_chain(fa, s, h, dh, dtype_name):
    """Rank 3 of a four-chunk ring: the diagonal chunk, then three past
    ones, finished by ``finalize_flash_carry``, against the plain forward
    over the whole sequence at offset 3 * s, within ``plain_gap_bound``
    plus the plain forward's own rounding to the operand dtype."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = uniform_inputs(4 * s, 4 * s, h, h, dh, dtype, gen)
    q = q[3 * s:].contiguous()
    scale = dh ** -0.5
    carry = fa.init_flash_carry(s, h, dh, "cuda")
    for src in (3, 2, 1, 0):
        rows = slice(src * s, (src + 1) * s)
        carry = fa.flash_attention_chunk(
            q, k[rows].contiguous(), v[rows].contiguous(), carry, scale=scale,
            row_offset=3 * s, col_offset=src * s,
            causal="diagonal" if src == 3 else "past",
        )
    got = fa.finalize_flash_carry(carry, torch.float32)
    torch.cuda.synchronize()
    want = fa.flash_forward_plain(q, k, v, scale=scale, row_offset=3 * s)[0].float()
    bound = fa.plain_gap_bound(q, k, v, got, want, scale=scale, n_terms=4 * s)
    bound = bound + want.abs() * torch.finfo(dtype).eps
    err = (got - want).abs()
    if int((err > bound).sum()) or not math.isfinite(float(err.max())):
        fail(f"four-chunk ring chain {dtype_name}: beyond its bound, "
             f"max |err| {float(err.max())}")
    print(f"four-chunk ring chain (s={s}, h={h}, dh={dh}, {dtype_name}) + "
          f"finalize_flash_carry vs plain full attention: max |err| "
          f"{float(err.max())!r}: ok")


def time_turns(calls, iterations):
    """``cuda_ms`` of each call, in two turns run in opposite orders; the
    better of the two per call, and both turns."""
    timings = {key: [] for key in calls}
    order = list(calls)
    for turn in (order, order[::-1]):
        for key in turn:
            timings[key].append(cuda_ms(calls[key], iterations=iterations[key]))
    return {key: min(v) for key, v in timings.items()}, timings


def flash_bound(fa, sq, skv, h, h_kv, dh, itemsize, row_offset, col_offset,
                causal, window, carry):
    """(bound ms, bound_by) of one flash call at these inputs: the larger of
    4 * h * dh * (live pairs) over the bf16 peak and the bytes it must move
    (q, k, v read once; o and lse written, or the f32 carry read and
    written) over the memory rate."""
    pairs = fa.live_pairs(sq, skv, row_offset, col_offset, causal, window)
    flops = 4.0 * h * dh * pairs
    moved = (sq * h + 2 * skv * h_kv) * dh * itemsize
    if carry:
        moved += 2 * h * sq * (dh + 2) * 4
    else:
        moved += sq * h * dh * itemsize + h * sq * 4
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def kernel_phase_matmul(k1, smi):
    """K1 at every shape of its phase, then timed at the GEMM path's
    shape. Returns its entry of the ``kernels`` line (launches filled in
    later)."""
    import torch

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
    times, timings = time_turns({
        "ms": lambda: k1.matmul(a, b),
        "library_ms": lambda: torch.matmul(a, b),
        "plain_ms": lambda: k1.matmul_plain(a, b),
    }, {"ms": 20, "library_ms": 20, "plain_ms": 20})
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
    return {
        "name": "matmul",
        "route": "cuda",
        "source": "ddlb_tpu_torch/csrc/matmul.cu",
        "replaces": "ddlb_tpu/ops/matmul.py:25",
        "launches": None,
        "max_abs_err": main_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": max(bound_ops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": times["library_ms"],
    }


def kernel_phase_flash(fa, smi):
    """K8a, K8b and K9 against their plain versions (the path's shapes,
    fp16 and f32 at smaller ones, ragged shapes, the three chunk modes and
    a four-chunk chain), then each timed at the path's shape beside its
    plain version, its library call and its bound. Returns the entries of
    the ``kernels`` line for ``flash_forward`` and ``flash_chunk``."""
    import torch
    import torch.nn.functional as F

    m, h, dh = ATTN_M, ATTN_N // ATTN_K, ATTN_K
    h_kv, window = ATTN_WINDOW["n_kv_heads"], ATTN_WINDOW["window"]
    rect_rows, rect_off = m // 4, 3 * m // 4  # rank 3 of 4 after the gather
    tri_err, tri_in, tri_kw = check_flash_forward(fa, m, m, h, h, dh, "bfloat16", 0, 0)
    rect_err, rect_in, rect_kw = check_flash_forward(
        fa, rect_rows, m, h, h_kv, dh, "bfloat16", rect_off, window
    )
    # the windowed row of the path at world 1: K8b at offset 0 over the
    # whole sequence, where the band's lower edge is clamped to key 0
    path_rect_err, _, _ = check_flash_forward(
        fa, m, m, h, h_kv, dh, "bfloat16", 0, window
    )
    rect_err = max(rect_err, path_rect_err)
    for args in (
        (2048, 2048, h, h, dh, "float16", 0, 0),
        (1024, 1024, 4, 4, dh, "float32", 0, 0),
        (1024, 2048, 4, 2, dh, "float32", 1024, 700),
        (1000, 1000, h, h, dh, "bfloat16", 0, 0),
        (777, 1500, 4, 2, dh, "bfloat16", 723, 300),
        (777, 1500, 4, 2, dh, "float16", 723, 300),
        (1000, 1000, 4, 2, dh, "float16", 0, 300),
    ):
        check_flash_forward(fa, *args)
    chunk_err, chunk_in, chunk_kw = check_flash_chunk(
        fa, m, m, h, h, dh, "bfloat16", 0, 0, "diagonal", 0
    )
    for args in (
        (4096, 4096, h, h_kv, dh, "bfloat16", 12288, 8192, "past", 0),
        (4096, 4096, h, h, dh, "bfloat16", 12288, 8192, "offset", 6000),
        (1000, 700, 4, 2, dh, "float16", 900, 500, "offset", 0),
        (1024, 1024, 4, 4, dh, "float32", 0, 0, "diagonal", 300),
    ):
        check_flash_chunk(fa, *args)
    check_ring_chain(fa, 4096, h, dh, "bfloat16")

    # K8a: the causal triangle, beside SDPA with is_causal
    q, k, v = tri_in
    qt, kt, vt = (x.transpose(0, 1).contiguous()[None] for x in (q, k, v))
    tri_times, tri_turns = time_turns({
        "ms": lambda: fa.flash_forward(q, k, v, **tri_kw),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=tri_kw["scale"]),
        "plain_ms": lambda: fa.flash_forward_plain(q, k, v, **tri_kw),
    }, {"ms": 10, "library_ms": 10, "plain_ms": 1})
    tri_bound = flash_bound(fa, m, m, h, h, dh, 2, 0, 0, True, 0, carry=False)
    # K8b: offset, window and GQA, beside SDPA with the band as a boolean
    # mask over kv heads repeated to the query heads, on the keys the band
    # can reach only (the others are never live, and SDPA with a mask would
    # compute them all)
    q, k, v = rect_in
    group = h // h_kv
    lo = rect_off - window + 1
    qt = q.transpose(0, 1).contiguous()[None]
    kt, vt = (x[lo:].transpose(0, 1).repeat_interleave(group, 0).contiguous()[None]
              for x in (k, v))
    pos_q = rect_off + torch.arange(rect_rows, device="cuda")[:, None]
    pos_k = lo + torch.arange(m - lo, device="cuda")[None, :]
    band = (pos_k <= pos_q) & (pos_k > pos_q - window)
    # the yardstick computes the same function: within a loose 0.05 of the
    # plain version (SDPA rounds in its own way; this checks the slice and
    # the mask, not SDPA)
    lib_o = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, scale=rect_kw["scale"])[0].transpose(0, 1)
    lib_gap = float((lib_o.float() - fa.flash_forward_plain(
        q, k, v, **rect_kw)[0].float()).abs().max())
    if not lib_gap < 0.05:
        fail(f"SDPA on the live keys differs from the plain K8b by {lib_gap}")
    print(f"SDPA on keys [{lo}, {m}) with the band mask vs plain K8b: max "
          f"|diff| {lib_gap!r}: ok")
    del lib_o
    rect_times, rect_turns = time_turns({
        "ms": lambda: fa.flash_forward(q, k, v, **rect_kw),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, scale=rect_kw["scale"]),
        "plain_ms": lambda: fa.flash_forward_plain(q, k, v, **rect_kw),
    }, {"ms": 20, "library_ms": 20, "plain_ms": 3})
    rect_bound = flash_bound(fa, rect_rows, m, h, h_kv, dh, 2, rect_off, 0,
                             True, window, carry=False)
    del qt, kt, vt, band
    # K9: the diagonal chunk at the path's shape, folded again and again
    # into one carry in place (the time does not depend on its values)
    q, k, v = chunk_in
    carry = fa.init_flash_carry(m, h, dh, "cuda")
    chunk_times, chunk_turns = time_turns({
        "ms": lambda: fa.flash_attention_chunk(q, k, v, carry, **chunk_kw),
        "plain_ms": lambda: fa.flash_chunk_plain(q, k, v, carry, **chunk_kw),
    }, {"ms": 10, "plain_ms": 1})
    chunk_bound = flash_bound(fa, m, m, h, h, dh, 2, 0, 0, True, 0, carry=True)
    for what, times, turns, bound in (
        ("K8a triangle", tri_times, tri_turns, tri_bound),
        ("K8b offset/window/GQA", rect_times, rect_turns, rect_bound),
        ("K9 diagonal chunk", chunk_times, chunk_turns, chunk_bound),
    ):
        print(f"{what}: kernel {times['ms']!r} ms, library "
              f"{times.get('library_ms')!r} ms, plain {times['plain_ms']!r} "
              f"ms, bound {bound[0]!r} ms ({bound[1]}; {smi}); turns {turns}")

    def entry(name, replaces, err, times, bound):
        return {
            "name": name,
            "route": "cuda",
            "source": "ddlb_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": err,
            "ms": times["ms"],
            "plain_ms": times["plain_ms"],
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": times.get("library_ms"),
        }

    forward = entry("flash_forward", "ddlb_tpu/ops/flash_attention.py:373",
                    tri_err, tri_times, tri_bound)
    # the same entry point is also K8b's counterpart; its case at the
    # windowed row's shape, with its own numbers
    forward["also_replaces"] = "ddlb_tpu/ops/flash_attention.py:96"
    forward["rect"] = entry("flash_forward (rect)",
                            "ddlb_tpu/ops/flash_attention.py:96", rect_err,
                            rect_times, rect_bound)
    chunk = entry("flash_chunk", "ddlb_tpu/ops/flash_attention.py:146",
                  chunk_err, chunk_times, chunk_bound)
    chunk["library_ms_note"] = (
        "null: no single PyTorch call folds a KV chunk into a carried "
        "(acc, m, l) without normalising it"
    )
    return forward, chunk


#: K8a as the serving path calls it (sequence, query heads, kv heads), bf16:
#: the prefill of a batch of 8 at m = 8192 merges the batch into the head
#: axis (8 x 16 = 128 query heads; 32 kv heads at GQA-4), and each serve
#: admission prefills one prompt padded to its bucket, a power of two from
#: 16 (below one tile) up; the serve rows' prompts of 2048 fill theirs
SERVE_FLASH_SHAPES = (
    (8192, 128, 128), (8192, 128, 32),
    (2048, 16, 16), (2048, 16, 4),
    (16, 16, 16), (16, 16, 4),
)


def kernel_phase_flash_serving(fa, smi):
    """K8a against its plain version at the serving path's shapes (band,
    uniform and peaked inputs, as ``check_flash_forward``), then timed at
    the batch-merged prefill's shape beside SDPA with ``is_causal``, its
    plain version and its bound. Returns that case's entry."""
    import torch
    import torch.nn.functional as F

    errs = []
    for s, h, h_kv in SERVE_FLASH_SHAPES:
        err, inputs, kw = check_flash_forward(fa, s, s, h, h_kv, DECODE_DH,
                                              "bfloat16", 0, 0)
        errs.append(err)
        if (s, h, h_kv) == SERVE_FLASH_SHAPES[0]:
            (q, k, v), prefill_kw = inputs, kw
        del inputs
    m, h = q.shape[0], q.shape[1]
    qt, kt, vt = (x.transpose(0, 1).contiguous()[None] for x in (q, k, v))
    times, turns = time_turns({
        "ms": lambda: fa.flash_forward(q, k, v, **prefill_kw),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=prefill_kw["scale"]),
        "plain_ms": lambda: fa.flash_forward_plain(q, k, v, **prefill_kw),
    }, {"ms": 10, "library_ms": 10, "plain_ms": 1})
    bound = flash_bound(fa, m, m, h, h, DECODE_DH, 2, 0, 0, True, 0, carry=False)
    print(f"K8a triangle, serving prefill ({m}, {h} heads of {DECODE_DH}): "
          f"kernel {times['ms']!r} ms, library {times['library_ms']!r} ms, "
          f"plain {times['plain_ms']!r} ms, bound {bound[0]!r} ms "
          f"({bound[1]}; {smi}); turns {turns}")
    del qt, kt, vt
    torch.cuda.empty_cache()
    return {
        "name": "flash_forward (serving prefill)",
        "route": "cuda",
        "source": "ddlb_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ddlb_tpu/ops/flash_attention.py:373",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": times["library_ms"],
    }


# -- decode attention (K11, K12) ------------------------------------------------


def quantize(x):
    """Symmetric per-(position, head) int8 over the last axis, the port's
    ``models/decode.quantize_kv``."""
    import torch

    s = (x.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-30)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def decode_inputs(b, S, h, h_kv, dtype, int8, gen, peaked, pos):
    """q, K/V (int8 with scales, or the model dtype) and the dequantized
    magnitudes. Uniform [-1, 1] K/V; q uniform, or peaked: 4x the key at
    the sequence's own position (clamped to S - 1), so that key scores
    about 15 and |o| stays near max|v| however many keys are live."""
    import torch

    dh = DECODE_DH
    k = torch.rand((b, S, h_kv, dh), generator=gen, device="cuda") * 2 - 1
    v = torch.rand((b, S, h_kv, dh), generator=gen, device="cuda") * 2 - 1
    if int8:
        (k, ks), (v, vs) = quantize(k), quantize(v)
        k_deq, v_deq = (k.float() * ks).to(dtype), (v.float() * vs).to(dtype)
    else:
        k, v = k.to(dtype), v.to(dtype)
        ks = vs = None
        k_deq, v_deq = k, v
    if peaked:
        rows = k_deq[torch.arange(b, device="cuda"), pos.clamp(max=S - 1).long()]
        q = (4 * rows.float()).repeat_interleave(h // h_kv, dim=1).to(dtype)
    else:
        q = (torch.rand((b, h, dh), generator=gen, device="cuda") * 2 - 1).to(dtype)
    return (q, k, v, ks, vs, float(k_deq.float().abs().max()),
            float(v_deq.float().abs().max()))


def paged_layout(k, v, ks, vs, pos, ps, num_pages, gen):
    """The contiguous cache scattered into ``num_pages`` shuffled pool pages:
    each sequence maps the pages up to its position's (the engine's
    allocation), the rest stay the sentinel; sequence 1 maps its first
    page to sequence 0's (two slots on one page)."""
    import torch

    b, S = k.shape[:2]
    mp = S // ps
    need = [min(mp, int(p) // ps + 1) for p in pos.tolist()]
    if sum(need) > num_pages:
        fail(f"paged layout needs {sum(need)} pages > {num_pages}")
    perm = torch.randperm(num_pages, generator=gen, device="cuda").tolist()
    table = torch.full((b, mp), num_pages, dtype=torch.int32, device="cuda")
    pools = [None if x is None else
             torch.zeros((num_pages, ps) + tuple(x.shape[2:]), dtype=x.dtype, device="cuda")
             for x in (k, v, ks, vs)]
    for i in range(b):
        for j in range(need[i]):
            page = perm.pop()
            table[i, j] = page
            for pool, x in zip(pools, (k, v, ks, vs)):
                if pool is not None:
                    pool[page] = x[i, j * ps:(j + 1) * ps]
    if b > 1:
        table[1, 0] = table[0, 0]
    return pools, table


def check_decode(da, b, S, h, h_kv, dtype_name, int8, window, paged, pos_kind):
    """K11 (or K12) against its plain version on the card, on uniform and
    peaked inputs, within ``da.plain_gap_bound``; for K12 an all-sentinel
    row must give zeros. Returns (max |err|, the uniform inputs and their
    keyword arguments)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    if pos_kind == "full":
        pos = torch.full((b,), S - 1, dtype=torch.int32, device="cuda")
    else:  # ragged: 0, S (a parked lane: every key live), the rest drawn
        pos = torch.randint(0, S, (b,), generator=gen, device="cuda").to(torch.int32)
        pos[0], pos[-1] = 0, S
    what = (f"{'K12 paged' if paged else 'K11'} decode b={b} S={S} h={h}/{h_kv} "
            f"{'int8' if int8 else dtype_name} w={window} pos={pos_kind}")
    errs, first = [], None
    for name in ("uniform", "peaked"):
        q, k, v, ks, vs, kmax, vmax = decode_inputs(
            b, S, h, h_kv, dtype, int8, gen, name == "peaked", pos)
        kw = {"k_scale": ks, "v_scale": vs, "window": window}
        if paged:
            ps = PAGE_SIZE
            (k, v, kw["k_scale"], kw["v_scale"]), table = paged_layout(
                k, v, ks, vs, pos, ps, 2 * b * (S // ps), gen)
            if b > 2:
                table[2] = k.shape[0]  # an all-sentinel row
            args = (q, k, v, table, pos)
            got = da.paged_decode_attention(*args, **kw)
            torch.cuda.synchronize()
            want = da.paged_decode_attention_plain(*args, **kw)
            if b > 2 and not bool((got[2] == 0).all()):
                fail(f"{what}: the all-sentinel row is not zero")
        else:
            args = (q, k, v, pos)
            got = da.decode_attention(*args, **kw)
            torch.cuda.synchronize()
            want = da.decode_attention_plain(*args, **kw)
        err = (got.float() - want.float()).abs()
        bound = da.plain_gap_bound(q, kmax, vmax, got, want, n_terms=S)
        bad = int((err > bound).sum())
        max_err = float(err.max())
        if not math.isfinite(max_err) or bad:
            fail(f"{what}, {name} inputs: {bad} outputs beyond plain_gap_bound, "
                 f"max |err| {max_err}")
        print(f"{what}, {name} inputs: max |err| {max_err!r} within plain_gap_bound "
              f"(largest bound {float(bound.max())!r}, median |o| "
              f"{float(want.float().abs().median())!r}): ok")
        errs.append(max_err)
        if first is None:
            first = (args, kw)
    return max(errs), first


def decode_bound(da, q, k, int8, pos, S, window, table=None, num_pages=0,
                 page_size=1):
    """(bound ms, bound_by) of one K11/K12 call on these inputs: the bytes
    it must move (q read, each live key's K and V row read once with its
    scales, o written; K12 also reads the table) over the memory rate,
    against 4 * h * dh operations per live key on the f32 SIMT peak."""
    b, h, dh = q.shape
    h_kv = k.shape[2]
    live = da.live_keys(pos, S, window, table, num_pages, page_size)
    moved = 2 * b * h * dh * q.element_size()
    moved += live * 2 * h_kv * dh * k.element_size()
    if int8:
        moved += live * 2 * h_kv * 4
    if table is not None:
        moved += table.numel() * 4
    ops_ms = 4.0 * h * dh * live / PEAK_F32_FLOPS * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def kernel_phase_decode(da, smi):
    """K11 and K12 against their plain versions at the serving path's shapes
    (b = 8, 16 heads of 128; a decode cache of m + 1 = 8193 positions, the
    serve pool of 17 pages of 128), MHA and GQA-4, bf16 and int8, a window,
    ragged positions with 0 and a parked lane, sentinel pages; fp16 and f32
    at smaller shapes. Then each timed at the path's shape beside its
    plain version, its library yardstick and its bound. Returns the two
    entries of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    b, h, S = DECODE_B, DECODE_H, DECODE_S
    S_pool = SERVE_PAGES * PAGE_SIZE
    dec_err, dec_in = check_decode(da, b, S, h, h, "bfloat16", False, 0, False, "full")
    variants = {}
    for key, args in (
        ("gqa4", (b, S, h, 4, "bfloat16", False, 0, False, "full")),
        ("int8", (b, S, h, h, "bfloat16", True, 0, False, "full")),
        ("int8_gqa4", (b, S, h, 4, "bfloat16", True, 0, False, "full")),
    ):
        variants[key] = check_decode(da, *args)
    for args in (
        (b, S, h, 4, "bfloat16", False, 0, False, "ragged"),
        (b, S, h, h, "bfloat16", True, 1000, False, "ragged"),
        (4, 1000, 8, 2, "float16", False, 0, False, "ragged"),
        (4, 1000, 8, 8, "float32", True, 300, False, "ragged"),
        (3, 777, 16, 1, "bfloat16", False, 0, False, "ragged"),
    ):
        check_decode(da, *args)
    paged_err, paged_in = check_decode(da, b, S_pool, h, h, "bfloat16", False, 0, True, "ragged")
    for args in (
        (b, S_pool, h, 4, "bfloat16", True, 0, True, "ragged"),
        (b, S_pool, h, h, "bfloat16", False, 700, True, "ragged"),
        (4, 1024, 8, 2, "float32", False, 0, True, "ragged"),
    ):
        check_decode(da, *args)

    def sdpa_inputs(q, k, v, pos, group):
        """q [b, h, 1, dh] and the cache as [b, h_kv, S, dh] views, the
        boolean mask of keys <= pos."""
        live = torch.arange(k.shape[1], device="cuda")[None, :] <= pos[:, None]
        return (q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                live[:, None, None, :], group > 1)

    def timed(args, kw, paged, yardstick):
        calls = {
            "ms": lambda: (da.paged_decode_attention if paged else da.decode_attention)(*args, **kw),
            "plain_ms": lambda: (da.paged_decode_attention_plain if paged
                                 else da.decode_attention_plain)(*args, **kw),
        }
        iters = {"ms": 50, "plain_ms": 3}
        if yardstick is not None:
            calls["library_ms"] = yardstick
            iters["library_ms"] = 50
        times, turns = time_turns(calls, iters)
        times.setdefault("library_ms", None)
        return times, turns

    def k11(args, kw, int8):
        q, k, v, pos = args
        yard = None
        if not int8:
            qs, ks_, vs_, mask, gqa = sdpa_inputs(q, k, v, pos, h // k.shape[2])
            yard = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks_, vs_, attn_mask=mask, enable_gqa=gqa)
        times, turns = timed(args, kw, False, yard)
        bound = decode_bound(da, q, k, int8, pos, k.shape[1], kw["window"])
        return times, turns, bound

    dec_times, dec_turns, dec_bound = k11(*dec_in, False)
    var_out = {}
    for key, (err, (args, kw)) in variants.items():
        times, turns, bound = k11(args, kw, key.startswith("int8"))
        var_out[key] = {"max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"],
                        "library_ms": times["library_ms"], "bound_ms": bound[0],
                        "bound_by": bound[1]}
        print(f"K11 {key}: kernel {times['ms']!r} ms, library {times['library_ms']!r} ms, "
              f"plain {times['plain_ms']!r} ms, bound {bound[0]!r} ms ({bound[1]}; {smi}); "
              f"turns {turns}")

    # K12 beside the gather of every slot's pages plus the same SDPA
    (q, kp, vp, table, pos), pkw = paged_in
    P = kp.shape[0]
    mapped = ((table >= 0) & (table < P)).repeat_interleave(PAGE_SIZE, dim=1)
    safe = table.long().clamp(0, P - 1)
    live = torch.arange(S_pool, device="cuda")[None, :] <= pos[:, None]
    mask = (live & mapped)[:, None, None, :]

    def gather_sdpa():
        kk = kp[safe].reshape(b, S_pool, h, DECODE_DH).transpose(1, 2)
        vv = vp[safe].reshape(b, S_pool, h, DECODE_DH).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask)

    paged_times, paged_turns = timed((q, kp, vp, table, pos), pkw, True, gather_sdpa)
    paged_bound = decode_bound(da, q, kp, False, pos, S_pool, 0, table, P, PAGE_SIZE)
    for what, times, turns, bound in (
        ("K11 MHA bf16, 8193 keys", dec_times, dec_turns, dec_bound),
        ("K12 MHA bf16, 17 pages of 128", paged_times, paged_turns, paged_bound),
    ):
        print(f"{what}: kernel {times['ms']!r} ms, library {times['library_ms']!r} ms, "
              f"plain {times['plain_ms']!r} ms, bound {bound[0]!r} ms ({bound[1]}; "
              f"{smi}); turns {turns}")

    def entry(name, replaces, err, times, bound):
        return {
            "name": name,
            "route": "cuda",
            "source": "ddlb_tpu_torch/csrc/decode_attention.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": err,
            "ms": times["ms"],
            "plain_ms": times["plain_ms"],
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": times["library_ms"],
        }

    decode = entry("decode_attention", "ddlb_tpu/ops/decode_attention.py:116",
                   dec_err, dec_times, dec_bound)
    decode["variants"] = var_out
    decode["library_ms_note"] = (
        "SDPA, q [b, h, 1, dh], a boolean pos mask (enable_gqa for GQA); "
        "null for int8: no PyTorch call dequantizes inside attention"
    )
    paged = entry("paged_decode_attention", "ddlb_tpu/ops/decode_attention.py:236",
                  paged_err, paged_times, paged_bound)
    paged["library_ms_note"] = "the gather pool[table] plus SDPA with the live mask, timed together"
    return decode, paged


# -- the int8 GEMM (K7) -----------------------------------------------------------


#: K7's checks, bit for bit against its plain version: (m, n, k, output
#: dtype, tag of a shape that is also timed). The GEMM path's 8192^3; the
#: decode MLP's two products at batch 8 (the first into float32, before
#: the activation); the int8 prefill MLP's at m = 8192 (65,536 rows);
#: ragged and small shapes in every output dtype
INT8_CHECKS = (
    (PATH_MNK, PATH_MNK, PATH_MNK, "bfloat16", "gemm"),
    (8, 8192, 2048, "float32", "decode_w1"),
    (8, 2048, 8192, "bfloat16", "decode_w2"),
    (65536, 8192, 2048, "float32", "prefill_w1"),
    (65536, 2048, 8192, "bfloat16", "prefill_w2"),
    (1, 200, 2048, "bfloat16", None),
    (127, 200, 2048, "float16", None),
    (1000, 776, 520, "float32", None),
    (2048, 2048, 2048, "float16", None),
    (129, 131, 7, "bfloat16", None),
)
#: timed iterations of (K7, its plain version, the library call) by tag
INT8_TIMED = {
    "gemm": (20, 2, 20),
    "decode_w1": (100, 10, 0),
    "decode_w2": (100, 10, 0),
    "prefill_w1": (5, 1, 5),
}


def int8_bound(m, n, k, out_itemsize):
    """(bound ms, bound_by) of one K7 call: 2mnk int8 operations over the
    int8 tensor-core peak against the bytes it must move (both int8
    operands and both scale vectors read once, the output written once)
    over the memory rate."""
    ops_ms = 2.0 * m * n * k / PEAK_INT8_OPS * 1e3
    moved = m * k + k * n + 4 * (m + n) + m * n * out_itemsize
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def kernel_phase_int8(qm, smi):
    """K7 against ``int8_matmul_plain`` at every shape of ``INT8_CHECKS``
    (bit for bit: both sum the int8 products exactly and apply the same
    epilogue), then the tagged shapes timed beside the plain version, the
    library call (``torch._int_mm`` on a column-major weight, the layout
    the ``kernel=xla`` rows keep, plus the same epilogue: ``int8_matmul``,
    itself held bit for bit to the plain version; null where
    ``torch._int_mm`` refuses the shape) and the bound. Returns K7's entry
    of the ``kernels`` line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    timed = {}
    for m, n, k, dtype_name, tag in INT8_CHECKS:
        out_dtype = getattr(torch, dtype_name)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
        bq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
        sa = torch.rand((m, 1), generator=gen, device="cuda") * 2e-2 + 1e-4
        sb = torch.rand((1, n), generator=gen, device="cuda") * 2e-2 + 1e-4
        what = f"K7 {m}x{n}x{k} -> {dtype_name}"
        got = qm.int8_matmul_kernel(aq, bq, sa, sb, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)
        err = float((got.double() - want.double()).abs().max())
        if not torch.equal(got, want):
            fail(f"{what}: {int((got != want).sum())} elements differ from the "
                 f"plain version, max |err| {err}")
        print(f"{what}: bit for bit equal to the plain version: ok")
        del got, want
        if tag is None:
            continue
        iters, plain_iters, lib_iters = INT8_TIMED.get(tag, (0, 0, 0))
        if not iters:
            continue
        calls = {
            "ms": lambda: qm.int8_matmul_kernel(aq, bq, sa, sb, out_dtype=out_dtype),
            "plain_ms": lambda: qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype),
        }
        iterations = {"ms": iters, "plain_ms": plain_iters}
        note = None
        bq_col = bq.t().contiguous().t()
        try:
            lib = qm.int8_matmul(aq, bq_col, sa, sb, out_dtype=out_dtype)
        except RuntimeError as exc:  # the library's own shape rule
            note = f"null: torch._int_mm refuses m = {m} ({str(exc).splitlines()[0]})"
        else:
            if not torch.equal(lib, qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)):
                fail(f"{what}: the library yardstick differs from the plain version")
            del lib
            calls["library_ms"] = lambda: qm.int8_matmul(aq, bq_col, sa, sb, out_dtype=out_dtype)
            iterations["library_ms"] = lib_iters
        times, turns = time_turns(calls, iterations)
        times.setdefault("library_ms", None)
        bound = int8_bound(m, n, k, torch.empty((), dtype=out_dtype).element_size())
        print(f"K7 {tag} ({m}x{n}x{k} -> {dtype_name}): kernel {times['ms']!r} ms, "
              f"library {times['library_ms']!r} ms, plain {times['plain_ms']!r} ms, "
              f"bound {bound[0]!r} ms ({bound[1]}; {smi}); turns {turns}")
        timed[tag] = {"shape": [m, n, k], "out": dtype_name, "max_abs_err": err,
                      "ms": times["ms"],
                      "plain_ms": times["plain_ms"], "library_ms": times["library_ms"],
                      "bound_ms": bound[0], "bound_by": bound[1]}
        if note:
            timed[tag]["library_ms_note"] = note
        del aq, bq, bq_col, sa, sb, calls
        torch.cuda.empty_cache()
    main = timed.pop("gemm")
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "ddlb_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "ddlb_tpu/ops/quantized_matmul.py:154",
        "launches": None,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_ms_note": "torch._int_mm on a column-major weight plus the epilogue",
        "variants": timed,
    }


# -- the serving path -------------------------------------------------------------


#: the serving path at the full width of scripts/config_transformer_decode.json
#: (d_model 2048, d_ff 8192, 16 heads of 128, vocab 16384, batch 8, 1 layer)
SERVE_N, SERVE_K = 2048, 8192
SERVE_COMMON = {"batch": 8, "vocab": 16384, "n_heads": 16}
#: rows at m = 8192: the decode grid of scripts/config_serving_fast_decode.json
#: (its set-up prefill on flash: einsum would build 34 GB of scores), the
#: compute_only decode, a flash prefill and a 32-token generate; at m =
#: 2048: an einsum prefill and the four serve entries of
#: scripts/config_serving_paged.json. (m, implementations, warmups,
#: iterations)
SERVE_ROWS = [
    (8192, {"spmd": [{"phase": "decode", "attn_kernel": "flash",
                      "decode_kernel": ["einsum", "pallas"],
                      "kv_cache": ["bf16", "int8"], "n_kv_heads": [0, 4],
                      **SERVE_COMMON}],
            "compute_only": [{"phase": "decode", **SERVE_COMMON}]}, 2, 8),
    (8192, {"spmd": [{"phase": "prefill", "attn_kernel": "flash", **SERVE_COMMON}]}, 1, 3),
    (8192, {"spmd": [{"phase": "generate", "n_new": 32, **SERVE_COMMON}]}, 1, 2),
    (2048, {"spmd": [{"phase": "prefill", "attn_kernel": "einsum", **SERVE_COMMON}]}, 1, 3),
    (2048, {"spmd": [
        {"phase": "serve", "n_requests": 16, "n_new": 32, "attn_kernel": "flash",
         "dp": 1, "tp": 1, **SERVE_COMMON},
        {"phase": "serve", "n_requests": 16, "n_new": 32, "attn_kernel": "flash",
         "cache_layout": "paged", "page_pool_frac": [1.0, 0.5], "dp": 1, "tp": 1,
         **SERVE_COMMON},
        {"phase": "serve", "n_requests": 16, "n_new": 32, "attn_kernel": "flash",
         "kv_cache": "int8", "n_kv_heads": 4, "cache_layout": "paged",
         "page_pool_frac": [0.5], "dp": 1, "tp": 1, **SERVE_COMMON},
        {"phase": "serve", "n_requests": 16, "n_new": 32, "attn_kernel": "flash",
         "cache_layout": "paged", "page_pool_frac": [0.5], "decode_kernel": "pallas",
         "dp": 1, "tp": 1, **SERVE_COMMON},
    ]}, 1, 3),
    # the int8 MLP rows: the first entry of config_serving_fast_decode.json
    # at its m = 2048 (einsum attention, int8 cache, int8_weights) beside
    # its bf16-MLP twin; config_transformer_decode.json's int8_weights
    # decode and prefill at m = 8192; one mlp_kernel=int8 decode
    (2048, {"spmd": [{"phase": "decode", "attn_kernel": "einsum", "kv_cache": "int8",
                      "mlp_kernel": ["int8_weights", "bf16"], **SERVE_COMMON}]}, 2, 8),
    (8192, {"spmd": [{"phase": "decode", "mlp_kernel": ["int8_weights", "int8"],
                      **SERVE_COMMON}]}, 2, 8),
    (8192, {"spmd": [{"phase": "prefill", "mlp_kernel": "int8_weights",
                      **SERVE_COMMON}]}, 1, 3),
]


def expected_serving_launches(row, calls):
    """The kernel launches one serving row makes in ``calls`` measured
    calls (warmups, timed iterations, the validation run): K8a once a
    layer per flash prompt pass (the decode rows' set-up prefill, each
    prefill or generate call, each serve admission), K11 once a layer per
    pallas decode step, K12 once a layer per tick of a paged pallas
    serve row; with an int8 MLP, K7 twice a layer (the expert's two
    products; one expert block at world 1) per forward: the set-up
    prefill, every call and the memoised oracle of the validation;
    nothing else."""
    o = row_options(row)
    L, phase = int(o["layers"]), o["phase"]
    flash = o["attn_kernel"] == "flash"
    want = {"tri": 0, "rect": 0, "chunk": 0, "decode": 0, "paged": 0, "k1": 0,
            "int8": 0, **dict.fromkeys(BWD_KEYS, 0)}
    if o["mlp_kernel"] != "bf16":
        forwards = {"decode": 1 + calls + 1, "prefill": calls + 1}.get(phase)
        if forwards is None:
            fail(f"no K7 launch rule for an int8 MLP in phase={phase}")
        want["int8"] = 2 * L * forwards
    if phase == "decode":
        want["tri"] = L if flash else 0
        if o["decode_kernel"] == "pallas":
            want["decode"] = calls * L
    elif phase in ("prefill", "generate"):
        want["tri"] = calls * L if flash else 0
    elif phase == "serve":
        want["tri"] = calls * int(o["n_requests"]) * L if flash else 0
        if o["decode_kernel"] == "pallas":
            key = "paged" if o["cache_layout"] == "paged" else "decode"
            want[key] = calls * row["serve_steps"] * L
    return want


def serving_path(run_benchmark, k1, fa, da, qm, smi):
    """Drive every serving row (one ``run_benchmark`` call per row, counts
    read around each), check each row's launches exactly, and print each
    row's time, ms per step, tokens/s and share of its ``hbm_bytes()``
    floor (the row's ``hbm_bytes`` over the memory rate). Returns (the
    launch totals of the path, the rows)."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    def counts():
        return {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES}

    rows = []
    total_start = counts()
    for m, impls, warmups, iterations in SERVE_ROWS:
        for impl_id, spec in assign_impl_ids(generate_config_combinations(impls)).items():
            name = spec.pop("implementation")
            before = counts()
            (row,) = drive_path(run_benchmark, "cuda", "transformer_decode",
                                (m, SERVE_N, SERVE_K), {name: [spec]},
                                warmups=warmups, iterations=iterations,
                                extra_keys=("serve_steps", "serve_generated",
                                            "serve_occupancy", "serve_admissions_deferred",
                                            "serve_peak_pages"))
            after = counts()
            got = {key: after[key] - before[key] for key in after}
            want = expected_serving_launches(row, warmups + iterations + 1)
            if got != want:
                fail(f"serving row {row['option']}: launches {got}, expected {want}")
            o = row_options(row)
            ms = row["median time (ms)"]
            floor_ms = row["hbm_bytes"] / PEAK_BYTES_PER_S * 1e3
            phase = o["phase"]
            if phase == "decode":
                tokens, steps = int(o["batch"]), 1
            elif phase == "generate":
                tokens, steps = int(o["batch"]) * int(o["n_new"]), int(o["n_new"])
            elif phase == "serve":
                tokens, steps = row["serve_generated"], row["serve_steps"]
            else:
                tokens, steps = int(o["batch"]) * m, 1
            row["tokens_per_s"] = tokens / (ms / 1e3)
            row["ms_per_step"] = ms / steps
            row["hbm_floor_ms"] = floor_ms
            row["hbm_floor_share"] = floor_ms / ms
            print(json.dumps({"serving_row": o["phase"], "m": m, "member": name,
                              "option": row["option"], "median_ms": ms,
                              "ms_per_step": row["ms_per_step"],
                              "tokens_per_s": row["tokens_per_s"],
                              "hbm_floor_ms": floor_ms,
                              "hbm_floor_share": row["hbm_floor_share"],
                              "launches": got, "card": smi}))
            rows.append(row)
            torch.cuda.empty_cache()
    end = counts()
    return {key: end[key] - total_start[key] for key in end}, rows


# -- the flash backward (K10a-K10d) -------------------------------------------


#: K10 at the training path's shapes, bf16 (sequence, merged query heads,
#: kv heads, window): scripts/config_transformer_step.json's rows (8 heads
#: of 128 times the microbatch's 4 or 2 rows), the full-width rows (16 heads
#: times 4) and the full-width windowed row
TRAIN_BWD_SHAPES = ((2048, 32, 32, 0), (2048, 16, 16, 0), (4096, 64, 64, 0),
                    (4096, 64, 64, 1024))
#: further cases: (sq, skv, h, h_kv, row_offset, col_offset, mode, window, dtype)
BWD_EXTRA = (
    (1000, 1000, 8, 8, 0, 0, "offset", 0, "bfloat16"),      # ragged triangle
    (2048, 2048, 8, 2, 0, 0, "offset", 0, "bfloat16"),      # GQA 8/2 triangle
    (1024, 2048, 8, 2, 1024, 0, "offset", 0, "bfloat16"),   # an offset, GQA
    (1024, 1024, 8, 8, 3072, 1024, "past", 0, "bfloat16"),  # a past ring chunk
    (1024, 1024, 8, 8, 1024, 1024, "diagonal", 0, "float16"),
    (777, 1500, 4, 2, 723, 0, "offset", 300, "bfloat16"),   # ragged, window
    (1000, 1000, 8, 2, 0, 0, "offset", 256, "float16"),
    (1024, 1024, 4, 4, 0, 0, "offset", 0, "float32"),
    (700, 900, 4, 2, 650, 100, "offset", 200, "float32"),
)


def backward_forward(fa, q, k, v, row_offset, col_offset, mode, window):
    """o and lse of the span as the forward hands them to the backward (the
    plain forward, so that the check isolates the backward)."""
    scale = q.shape[2] ** -0.5
    if mode in ("past", "none"):
        return fa.flash_forward_plain(q, k, v, scale=scale, causal=False)
    rel = 0 if mode == "diagonal" else row_offset - col_offset
    return fa.flash_forward_plain(q, k, v, scale=scale, row_offset=rel, window=window)


def check_flash_backward(fa, sq, skv, h, h_kv, dtype_name, row_offset,
                         col_offset, mode, window):
    """K10 against ``flash_backward_plain`` on the card, on uniform inputs
    and on peaked ones (q = 4 k at the query's own key), each within
    ``fa.backward_gap_bound``: the score gap, the dP summation order, the
    rounding of P and dS to the operand type before the tensor-core
    products and two float32 summation orders, each scaled by the
    magnitudes the plain tile loop sums. Returns (max |err| over dq, dk,
    dv and both inputs, the uniform inputs, keyword arguments)."""
    import torch

    dtype = getattr(torch, dtype_name)
    dh = DECODE_DH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    kw = {"scale": dh ** -0.5, "row_offset": row_offset, "col_offset": col_offset,
          "causal": mode, "window": window}
    what = (f"flash backward {mode} {sq}x{skv} h={h}/{h_kv} "
            f"off={row_offset}/{col_offset} w={window} {dtype_name}")
    uniform = uniform_inputs(sq, skv, h, h_kv, dh, dtype, gen)
    peaked = peaked_inputs(sq, skv, h, h_kv, dh, dtype, gen, row_offset - col_offset)
    do = (torch.rand((sq, h, dh), generator=gen, device="cuda") * 2 - 1).to(dtype)
    errs, first = [], None
    for name, (q, k, v) in (("uniform", uniform), ("peaked", peaked)):
        o, lse = backward_forward(fa, q, k, v, row_offset, col_offset, mode, window)
        got = fa.flash_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = fa.flash_backward_plain(q, k, v, o, lse, do, **kw)
        bounds = fa.backward_gap_bound(q, k, v, o, lse, do, want, **kw)
        parts = []
        for grad, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
            err = (g - w).abs()
            bad = int((err > b).sum())
            max_err = float(err.max())
            if not math.isfinite(max_err) or bad:
                fail(f"{what}, {name} inputs: {bad} entries of {grad} beyond "
                     f"backward_gap_bound, max |err| {max_err}")
            loose = float((w.abs() < b).float().mean())
            parts.append(f"{grad} max |err| {max_err!r} (largest bound "
                         f"{float(b.max())!r}, median |{grad}| "
                         f"{float(w.abs().median())!r}, share below its bound {loose!r})")
            errs.append(max_err)
        print(f"{what}, {name} inputs: " + "; ".join(parts) + ": ok")
        if first is None:
            first = (q, k, v, o, lse, do)
        del got, want, bounds
    return max(errs), first, kw


def backward_bound(fa, sq, skv, h, h_kv, dh, itemsize, row_offset, col_offset,
                   mode, window, pass_):
    """(bound ms, bound_by) of one backward pass at these inputs: 6 dh
    (dQ: S, dP, dS K) or 8 dh (dK/dV: S, dP, P^T dO, dS^T Q) operations per
    live pair and query head over the bf16 peak (the f32 SIMT peak for
    float32), against the bytes it must move (q, k, v, dO read once, lse and
    delta read once, dq or dk and dv written in float32) over the memory
    rate."""
    if mode in ("past", "none"):
        pairs = sq * skv
    else:
        rel = 0 if mode == "diagonal" else row_offset - col_offset
        pairs = fa.live_pairs(sq, skv, rel, 0, True, window)
    ops = (6 if pass_ == "dq" else 8) * dh * pairs * h
    moved = (2 * sq * h + 2 * skv * h_kv) * dh * itemsize + 2 * h * sq * 4
    moved += sq * h * dh * 4 if pass_ == "dq" else 2 * skv * h_kv * dh * 4
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    ops_ms = ops / peak * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def time_backward(fa, inputs, kw, smi, what):
    """Each pass timed with CUDA events beside the plain backward (both
    passes) and SDPA's backward, taken as SDPA forward plus backward through
    autograd less SDPA forward, causal (``is_causal``) or with the band as
    a boolean mask. Returns ({pass: ms}, plain ms, library ms or None, note)."""
    import torch
    import torch.nn.functional as F

    q, k, v, o, lse, do = inputs
    sq, h, dh = q.shape
    skv, h_kv = k.shape[0], k.shape[1]
    delta = fa.attention_delta(o, do)
    dq = torch.empty((sq, h, dh), dtype=torch.float32, device="cuda")
    dk = torch.empty((skv, h_kv, dh), dtype=torch.float32, device="cuda")
    dv = torch.empty_like(dk)
    group = h // h_kv
    qt = q.transpose(0, 1).contiguous()[None].requires_grad_(True)
    kt, vt = (x.transpose(0, 1).repeat_interleave(group, 0).contiguous()[None]
              .requires_grad_(True) for x in (k, v))
    dot = do.transpose(0, 1).contiguous()[None]
    sdpa_kw = {"scale": kw["scale"]}
    if kw["window"]:
        pos_q = kw["row_offset"] + torch.arange(sq, device="cuda")[:, None]
        pos_k = kw["col_offset"] + torch.arange(skv, device="cuda")[None, :]
        sdpa_kw["attn_mask"] = (pos_k <= pos_q) & (pos_k > pos_q - kw["window"])
        note = "SDPA with the band as a boolean mask"
    else:
        sdpa_kw["is_causal"] = True
        note = "SDPA with is_causal"
    note += ("; forward plus backward through autograd less the forward; it "
             "computes dq, dk and dv together, so it stands beside the dQ "
             "pass and compares with the sum of both passes")

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    calls = {
        "dq": lambda: fa.backward_pass("dq", q, k, v, do, lse, delta, (dq,), **kw),
        "dkv": lambda: fa.backward_pass("dkv", q, k, v, do, lse, delta, (dk, dv), **kw),
        "plain": lambda: fa.flash_backward_plain(q, k, v, o, lse, do, **kw),
        "sdpa_fwd": sdpa_fwd,
        "sdpa_fwd_bwd": sdpa_fwd_bwd,
    }
    iterations = {"dq": 10, "dkv": 10, "plain": 1, "sdpa_fwd": 10, "sdpa_fwd_bwd": 10}
    try:
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)
    except RuntimeError as exc:  # the yardstick only: no SDPA backend took it
        note = f"null: SDPA's backward refused these inputs ({str(exc).splitlines()[0]})"
        del calls["sdpa_fwd"], calls["sdpa_fwd_bwd"]
    times, turns = time_turns(calls, iterations)
    library = None
    if "sdpa_fwd" in times:
        library = times["sdpa_fwd_bwd"] - times["sdpa_fwd"]
    print(f"{what}: dQ pass {times['dq']!r} ms, dK/dV pass {times['dkv']!r} ms, "
          f"plain (both) {times['plain']!r} ms, SDPA backward {library!r} ms "
          f"({smi}); turns {turns}")
    del qt, kt, vt, dot, sdpa_kw
    return {"dq": times["dq"], "dkv": times["dkv"]}, times["plain"], library, note


def kernel_phase_flash_backward(fa, smi):
    """K10a-K10d against ``flash_backward_plain`` at the training path's
    shapes and at the cases of ``BWD_EXTRA`` (ragged shapes, GQA 8/2, an
    offset, a past and a diagonal chunk, windows, fp16 and f32), each on
    uniform and peaked inputs; then each pass timed at the full-width
    shape (the triangle) and at the windowed row's (the rectangle) beside
    its bound, the plain version and SDPA's backward. Returns the four
    entries of the ``kernels`` line."""
    import torch

    dh = DECODE_DH
    errs, timed_inputs = {"tri": [], "rect": []}, {}
    for s, h, h_kv, window in TRAIN_BWD_SHAPES:
        case = "rect" if window else "tri"
        err, inputs, kw = check_flash_backward(fa, s, s, h, h_kv, "bfloat16", 0, 0,
                                               "offset", window)
        errs[case].append(err)
        if s == 4096:
            timed_inputs[case] = (inputs, kw)
        del inputs
        torch.cuda.empty_cache()
    for sq, skv, h, h_kv, ro, co, mode, window, dtype_name in BWD_EXTRA:
        case, _, _ = fa.backward_case(sq, skv, ro, co, mode, window)
        err, _, _ = check_flash_backward(fa, sq, skv, h, h_kv, dtype_name, ro, co,
                                         mode, window)
        errs[case].append(err)
    entries = []
    for case, (dq_line, dkv_line) in (("tri", (706, 741)), ("rect", (624, 664))):
        inputs, kw = timed_inputs[case]
        q, k = inputs[0], inputs[1]
        what = (f"K10{'a/b' if case == 'tri' else 'c/d'} {case} at {q.shape[0]} x "
                f"{q.shape[1]} heads of {dh}, window {kw['window']}")
        times, plain_ms, library_ms, note = time_backward(fa, inputs, kw, smi, what)
        for pass_, line in (("dq", dq_line), ("dkv", dkv_line)):
            bound = backward_bound(fa, q.shape[0], k.shape[0], q.shape[1], k.shape[1],
                                   dh, 2, 0, 0, "offset", kw["window"], pass_)
            print(f"{what} {pass_}: bound {bound[0]!r} ms ({bound[1]}; {smi})")
            entry = {
                "name": f"flash_backward_{pass_}" + (" (rect)" if case == "rect" else ""),
                "route": "cuda",
                "source": "ddlb_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"ddlb_tpu/ops/flash_attention.py:{line}",
                "launches": None,
                "max_abs_err": max(errs[case]),
                "ms": times[pass_],
                "plain_ms": plain_ms,
                "bound_ms": bound[0],
                "bound_by": bound[1],
                "library_ms": library_ms if pass_ == "dq" else None,
                "plain_ms_note": "flash_backward_plain, both passes",
                "library_ms_note": note if pass_ == "dq" else (
                    "null: SDPA's backward stands beside the dQ pass of the same case"),
            }
            entries.append(entry)
        del inputs
        timed_inputs[case] = None
        torch.cuda.empty_cache()
    return entries


# -- the training path --------------------------------------------------------------


#: the training path's rows, each (shape, implementations, warmups,
#: iterations): scripts/config_transformer_step.json's spmd and compute_only
#: entries as shipped (its xla_gspmd entry is not ported); the full width
#: of scripts/config_router.json's first entry with router=block (train and
#: its forward twin, then train with attn_window=1024); one
#: mlp_kernel=int8 train row at the first config's shape
TRAIN_CONFIG = os.path.join("scripts", "config_transformer_step.json")
ROUTER_CONFIG = os.path.join("scripts", "config_router.json")
TRAIN_WARMUPS, TRAIN_ITERATIONS = 1, 3


def training_rows():
    with open(TRAIN_CONFIG) as f:
        cfg = json.load(f)["benchmark"]
    shape = (cfg["m"][0], cfg["n"][0], cfg["k"][0])
    impls = {name: blocks for name, blocks in cfg["implementations"].items()
             if name in ("spmd", "compute_only")}
    spmd = impls["spmd"][0]
    with open(ROUTER_CONFIG) as f:
        router = json.load(f)["benchmark"]
    wide_shape = (router["m"][0], router["n"][0], router["k"][0])
    wide = {key: value for key, value in router["implementations"][0].items()
            if key != "name"}
    wide.update(router=["block"], mode=["train", "forward"])
    windowed = dict(wide, mode=["train"], attn_window=[1024])
    int8 = {key: value for key, value in spmd.items()}
    int8.update(microbatches=[2], attention=["gathered"], mlp_kernel=["int8"])
    return [
        (shape, impls),
        (wide_shape, {"spmd": [wide]}),
        (wide_shape, {"spmd": [windowed]}),
        (shape, {"spmd": [int8]}),
    ]


def expected_training_launches(row, calls):
    """The kernel launches one training row makes in ``calls`` measured
    calls at world 1 (one stage, so each of the ``microbatches`` ticks runs
    every layer once): per layer and tick, the flash forward (K8a, or K8b
    under a window that cuts the band, or K9 under ring attention) once in
    the forward and once more when the backward recomputes the stage
    (``torch.utils.checkpoint``), and each backward pass once (K10a/K10b,
    or K10c/K10d under a window); an int8 MLP runs K7 twice a layer and
    tick in each of the two forwards, and twice a layer and microbatch in
    the row's one oracle loss. compute_only rows launch nothing."""
    o = row_options(row)
    want = {"tri": 0, "rect": 0, "chunk": 0, "decode": 0, "paged": 0, "k1": 0,
            "int8": 0, **dict.fromkeys(BWD_KEYS, 0)}
    if row["base_implementation"] == "compute_only":
        if o["mlp_kernel"] != "bf16":
            fail("no launch rule for a compute_only row with an int8 MLP")
        return want
    L, mb = int(o["layers_per_stage"]), int(o["microbatches"])
    train = o["mode"] == "train"
    passes = 2 if train else 1
    per_call = mb * L * calls
    window = int(o["attn_window"])
    if o["attention"] == "ring":
        windowed, forward = window > 0, "chunk"
    else:
        windowed = 0 < window < row["m"]
        forward = "rect" if windowed else "tri"
    if o["attn_kernel"] == "flash":
        want[forward] = passes * per_call
        if train:
            case = "rect" if windowed else "tri"
            want[f"bwd_dq_{case}"] = want[f"bwd_dkv_{case}"] = per_call
    if o["mlp_kernel"] == "int8":
        want["int8"] = 2 * passes * per_call + 2 * L * mb
    return want


def training_path(run_benchmark, k1, fa, da, qm, smi):
    """Drive every training row (one ``run_benchmark`` call per row, counts
    read around each), check each row's launches exactly, and print each
    row's ms per step, tokens/s and model-FLOPs utilisation (``flops()``
    over the time at the bf16 peak). Returns the launch totals of the
    path."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    def counts():
        return {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES}

    total_start = counts()
    for shape, impls in training_rows():
        for impl_id, spec in assign_impl_ids(generate_config_combinations(impls)).items():
            name = spec.pop("implementation")
            before = counts()
            (row,) = drive_path(run_benchmark, "cuda", "transformer_step", shape,
                                {name: [spec]}, warmups=TRAIN_WARMUPS,
                                iterations=TRAIN_ITERATIONS)
            after = counts()
            got = {key: after[key] - before[key] for key in after}
            want = expected_training_launches(
                row, TRAIN_WARMUPS + TRAIN_ITERATIONS + 1)
            if got != want:
                fail(f"training row {name} {row['option']}: launches {got}, "
                     f"expected {want}")
            o = row_options(row)
            ms = row["median time (ms)"]
            tokens = int(o["batch"]) * row["m"]
            print(json.dumps({
                "training_row": o["mode"], "member": name, "shape": list(shape),
                "option": row["option"], "ms_per_step": ms,
                "tokens_per_s": tokens / (ms / 1e3),
                "tflops": row["Throughput (TFLOPS)"],
                "mfu": row["Throughput (TFLOPS)"] * 1e12 / PEAK_BF16_FLOPS,
                "launches": {key: n for key, n in got.items() if n}, "card": smi,
            }))
            torch.cuda.empty_cache()
    end = counts()
    return {key: end[key] - total_start[key] for key in end}


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
        from ddlb_tpu_torch.ops import decode_attention as da
        from ddlb_tpu_torch.ops import flash_attention as fa
        from ddlb_tpu_torch.ops import matmul as k1
        from ddlb_tpu_torch.ops import quantized_matmul as qm
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repo ({exc})")
    # the port under test is the checkout's, never an installed copy
    if not os.path.abspath(ddlb_tpu_torch.__file__).startswith(here + os.sep):
        fail(f"ddlb_tpu_torch imported from {ddlb_tpu_torch.__file__}, not {here}")
    t_start = time.perf_counter()

    # 1. the card
    smi = card_identity()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernels: build (one nvcc each, in parallel), check, time
    libs = ("matmul", "flash_attention", "decode_attention", "quantized_matmul")
    t0 = time.perf_counter()
    _build.build(*libs)
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas ({name}):", line.strip())
    matmul_entry = kernel_phase_matmul(k1, smi)
    forward_entry, chunk_entry = kernel_phase_flash(fa, smi)
    forward_entry["serving_prefill"] = kernel_phase_flash_serving(fa, smi)
    decode_entry, paged_entry = kernel_phase_decode(da, smi)
    int8_entry = kernel_phase_int8(qm, smi)
    torch.cuda.empty_cache()
    backward_entries = kernel_phase_flash_backward(fa, smi)
    torch.cuda.empty_cache()
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    def reset():
        k1.LAUNCHES = 0
        qm.LAUNCHES = 0
        fa.reset_launches()
        da.reset_launches()

    # 3. the main paths, each with the counts zeroed just before it
    launches = {}
    reset()
    rows = []
    for primitive, implementations in GEMM_SWEEPS.items():
        rows += drive_path(run_benchmark, "cuda", primitive,
                           (PATH_MNK, PATH_MNK, PATH_MNK), implementations)
    gemm_launches, others = k1.LAUNCHES, {**fa.LAUNCHES, **da.LAUNCHES,
                                          "int8": qm.LAUNCHES}
    cuda_rows = sum(1 for r in rows if r["base_implementation"] == "cuda")
    # each cuda row runs K1 once per warmup, per timed iteration and for
    # validation; no other row may launch it
    expected = cuda_rows * (NUM_WARMUPS + NUM_ITERATIONS + 1)
    if gemm_launches != expected or gemm_launches == 0:
        fail(f"K1 launched {gemm_launches} times on the GEMM path, expected {expected}")
    if any(others.values()):
        fail(f"other kernels launched on the GEMM path: {others}")
    launches["gemm"] = {"k1": gemm_launches}
    print(f"GEMM path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    rows = []
    for primitive, implementations in QUANT_SWEEPS.items():
        rows += drive_path(run_benchmark, "cuda", primitive,
                           (PATH_MNK, PATH_MNK, PATH_MNK), implementations)
        torch.cuda.empty_cache()
    int8_launches = qm.LAUNCHES
    others = {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES}
    # each kernel=pallas row runs K7 once per warmup, per timed iteration
    # and for validation; no kernel=xla row and no other member may
    # launch it
    pallas_rows = sum(1 for r in rows if r["base_implementation"] == "quantized"
                      and row_options(r)["kernel"] == "pallas")
    expected = pallas_rows * (NUM_WARMUPS + NUM_ITERATIONS + 1)
    if int8_launches != expected or int8_launches == 0:
        fail(f"K7 launched {int8_launches} times on the quantized path, expected {expected}")
    if any(others.values()):
        fail(f"other kernels launched on the quantized path: {others}")
    launches["quantized"] = {"int8": int8_launches}
    print(f"quantized path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    rows = []
    for implementations in ATTN_SWEEPS:
        rows += drive_path(run_benchmark, "cuda", "cp_ring_attention",
                           (ATTN_M, ATTN_N, ATTN_K), implementations)
        torch.cuda.empty_cache()
    flash_launches = dict(fa.LAUNCHES)
    others = {**da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES}
    expected = expected_flash_launches(rows)
    if flash_launches != expected or not all(
            flash_launches[key] for key in ("tri", "rect", "chunk")):
        fail(f"flash kernels launched {flash_launches} on the attention "
             f"path, expected {expected}")
    if any(others.values()):
        fail(f"K1, K7 or the decode kernels launched on the attention path: {others}")
    launches["attention"] = flash_launches
    print(f"attention path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    serving_launches, _ = serving_path(run_benchmark, k1, fa, da, qm, smi)
    if not (serving_launches["decode"] and serving_launches["paged"]
            and serving_launches["tri"] and serving_launches["int8"]):
        fail(f"the serving path did not launch K11, K12, K8a and K7: {serving_launches}")
    launches["serving"] = serving_launches
    print(f"serving path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    training_launches = training_path(run_benchmark, k1, fa, da, qm, smi)
    missing = [key for key in ("tri", "rect", "chunk", "int8", *BWD_KEYS)
               if not training_launches[key]]
    if missing:
        fail(f"the training path did not launch {missing}: {training_launches}")
    launches["training"] = training_launches
    print(f"training path done at {time.perf_counter() - t_start:.1f} s")
    print(f"launches by path: {json.dumps(launches)}")

    # 4. results
    def total(key):
        return sum(path.get(key, 0) for path in launches.values())

    matmul_entry["launches"] = total("k1")
    forward_entry["launches"] = total("tri") + total("rect")
    forward_entry["rect"]["launches"] = total("rect")
    forward_entry["serving_prefill"]["launches"] = serving_launches["tri"]
    chunk_entry["launches"] = total("chunk")
    decode_entry["launches"] = total("decode")
    paged_entry["launches"] = total("paged")
    int8_entry["launches"] = total("int8")
    int8_entry["launches_by_path"] = {
        "quantized": launches["quantized"]["int8"], "serving": serving_launches["int8"],
        "training": training_launches["int8"],
    }
    for entry, key in zip(backward_entries, BWD_KEYS):
        entry["launches"] = total(key)
    print(json.dumps({"kernels": [matmul_entry, forward_entry, chunk_entry,
                                  decode_entry, paged_entry, int8_entry,
                                  *backward_entries]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
