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
   (``library_ms``) and its bound: K1 (the tiled GEMM, each case on the
   tile its widths choose: the Hopper ``wgmma`` tile, ``wmma`` or
   ``simt``), K8a/K8b (the flash forward, triangle and rectangle, at the
   attention path's shapes and at the serving path's prefill and admission
   shapes; the triangle in bf16/fp16 on the ``wgmma`` kernel, the
   rectangle on the ``band`` kernel, ragged, GQA, not causal and empty-band
   cases included), K9 (the carried-chunk fold on the ``band`` kernel, its
   three modes, a windowed diagonal and an empty band, timed beside SDPA
   with ``is_causal`` on the same attention; the ``band`` instantiations'
   ``ptxas`` registers, no spill and no C7512 warning), K11 and K12
   (single-token decode attention,
   contiguous and paged), K7 (the int8 GEMM, bit for bit at the GEMM
   path's 8192^3, the decode and prefill MLP's shapes and ragged ones,
   each output dtype, on a column-major and a row-major weight, each call
   on the tile its layout and widths choose: ``wgmma``, ``small_m`` or
   ``mma``, counted in ``TILES``; the decode shapes timed also from a
   CUDA graph and beside ``torch._int_mm`` on A padded to 32 rows),
   K10a-K10d (the flash backward's dQ and dK/dV
   passes, triangle and rectangle, within ``backward_gap_bound`` at the
   training path's shapes and ragged, GQA, offset, past, none, diagonal
   and windowed cases, edges across key tiles and empty bands; in
   bf16/fp16 the triangle on the Hopper ``wgmma`` passes (``tri_bwd``) and
   the rectangle on the Hopper ``band`` passes (``band_bwd``), each call
   counted by kernel, the ``ptxas`` registers of both, no spill and no
   C7512 warning; each pass timed beside SDPA's backward, the rectangle at
   the windowed training row and at a ``past`` ring chunk, where SDPA's
   unmasked backward computes the same three gradients), K2 and K3 (the
   ring collective matmuls) in loopback, d virtual ranks in one launch on
   the card, at d = 2, 3 and 4 (the GEMM path's per-rank shapes at d = 4,
   ragged cases, fp16 and f32, each on the tile its widths choose and
   counted by tile), bit for bit on integer operands and within their
   bounds against the one-process plain ring, timed at d = 4; K4 and
   K5 (the pure ring all-gather and reduce-scatter) and K6 (the fused MoE
   all-to-all expert GEMM) in loopback at d = 2, 3 and 4 (the collectives
   and ep paths' per-rank shapes at d = 4, a ragged case, fp16 and f32):
   K4/K5 bit for bit on integer, dyadic and uniform operands, K6 bit for bit
   on integer and dyadic ones and within K1's bound on uniform ones, each
   timed at d = 4 beside ``torch.cat``, ``torch.stack(...).sum(0)`` and
   ``torch.bmm``; and K2-K6 once more at d = 4 on a peer table in the
   ``transport=dcn`` order of two simulated nodes (``DCN_ORDER``, ring
   position p addressing rank ``[0, 2, 1, 3][p]``'s buffer), bit for bit on
   integer operands against the plain ring (in loopback every virtual rank
   is on this card, so this shows that the kernels address peers only
   through the table; the reordered ring across cards is checked by
   ``scripts/topology_sweeps.py`` on four cards);
3. the main paths, each with the launch counts zeroed just before it and
   read just after, through the port's sweep runner (``run_benchmark``)
   with validation: both tensor-parallel families at m = n = k = 8192 bf16,
   every member (K1 in the ``cuda`` rows, K2 or K3 in the ``cuda;
   algorithm=ring_rdma`` rows, every ``overlap`` entry of
   ``scripts/config.json`` and ``config_tp_rowwise.json``); then the quantized path at the
   same shape (``scripts/config_quantized.json``'s ``kernel`` x
   ``quantize`` grid of every family's ``quantized`` member, and the
   ``compute_only`` and ``pytorch`` members of ``dp_allreduce`` and
   ``ep_alltoall``; K7 in the ``kernel=pallas`` rows); then the collective
   trio's path, one row at a time with its launches checked exactly:
   ``scripts/config_collectives.json``'s members the port carries
   (``compute_only``, ``jax_spmd`` as ``pytorch``, ``pallas`` as ``cuda``:
   K4, K5, both for ``all_reduce``) at both its shapes, m = 8192 and 65536,
   n = 8, k = 8192 bf16, in GB/s; then ``ep_alltoall`` and
   ``dp_allreduce`` at 8192^3 bf16, the ``cuda`` member's two algorithms
   (K1; K6 or K3) and every ``overlap`` entry of their configs; then
   the topology path at world 1, one row at a time with its launches
   checked exactly (``topology_rows``: the ``transport=dcn`` entries of
   ``scripts/config_transport_sweep.json`` and the ``cuda`` member of both
   tp families under ``dcn``, K1; then the composed entries,
   ``jax_spmd_hier`` and ``jax_spmd_striped`` as ``pytorch_hier`` and
   ``pytorch_striped``, of ``config_dp_allreduce.json``,
   ``config_ep_alltoall.json`` and ``config_collectives.json`` at their
   first shapes, each row's ``composition`` checked), its time printed; then
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
   the speculate path (``scripts/config_speculate.json``'s entries at
   m = 2048: the ``generate`` twin, ``phase=speculate`` at spec_k 2, 4,
   8 and with the int8 GQA-4 cache; spec_k 4 at m = 8192 on the flash
   prefill and pallas draft steps; K8a ``layers + draft_layers`` a call,
   K11 ``draft_layers * (spec_k + 1) * spec_rounds``), each row's tokens
   then held against its generate twin's chain (exact but at near-ties of
   the oracle); then the serving_load path
   (``scripts/config_serving_load.json``'s ``engine`` and ``static``
   entries as written, and both members at the serving width, m = 512,
   48 requests, a paged pool of half size, a shared 256-token prefix,
   20 and 400 requests/s, the engine also with head-of-line preemption;
   K12 once a layer per engine tick, K8a once a layer per prompt
   prefill), each row's TTFT and TPOT percentiles and goodput printed;
   then the serving_cluster path (the config's ``router`` and ``disagg``
   entries as written, then at the same width and traffic, every engine on
   the one card: ``router`` dp 2 at 20 and 400 requests/s and behind a
   token bucket at the card's census rate, ``disagg`` p1+d1 at 20 and 400
   and p2+d1 with elastic pools at 400; K12 once a layer per decode tick
   and K8a once a layer per prompt prefill of every engine, the set-up
   probes' included), each row's TTFT and TPOT percentiles, goodput,
   topology, handoffs and their price, rejections and resizes printed.
   These rows run the cluster's multi-controller drive at world 1, where
   every exchange is the identity; its world > 1 evidence is the
   four-card run of ``scripts/serving_cluster_cards.py`` (router dp 2 and
   dp 4, disagg p1+d1, each rank's launches exact for its own engines),
   recorded in ``PERF.md``;
   then the training path, ``transformer_step`` one row at a time
   (``training_rows``: ``scripts/config_transformer_step.json``'s ``spmd``
   and ``compute_only`` entries, the full width of
   ``scripts/config_router.json``'s first entry with the block router,
   train and forward, the same train with ``attn_window=1024``, an
   ``mlp_kernel=int8`` train row, and the pipeline schedules:
   ``config_router.json``'s second entry as shipped (``schedule`` gpipe
   and 1f1b) and the same at ``virtual=2`` (gpipe and interleaved, the
   table executor); K8a, K8b, K9, K10a-K10d, K7), with each row's ms per
   step, tokens/s, model-FLOPs utilisation and peak memory, and the
   schedules' step memory beside their gpipe twins' (``schedule_memory``);
   then the router path (``router_rows``: at the same full width, one
   expert on one card, ``spmd`` train with ``router=topk`` at capacity
   factor 1.25 and 0.5, with ``expert_choice``, with ``topk`` under
   ``schedule=1f1b``, and the ``mlp_kernel=int8_weights`` forward; the
   ``compiled`` member's int8 rows: ``transformer_step`` ``int8`` train and
   ``int8_weights`` forward, ``transformer_decode`` ``int8`` and
   ``int8_weights`` decode, K7 launched and counted through its
   ``torch.library`` operators; K8a, K10a/K10b, K7), one row at a time
   with its launches checked exactly;
   then the pipeline path, ``scripts/config_pp_pipeline.json`` and
   ``config_schedules.json`` as shipped (every ``pp_pipeline`` member: the
   chain of ``torch.matmul`` products launches no hand kernel, and the
   path's counts must stay 0), with each ``schedules`` row's bubble
   fraction and stash slots from its tables. Every row must
   be valid with a finite time, and the counts must be exactly what the
   rows launch, every K1, K2 and K3 launch of every path on the Hopper
   tile, every K8a launch on the ``wgmma`` forward, every K8b and K9
   launch on the ``band`` forward, every
   K10a/K10b pass on the ``wgmma`` backward and every K10c/K10d pass on
   the ``band`` backward
   (``check_tiles``), and every K7 launch on ``wgmma`` (8192^3, the
   prompt passes, training) or ``small_m`` (the decode steps), none on
   ``mma``;
   then the LM head's product before and after it moved to the tensor
   cores (``head_phase``: the full-width train row and a pallas
   decode row, each with the old float32 head and the new one);
   then the telemetry phase (``telemetry_phase``, in a process of its
   own with ``DDLB_TPU_TRACE`` set): a ``tp_columnwise`` ``cuda`` row at
   4096^3 bf16 (K1) and a ``serving_load`` ``engine`` row at the serving
   width (K8a, K12) with ``profile_dir`` set, each checked against its
   trace (one ``worker.row`` span with its phases nested, a barrier span
   and exchange instant per barrier, the drains' ``serve.ticks`` against
   the tick metric, the merged ``trace.json``), its telemetry columns,
   and the profiler's kernel events against the launch counters' rise
   over the window; then the tp row with tracing off and on in turns.
   The ``compiled`` member (the JAX package's ``xla_gspmd``: DTensor
   placements under ``torch.compile``) rides those paths with its knobs at
   their defaults: both tp families and ``dp_allreduce``/``ep_alltoall`` at
   8192^3, the collectives config's ``xla_gspmd`` entry at both shapes,
   decode and prefill at m = 2048 on the serving path, and on the
   training path ``config_transformer_step.json``'s ``xla_gspmd`` entry as
   shipped and a full-width train row (einsum attention). Its rows
   launch no hand kernel; each must be valid;
4. a ``compiled_rows`` JSON line (each compiled row's median, its first
   call's seconds and Dynamo graph count), one ``kernels`` JSON line, then
   the last line
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
#: the speculate path's caches at m = 8192 (m + n_new 64 + spec_k 4) and
#: the serving_load path's pages a slot (its max_len of 1408 over 128)
SPEC_S, SERVING_LOAD_PAGES = 8260, 11
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


def ptxas_registers(library, kernel):
    """``ptxas -v``'s registers and spill stores of each instantiation of
    ``kernel`` in a library's build log, keyed by its operand dtype."""
    from ddlb_tpu_torch.ops import _build

    found = {}
    for name, usage in _build.ptxas_usage(_build.build_log(library)).items():
        if kernel in name:
            dtype = ("bfloat16" if "bfloat16" in name else "float16" if "__half" in name
                     else "float32")
            found[dtype] = usage
    return found


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


def overlap_entries(config):
    """The ``overlap`` entries of one of the repo's GEMM sweep configs."""
    with open(os.path.join("scripts", config)) as f:
        return json.load(f)["benchmark"]["implementations"]["overlap"]


#: every member of both families, each option of the sweep: the cuda
#: member's two algorithms (K1; K2 or K3), every overlap entry of
#: scripts/config.json and scripts/config_tp_rowwise.json, and the
#: compiled member (their xla_gspmd) with its knobs at their defaults
GEMM_SWEEPS = {
    "tp_columnwise": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{"order": ["AG_before", "AG_after"]}],
        "cuda": [{"order": ["AG_before", "AG_after"]}, {"algorithm": ["ring_rdma"]}],
        "overlap": overlap_entries("config.json"),
        "compiled": [{}],
    },
    "tp_rowwise": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{}],
        "cuda": [{}, {"algorithm": ["ring_rdma"]}],
        "overlap": overlap_entries("config_tp_rowwise.json"),
        "compiled": [{}],
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
        "compiled": [{}],
    },
    "ep_alltoall": {
        "compute_only": [{"size": ["sharded", "unsharded"]}],
        "pytorch": [{}],
        "quantized": [QUANT_GRID],
        "compiled": [{}],
    },
}

#: the compiled rows the paths drove: (primitive, shape, option, median ms,
#: first call's seconds, Dynamo graphs), printed before the kernels line
COMPILED_ROWS = []
#: the columns a compiled row adds: its first call (trace, compile, one
#: run) and the graphs Dynamo captured in it
COMPILE_KEYS = ("compile_s", "dynamo_graphs")

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
               warmups=NUM_WARMUPS, iterations=NUM_ITERATIONS, extra_keys=(),
               dtype="bfloat16"):
    """The port's sweep runner over one family at ``shape`` in ``dtype``
    with validation; prints every row (with ``extra_keys`` where present)
    and fails unless each is valid on ``device`` with a finite time.
    Returns the rows."""
    os.makedirs(OUT_DIR, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    m, n, k = shape
    t0 = time.perf_counter()
    rows = run_benchmark({
        "primitive": primitive,
        "m": m,
        "n": n,
        "k": k,
        "dtype": dtype,
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
            *COMPILE_KEYS, *extra_keys,
        ) if key in row}))
        if row["base_implementation"] == "compiled":
            COMPILED_ROWS.append({
                "primitive": primitive, "shape": [m, n, k], "option": row["option"],
                "median_ms": row["median time (ms)"], "valid": row["valid"],
                **{key: row.get(key) for key in COMPILE_KEYS}})
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
                        window, causal=True):
    """K8a/K8b against ``flash_forward_plain`` on the card: bit for bit on
    band inputs; on uniform [-1, 1] inputs and on peaked ones (q aligned
    with the key at the query's own position) the output within
    ``fa.plain_gap_bound`` and lse within ``4*Δs + 2*skv*2**-23 + 1e-5``
    (the score gap and two summation orders of l; empty rows exactly
    NEG_INF on both); each of the three launches on the kernel
    ``fa.forward_kernel`` names (``FORWARD_TILES``). Returns (max |err| of
    o over both, the uniform inputs, keyword arguments)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kw = {"scale": dh ** -0.5, "row_offset": row_offset, "window": window, "causal": causal}
    kernel = fa.forward_kernel(fa.forward_case(sq, skv, row_offset, causal, window)[0], dtype)
    what = (f"flash forward {sq}x{skv} h={h}/{h_kv} dh={dh} off={row_offset} w={window} "
            f"{'causal' if causal else 'not causal'} {dtype_name} ({kernel})")
    tiles_want = dict(fa.FORWARD_TILES)
    tiles_want[kernel] += 3  # band, uniform and peaked inputs
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
    if fa.FORWARD_TILES != tiles_want:
        fail(f"{what}: forward launches by kernel {fa.FORWARD_TILES}, expected {tiles_want}")
    return max(errs), uniform, kw


def check_flash_chunk(fa, sq, skv, h, h_kv, dh, dtype_name, row_offset,
                      col_offset, mode, window):
    """K9 against ``flash_chunk_plain`` on the card: two folds into one
    carry (the second reads what the first wrote in place), bit for bit
    on band inputs; on uniform and on peaked inputs, one fold, the
    normalised output within ``fa.plain_gap_bound``, m within the score
    gap Δs and l within a relative ``4*Δs + 2*skv*2**-23 + 2**-20``; each
    of the four launches on the kernel ``fa.forward_kernel`` names
    (``FORWARD_TILES``). Returns (max |err| of the output, inputs, keyword
    arguments)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    scale = dh ** -0.5
    kw = {"scale": scale, "row_offset": row_offset, "col_offset": col_offset,
          "causal": mode, "window": window}
    kernel = fa.forward_kernel("chunk", dtype)
    what = (f"flash chunk {mode} {sq}x{skv} h={h}/{h_kv} dh={dh} "
            f"off={row_offset}/{col_offset} w={window} {dtype_name} ({kernel})")
    tiles_want = dict(fa.FORWARD_TILES)
    tiles_want[kernel] += 4  # two folds of band inputs, uniform and peaked
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
    if fa.FORWARD_TILES != tiles_want:
        fail(f"{what}: chunk launches by kernel {fa.FORWARD_TILES}, expected {tiles_want}")
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


#: K1's phase: (m, n, k, dtype, the tile tile_for must give): the GEMM
#: path's shape, fp16 and f32, a ragged shape whose rows are still 16-byte
#: multiples (the Hopper tile's masked edge), and one whose n is not (wmma)
K1_CASES = (
    (PATH_MNK, PATH_MNK, PATH_MNK, "bfloat16", "wgmma"),
    (2048, 2048, 2048, "float16", "wgmma"),
    (2048, 2048, 2048, "float32", "simt"),
    (1000, 776, 520, "bfloat16", "wgmma"),
    (1000, 777, 520, "bfloat16", "wmma"),
)


def kernel_phase_matmul(k1, smi):
    """K1 at every shape of its phase, each on the tile its widths choose,
    then timed at the GEMM path's shape. Returns its entry of the
    ``kernels`` line (launches filled in later)."""
    import torch

    main_err = None
    for m, n, k, dtype_name, tile in K1_CASES:
        got = k1.tile_for(getattr(torch, dtype_name), k, n)
        if got != tile:
            fail(f"K1 {m}x{n}x{k} {dtype_name} would run the {got} tile, not {tile}")
        tiles_before = dict(k1.TILES)
        max_err, tol, operands = check_matmul(k1, m, n, k, dtype_name)
        # check_matmul launches twice (integer and uniform operands)
        want = dict(tiles_before, **{tile: tiles_before[tile] + 2})
        if k1.TILES != want:
            fail(f"K1 {m}x{n}x{k} {dtype_name}: launches by tile {k1.TILES}, expected {want}")
        print(
            f"K1 {m}x{n}x{k} {dtype_name} ({tile} tile): max |err| {max_err!r} "
            f"vs plain ({tol}): ok"
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
        "tile": "wgmma",
        "registers": ptxas_registers("matmul", "gemm_wgmma"),
    }


# -- the ring collective matmuls (K2, K3), d virtual ranks on one card ---------

#: loopback cases, (d, m_loc, n, k a rank, dtype): first the per-rank shapes
#: of the GEMM path's 8192^3 bf16 at d = 4 (K2: [2048, 8192] @ [8192, 8192];
#: K3: [8192, 2048] @ [2048, 8192]), then d = 2 and 3, a ragged case the
#: Hopper tile takes, fp16 and f32; K3 adds a second ragged 16-bit case
#: (m_loc, n and k/d off the tile's 128, 256 and 64); both add 16-bit rows
#: that are not a multiple of 16 bytes (the wmma tile: TMA cannot load them)
RING_AG_CASES = [
    (4, PATH_MNK // 4, PATH_MNK, PATH_MNK, "bfloat16"),
    (2, 1024, 2048, 2048, "bfloat16"),
    (3, 1000, 776, 520, "bfloat16"),
    (3, 256, 384, 512, "float16"),
    (4, 512, 1024, 512, "float32"),
    (3, 130, 262, 74, "bfloat16"),
]
RING_RS_CASES = [
    (4, PATH_MNK // 4, PATH_MNK, PATH_MNK // 4, "bfloat16"),
    (2, 1024, 2048, 1024, "bfloat16"),
    (3, 1000, 776, 520, "bfloat16"),
    (3, 256, 384, 512, "float16"),
    (4, 512, 1024, 512, "float32"),
    (4, 130, 264, 72, "float16"),
    (3, 130, 262, 74, "bfloat16"),
]


def ring_operands(kind, d, m_loc, n, k, dtype, gen, integer):
    """K2: (d shards [m_loc, k], b [k, n]); K3: (d shards [d m_loc, k],
    d shards [k, n]). Integer-valued in [-4, 4], or uniform [-1, 1]."""
    import torch

    def make(shape):
        if integer:
            return torch.randint(-4, 5, shape, generator=gen, device="cuda").to(dtype)
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(dtype)

    if kind == "ag":
        return [make((m_loc, k)) for _ in range(d)], make((k, n))
    return [make((d * m_loc, k)) for _ in range(d)], [make((k, n)) for _ in range(d)]


def check_ring(cm, k1, kind, d, m_loc, n, k, dtype_name):
    """One loopback launch of K2 (``ag``) or K3 (``rs``) for d virtual ranks
    against the one-process plain ring (``ring_*_virtual``), twice:

    - integer-valued operands: bit for bit, every rank (every sum is exact
      in float32 in any order, so both sides round the same values at
      every hop);
    - uniform operands: K2 within K1's ``plain_gap_bound`` (each chunk is
      K1's tile GEMM), K3 within ``ring_matmul_rs_gap_bound`` (that rule
      and the rounding of the partial and of every hop's sum, hop by hop),
      f32 within 1e-5 * k.

    Returns (max |err| on the uniform operands, tolerance text, operands)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + d)
    what = f"K{2 if kind == 'ag' else 3} loopback d={d} {m_loc}x{n}x{k} {dtype_name}"
    loopback = cm.ring_ag_matmul_loopback if kind == "ag" else cm.ring_matmul_rs_loopback
    virtual = cm.ring_ag_matmul_virtual if kind == "ag" else cm.ring_matmul_rs_virtual
    counts = cm.TILES if kind == "ag" else cm.RS_TILES
    tiles_before = dict(counts)
    x, y = ring_operands(kind, d, m_loc, n, k, dtype, gen, integer=True)
    got, want = loopback(x, y), virtual(x, y)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{what}: not exact on integer operands")
    x, y = ring_operands(kind, d, m_loc, n, k, dtype, gen, integer=False)
    got, want = loopback(x, y), virtual(x, y)
    torch.cuda.synchronize()
    # both launches ran the tile the widths choose
    tile = cm.tile_for(dtype, k, n)
    tiles_want = dict(tiles_before, **{tile: tiles_before[tile] + 2})
    if counts != tiles_want:
        fail(f"{what}: launches by tile {counts}, expected {tiles_want}")
    what += f" ({tile} tile)"
    if dtype_name == "float32":
        bounds = [torch.full_like(w, 1e-5 * k, dtype=torch.float32) for w in want]
        text = f"exact on integers; atol {1e-5 * k:g}"
    elif kind == "ag":
        a_full = torch.cat(x)
        bounds = [k1.plain_gap_bound(a_full, y, g, w) for g, w in zip(got, want)]
        text = "exact on integers; plain_gap_bound"
    else:
        bounds = cm.ring_matmul_rs_gap_bound(x, y)
        text = "exact on integers; ring_matmul_rs_gap_bound"
    max_err, bad = 0.0, 0
    for g, w, bound in zip(got, want, bounds):
        err = (g.float() - w.float()).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > bound).sum())
    if bad or not math.isfinite(max_err):
        fail(f"{what}: {bad} elements beyond {text}, max |err| {max_err}")
    print(f"{what}: max |err| {max_err!r} vs plain ({text}): ok")
    return max_err, text, (x, y)


#: the ring of two simulated nodes of two cards under transport=dcn
#: (``runtime.transport_order``): ring position p addresses rank
#: DCN_ORDER[p]'s buffer
DCN_ORDER = (0, 2, 1, 3)


def permuted(table, order=DCN_ORDER):
    """A loopback peer table (``Ring`` or ``A2ABuffers``) whose entry p is
    the buffer of rank ``order[p]``, as ``PeerBuffer`` lays it out for a
    reordered ring."""
    out = type(table).__new__(type(table))
    out.__dict__.update(table.__dict__, ptrs=tuple(table.ptrs[r] for r in order))
    return out


def check_ring_permuted(cm, kind):
    """One d = 4 loopback launch of K2 or K3 on a peer table in the dcn
    order of two simulated nodes, bit for bit on integer operands against
    the plain ring (the shards listed by ring position). In loopback the
    permuted table only changes which allocation a virtual rank uses, so
    this shows that the kernel addresses its peers through the table and
    nowhere else; the reordered ring across cards is the four-card run's
    (``scripts/topology_sweeps.py``)."""
    import torch

    d, m_loc, n, k = len(DCN_ORDER), 256, 512, 512 if kind == "ag" else 256
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    x, y = ring_operands(kind, d, m_loc, n, k, torch.bfloat16, gen, integer=True)
    ring = permuted(cm.loopback_ring(kind, d, m_loc * (k if kind == "ag" else n),
                                     torch.bfloat16, "cuda"))
    loopback = cm.ring_ag_matmul_loopback if kind == "ag" else cm.ring_matmul_rs_loopback
    virtual = cm.ring_ag_matmul_virtual if kind == "ag" else cm.ring_matmul_rs_virtual
    got, want = loopback(x, y, ring), virtual(x, y)
    torch.cuda.synchronize()
    what = f"K{2 if kind == 'ag' else 3} loopback d={d} on the dcn table {list(DCN_ORDER)}"
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{what}: not bit for bit on integer operands")
    print(f"{what}: bit for bit on integer operands: ok")


def ring_bound(kind, d, m_loc, n, k, itemsize):
    """(bound ms, bound_by) of one loopback launch of d virtual ranks: the
    larger of the d ranks' GEMM FLOPs over the bf16 peak and the bytes the
    launch must move (each rank's operands read once, its output written
    once) over the memory rate."""
    if kind == "ag":
        flops = d * 2.0 * (d * m_loc) * n * k
        moved = d * (m_loc * k + k * n + d * m_loc * n) * itemsize
    else:
        flops = d * 2.0 * (d * m_loc) * n * k
        moved = d * (d * m_loc * k + k * n + m_loc * n) * itemsize
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def kernel_phase_ring(cm, k1, smi):
    """K2 and K3 in loopback at every case of their phase, then each timed
    at the GEMM path's per-rank shapes, d = 4, beside its plain ring run in
    one process, the bound of the four ranks' work and one library call
    that computes the same product (``torch.matmul``: the four ranks' K2
    outputs as one batched product of the gathered A; K3's reduce-scattered
    sum as the full [m, k] @ [k, n] product, whose rows the four ranks
    hold). These are loopback times of four virtual ranks sharing one
    card, not four-card times. Returns the two ``kernels`` entries
    (launches filled in later)."""
    import torch

    entries = []
    for kind, cases, name, replaces in (
        ("ag", RING_AG_CASES, "collective_ag_matmul", "ddlb_tpu/ops/collective_matmul.py:98"),
        ("rs", RING_RS_CASES, "collective_matmul_rs", "ddlb_tpu/ops/collective_matmul.py:249"),
    ):
        main = None
        for case in cases:
            result = check_ring(cm, k1, kind, *case)
            if main is None:
                main = (case, result)
            torch.cuda.empty_cache()
        check_ring_permuted(cm, kind)
        (d, m_loc, n, k, _), (max_err, tol, (x, y)) = main
        if cm.tile_for(x[0].dtype, k, n) != "wgmma":
            fail(f"{name} at the path's shapes would run the "
                 f"{cm.tile_for(x[0].dtype, k, n)} tile")
        ring = cm.loopback_ring(kind, d, m_loc * (k if kind == "ag" else n), x[0].dtype, "cuda")
        if kind == "ag":
            gathered = torch.cat(x)
            calls = {
                "ms": lambda: cm.ring_ag_matmul_loopback(x, y, ring),
                "library_ms": lambda: torch.matmul(gathered.expand(d, *gathered.shape), y),
                "plain_ms": lambda: cm.ring_ag_matmul_virtual(x, y),
            }
        else:
            a_cat, b_cat = torch.cat(x, dim=1), torch.cat(y)
            calls = {
                "ms": lambda: cm.ring_matmul_rs_loopback(x, y, ring),
                "library_ms": lambda: torch.matmul(a_cat, b_cat),
                "plain_ms": lambda: cm.ring_matmul_rs_virtual(x, y),
            }
        times, timings = time_turns(calls, {"ms": 10, "library_ms": 10, "plain_ms": 2})
        bound, bound_by = ring_bound(kind, d, m_loc, n, k, x[0].element_size())
        print(
            f"{name} loopback d={d} ({m_loc}x{n}x{k} a rank, bf16): kernel "
            f"{times['ms']!r} ms, library {times['library_ms']!r} ms, plain "
            f"{times['plain_ms']!r} ms, bound {bound!r} ms ({smi}); windows {timings}"
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "ddlb_tpu_torch/csrc/collective_matmul.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": max_err,
            "ms": times["ms"],
            "plain_ms": times["plain_ms"],
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": times["library_ms"],
            "mode": f"loopback d={d}",
        })
        del x, y, ring, calls
        torch.cuda.empty_cache()
    return entries


# -- the pure ring collectives (K4, K5) and the all-to-all expert GEMM (K6) ----

#: loopback cases, d virtual ranks on one card. K4/K5: (d, rows a rank, k,
#: dtype), first the collectives path's per-rank shard at d = 4
#: (config_collectives.json's m = k = 8192 bf16: [2048, 8192]); K6: (d, g,
#: n, k, dtype), first the ep path's per-rank shapes at d = 4 (8192^3 bf16:
#: [2048, 8192] tokens in groups of 512, an [8192, 8192] expert). Then
#: d = 2 and 3, a ragged case, fp16 and f32.
TRIO_RING_CASES = [
    (4, PATH_MNK // 4, PATH_MNK, "bfloat16"),
    (2, 1024, 2048, "bfloat16"),
    (3, 1002, 520, "bfloat16"),
    (3, 384, 512, "float16"),
    (4, 512, 1024, "float32"),
]
TRIO_A2A_CASES = [
    (4, PATH_MNK // 16, PATH_MNK, PATH_MNK, "bfloat16"),
    (2, 512, 2048, 2048, "bfloat16"),
    (3, 100, 776, 520, "bfloat16"),
    (3, 256, 384, 512, "float16"),
    (4, 128, 1024, 512, "float32"),
]


def trio_operands(shapes, dtype, gen, kind):
    """Tensors of ``shapes`` on the card: integer-valued in [-4, 4]
    (``integer``), multiples of 1/16 in [-1, 1] (``dyadic``), or uniform
    [-1, 1]."""
    import torch

    out = []
    for shape in shapes:
        if kind == "integer":
            x = torch.randint(-4, 5, shape, generator=gen, device="cuda").float()
        else:
            x = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
            if kind == "dyadic":
                x = torch.round(x * 16) / 16
        out.append(x.to(dtype))
    return out


def check_trio_ring(rc, d, m_loc, k, dtype_name):
    """K4 and K5, one loopback launch each for d virtual ranks, against the
    one-process plain ring (``ring_*_virtual``) on integer, dyadic and
    uniform operands: bit for bit on all three (K4 copies; K5 rounds the
    same float32 sum of the same two values at every hop, in the same
    order). Returns (max |err| on the uniform operands, which is 0, the
    tolerance text)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * d)
    for kind in ("integer", "dyadic", "uniform"):
        shards = trio_operands([(m_loc, k)] * d, dtype, gen, kind)
        got_ag, want_ag = rc.ring_all_gather_loopback(shards), rc.ring_all_gather_virtual(shards)
        got_rs = rc.ring_reduce_scatter_loopback(shards)
        want_rs = rc.ring_reduce_scatter_virtual(shards)
        torch.cuda.synchronize()
        for what, got, want in (("K4", got_ag, want_ag), ("K5", got_rs, want_rs)):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
                fail(f"{what} loopback d={d} [{m_loc}, {k}] {dtype_name}: not bit for bit "
                     f"on {kind} operands, max |err| {err}")
    print(f"K4/K5 loopback d={d} [{m_loc}, {k}] a rank {dtype_name}: bit for bit on "
          f"integer, dyadic and uniform operands: ok")
    return 0.0, "bit for bit on integer, dyadic and uniform operands"


def check_trio_a2a(am, k1, d, g, n, k, dtype_name):
    """K6, one loopback launch for d virtual ranks, against the one-process
    version (``alltoall_expert_matmul_virtual``): bit for bit on integer
    operands and on multiples of 1/16 (every sum exact in float32 in any
    order), and on uniform ones each group within K1's ``plain_gap_bound``
    (f32 within 1e-5 * k). Returns (max |err| on the uniform operands, the
    tolerance text, the uniform operands)."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11 * d)
    tile = am.tile_for(dtype)
    what = f"K6 loopback d={d} g={g} n={n} k={k} {dtype_name} ({tile} tile)"
    tiles_want = dict(am.TILES, **{tile: am.TILES[tile] + 3})
    for kind in ("integer", "dyadic", "uniform"):
        shards = trio_operands([(d * g, k)] * d, dtype, gen, kind)
        experts = trio_operands([(k, n)] * d, dtype, gen, kind)
        got = am.alltoall_expert_matmul_loopback(shards, experts)
        want = am.alltoall_expert_matmul_virtual(shards, experts)
        torch.cuda.synchronize()
        if kind != "uniform":
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"{what}: not bit for bit on {kind} operands")
            continue
        max_err, bad = 0.0, 0
        for r in range(d):
            err = (got[r].float() - want[r].float()).abs()
            max_err = max(max_err, float(err.max()))
            for e in range(d):
                rows = slice(e * g, (e + 1) * g)
                if dtype_name == "float32":
                    bound = 1e-5 * k
                else:
                    bound = k1.plain_gap_bound(shards[r][rows], experts[e], got[r][rows],
                                               want[r][rows])
                bad += int((err[rows] > bound).sum())
        if bad or not math.isfinite(max_err):
            fail(f"{what}: {bad} elements beyond the bound, max |err| {max_err}")
    if am.TILES != tiles_want:
        fail(f"{what}: launches by tile {am.TILES}, expected {tiles_want}")
    text = ("exact on integers and dyadic operands; "
            + ("atol 1e-5 * k" if dtype_name == "float32" else "plain_gap_bound"))
    print(f"{what}: max |err| {max_err!r} vs plain ({text}): ok")
    return max_err, text, (shards, experts)


def check_trio_permuted(rc, am):
    """K4, K5 and K6, one d = 4 loopback launch each on a peer table in the
    dcn order of two simulated nodes, bit for bit on integer operands
    against the plain versions (the shards and experts listed by ring
    position): as ``check_ring_permuted``, this shows that the kernels
    address their peers through the table alone."""
    import torch

    d = len(DCN_ORDER)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    m_loc, k, g, n = 512, 1024, 128, 512
    shards = trio_operands([(m_loc, k)] * d, torch.bfloat16, gen, "integer")
    for name, kind, loopback, virtual, chunk in (
            ("K4", "all_gather", rc.ring_all_gather_loopback, rc.ring_all_gather_virtual,
             m_loc * k),
            ("K5", "reduce_scatter", rc.ring_reduce_scatter_loopback,
             rc.ring_reduce_scatter_virtual, m_loc // d * k)):
        ring = permuted(rc.loopback_ring(kind, d, chunk, torch.bfloat16, "cuda"))
        got, want = loopback(shards, ring), virtual(shards)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"{name} loopback d={d} on the dcn table: not bit for bit on integers")
    tokens = trio_operands([(d * g, k)] * d, torch.bfloat16, gen, "integer")
    experts = trio_operands([(k, n)] * d, torch.bfloat16, gen, "integer")
    bufs = permuted(am.loopback_buffers(d, g, k, n, torch.bfloat16, "cuda"))
    got = am.alltoall_expert_matmul_loopback(tokens, experts, bufs)
    want = am.alltoall_expert_matmul_virtual(tokens, experts)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"K6 loopback d={d} on the dcn table: not bit for bit on integers")
    print(f"K4/K5/K6 loopback d={d} on the dcn table {list(DCN_ORDER)}: bit for bit on "
          f"integer operands: ok")


def trio_bound(kind, d, rows, n, k, itemsize):
    """(bound ms, bound_by) of one loopback launch of d virtual ranks: the
    larger of the operations over the bf16 peak and the bytes the launch
    must move (each rank's inputs read once, its output written once) over
    the memory rate. K4 (``ag``): a [rows, k] shard in, [d rows, k] out;
    K5 (``rs``): [rows, k] in, [rows / d, k] out, d - 1 additions an output
    element; K6 (``a2a``): [rows, k] tokens and a [k, n] expert in,
    [rows, n] out, a rows x n x k GEMM."""
    if kind == "ag":
        flops, moved = 0.0, d * (rows * k + d * rows * k) * itemsize
    elif kind == "rs":
        flops, moved = d * (d - 1) * (rows // d) * k, d * (rows * k + rows // d * k) * itemsize
    else:
        flops = d * 2.0 * rows * n * k
        moved = d * (rows * k + k * n + rows * n) * itemsize
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def kernel_phase_trio(rc, am, k1, smi):
    """K4, K5 and K6 in loopback at every case of their phase, then each
    timed at d = 4 at the per-rank shapes of its path beside its plain
    version run in one process, the bound of the four ranks' work and one
    library call for the same work on one card (K4: ``torch.cat`` of the
    four shards, four times; K5: ``torch.stack(...).sum(0)`` of each
    rank's chunk; K6: ``torch.bmm`` of the four experts' gathered groups).
    These are loopback times of four virtual ranks sharing one card, not
    four-card times. Returns the three ``kernels`` entries (launches filled
    in later)."""
    import torch

    for case in TRIO_RING_CASES:
        check_trio_ring(rc, *case)
        torch.cuda.empty_cache()
    a2a_main = None
    for case in TRIO_A2A_CASES:
        result = check_trio_a2a(am, k1, *case)
        if a2a_main is None:
            a2a_main = (case, result)
        torch.cuda.empty_cache()
    check_trio_permuted(rc, am)

    entries = []
    d, m_loc, k, _ = TRIO_RING_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shards = trio_operands([(m_loc, k)] * d, torch.bfloat16, gen, "uniform")
    rows = m_loc // d
    for kind, name, source_line, calls in (
        ("ag", "ring_all_gather", "ddlb_tpu/ops/ring_collectives.py:54", {
            "ring": lambda: rc.loopback_ring("all_gather", d, m_loc * k, torch.bfloat16, "cuda"),
            "kernel": rc.ring_all_gather_loopback,
            "library_ms": lambda: [torch.cat(shards) for _ in range(d)],
            "plain_ms": lambda: rc.ring_all_gather_virtual(shards),
        }),
        ("rs", "ring_reduce_scatter", "ddlb_tpu/ops/ring_collectives.py:181", {
            "ring": lambda: rc.loopback_ring("reduce_scatter", d, rows * k, torch.bfloat16,
                                             "cuda"),
            "kernel": rc.ring_reduce_scatter_loopback,
            "library_ms": lambda: [torch.stack([a[r * rows:(r + 1) * rows] for a in shards])
                                   .sum(0) for r in range(d)],
            "plain_ms": lambda: rc.ring_reduce_scatter_virtual(shards),
        }),
    ):
        ring = calls.pop("ring")()
        kernel = calls.pop("kernel")
        calls["ms"] = lambda kernel=kernel, ring=ring: kernel(shards, ring)
        times, timings = time_turns(calls, {"ms": 20, "library_ms": 20, "plain_ms": 5})
        bound, bound_by = trio_bound(kind, d, m_loc, 0, k, 2)
        print(f"{name} loopback d={d} ([{m_loc}, {k}] a rank, bf16): kernel "
              f"{times['ms']!r} ms, library {times['library_ms']!r} ms, plain "
              f"{times['plain_ms']!r} ms, bound {bound!r} ms ({smi}); windows {timings}")
        entries.append({
            "name": name, "route": "cuda", "source": "ddlb_tpu_torch/csrc/ring_collectives.cu",
            "replaces": source_line, "launches": None, "max_abs_err": 0.0,
            "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": times["library_ms"],
            "mode": f"loopback d={d}",
        })
        del ring, calls
    del shards
    torch.cuda.empty_cache()

    (d, g, n, k, _), (max_err, _, (shards, experts)) = a2a_main
    if am.tile_for(torch.bfloat16) != "wgmma":
        fail(f"K6 at the path's shapes would run the {am.tile_for(torch.bfloat16)} tile")
    bufs = am.loopback_buffers(d, g, k, n, torch.bfloat16, "cuda")
    # the library's layout: expert e's gathered groups, [d, d g, k] @ [d, k, n]
    xs = torch.stack([torch.cat([a[e * g:(e + 1) * g] for a in shards]) for e in range(d)])
    ws = torch.stack(experts)
    times, timings = time_turns({
        "ms": lambda: am.alltoall_expert_matmul_loopback(shards, experts, bufs),
        "library_ms": lambda: torch.bmm(xs, ws),
        "plain_ms": lambda: am.alltoall_expert_matmul_virtual(shards, experts),
    }, {"ms": 5, "library_ms": 5, "plain_ms": 2})
    bound, bound_by = trio_bound("a2a", d, d * g, n, k, 2)
    print(f"alltoall_expert_matmul loopback d={d} ([{d * g}, {k}] @ [{k}, {n}] a rank, "
          f"bf16): kernel {times['ms']!r} ms, bmm {times['library_ms']!r} ms, plain "
          f"{times['plain_ms']!r} ms, bound {bound!r} ms ({smi}); windows {timings}")
    entries.append({
        "name": "alltoall_expert_matmul", "route": "cuda",
        "source": "ddlb_tpu_torch/csrc/alltoall_matmul.cu",
        "replaces": "ddlb_tpu/ops/alltoall_matmul.py:63", "launches": None,
        "max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": times["library_ms"],
        "mode": f"loopback d={d}",
    })
    del shards, experts, xs, ws, bufs
    torch.cuda.empty_cache()
    return entries


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
        # K8a's wgmma kernel at ragged lengths and GQA 8/2, both 16-bit types
        *((s, s, h, 2, dh, name, 0, 0) for s in (1, 127, 129, 1000)
          for name in ("bfloat16", "float16")),
        (1024, 1024, 4, 4, dh, "float32", 0, 0),
        (1024, 2048, 4, 2, dh, "float32", 1024, 700),
        (1000, 1000, h, h, dh, "bfloat16", 0, 0),
        (777, 1500, 4, 2, dh, "bfloat16", 723, 300),
        (777, 1500, 4, 2, dh, "float16", 723, 300),
        (1000, 1000, 4, 2, dh, "float16", 0, 300),
        # the band kernel's edges: query tile 3 reaches no key under the
        # window; not causal, ragged both ways, both 16-bit types
        (512, 256, 4, 2, dh, "bfloat16", 0, 100),
        (1000, 700, 4, 2, dh, "bfloat16", 0, 0, False),
        (1000, 700, 4, 2, dh, "float16", 0, 0, False),
    ):
        check_flash_forward(fa, *args)
    chunk_err, chunk_in, chunk_kw = check_flash_chunk(
        fa, m, m, h, h, dh, "bfloat16", 0, 0, "diagonal", 0
    )
    for args in (
        (4096, 4096, h, h_kv, dh, "bfloat16", 12288, 8192, "past", 0),
        (4096, 4096, h, h, dh, "bfloat16", 12288, 8192, "offset", 6000),
        (1000, 700, 4, 2, dh, "float16", 900, 500, "offset", 0),
        (1000, 700, 4, 2, dh, "bfloat16", 900, 500, "offset", 0),
        (1024, 1024, 4, 4, dh, "float32", 0, 0, "diagonal", 300),
        # the band kernel's edges: a diagonal chunk with a window, ragged,
        # GQA 4; query tile 3 reaching no key of its chunk
        (1000, 1000, 8, 2, dh, "bfloat16", 5000, 5000, "diagonal", 300),
        (512, 768, 4, 2, dh, "bfloat16", 1000, 0, "offset", 600),
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
    # into one carry in place (the time does not depend on its values);
    # beside it SDPA with is_causal on the same q, k, v, the same attention
    # normalised (no PyTorch call folds into an unnormalised carry)
    q, k, v = chunk_in
    qt, kt, vt = (x.transpose(0, 1).contiguous()[None] for x in (q, k, v))
    carry = fa.init_flash_carry(m, h, dh, "cuda")
    chunk_times, chunk_turns = time_turns({
        "ms": lambda: fa.flash_attention_chunk(q, k, v, carry, **chunk_kw),
        "sdpa_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=chunk_kw["scale"]),
        "plain_ms": lambda: fa.flash_chunk_plain(q, k, v, carry, **chunk_kw),
    }, {"ms": 10, "sdpa_ms": 10, "plain_ms": 1})
    del qt, kt, vt
    chunk_bound = flash_bound(fa, m, m, h, h, dh, 2, 0, 0, True, 0, carry=True)
    for what, times, turns, bound in (
        ("K8a triangle", tri_times, tri_turns, tri_bound),
        ("K8b offset/window/GQA", rect_times, rect_turns, rect_bound),
        ("K9 diagonal chunk", chunk_times, chunk_turns, chunk_bound),
    ):
        print(f"{what}: kernel {times['ms']!r} ms, library "
              f"{times.get('library_ms', times.get('sdpa_ms'))!r} ms, plain {times['plain_ms']!r} "
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
    forward["tile"] = "wgmma"
    forward["registers"] = ptxas_registers("flash_attention", "3tri15flash_fwd_wgmma")
    # flash_forward is also K8b's counterpart; its case at the windowed
    # row's shape, with its own numbers
    forward["also_replaces"] = "ddlb_tpu/ops/flash_attention.py:96"
    forward["rect"] = entry("flash_forward (rect)",
                            "ddlb_tpu/ops/flash_attention.py:96", rect_err,
                            rect_times, rect_bound)
    forward["rect"]["tile"] = "band"
    forward["rect"]["registers"] = band_ptxas(carry=False)
    chunk = entry("flash_chunk", "ddlb_tpu/ops/flash_attention.py:146",
                  chunk_err, chunk_times, chunk_bound)
    chunk["tile"] = "band"
    chunk["registers"] = band_ptxas(carry=True)
    chunk["sdpa_ms"] = chunk_times["sdpa_ms"]
    chunk["library_ms_note"] = (
        "null: no single PyTorch call folds a KV chunk into a carried "
        "(acc, m, l) without normalising it; sdpa_ms is SDPA with is_causal "
        "on the same q, k, v (the same attention, normalised)"
    )
    return forward, chunk


def wgmma_ptxas(namespace, kernel, tag=""):
    """``namespace::kernel``'s registers and spill stores by dtype (the
    instantiations whose mangled name also holds ``tag``), each with
    whether ``ptxas`` warned that it serialised the wgmma pipeline
    (C7512); fails on a spill or that warning, or if the build log lacks
    the bf16 or the fp16 instantiation."""
    from ddlb_tpu_torch.ops import _build

    log = _build.build_log("flash_attention")
    usage = _build.ptxas_usage(log)
    warned = [line for line in log.splitlines() if "C7512" in line]
    found = {}
    for name, used in usage.items():
        if f"{len(namespace)}{namespace}{len(kernel)}{kernel}" in name and tag in name:
            dtype = "bfloat16" if "bfloat16" in name else "float16"
            found[dtype] = dict(used, c7512=any(name in line for line in warned))
    bad = {d: u for d, u in found.items() if u.get("spill_stores") or u["c7512"]}
    # a warning that names no kernel of the log cannot be cleared
    unnamed = [line for line in warned if not any(name in line for name in usage)]
    if sorted(found) != ["bfloat16", "float16"] or bad or unnamed:
        fail(f"{namespace}::{kernel} {tag}: ptxas {found}, C7512 lines {warned}")
    return found


def band_ptxas(carry):
    """``band::flash_fwd_wgmma``'s ``wgmma_ptxas`` for one value of CARRY."""
    return wgmma_ptxas("band", "flash_fwd_wgmma", f"Lb{int(carry)}E")


#: K8a as the serving path calls it (sequence, query heads, kv heads), bf16:
#: the prefill of a batch of 8 at m = 8192 merges the batch into the head
#: axis (8 x 16 = 128 query heads; 32 kv heads at GQA-4; the speculate
#: path's target and draft prefills alike), and each serve admission
#: prefills one prompt padded to its bucket, a power of two from 16 (below
#: one tile) up; the serve rows' prompts of 2048 fill theirs; the
#: serving_load path's admissions take buckets up to its max_len of 1408,
#: and its shared prefix is 256 tokens
SERVE_FLASH_SHAPES = (
    (8192, 128, 128), (8192, 128, 32),
    (2048, 16, 16), (2048, 16, 4),
    (1408, 16, 16), (512, 16, 16), (256, 16, 16),
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
        "tile": "wgmma",
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


def decode_ptxas():
    """``ptxas -v``'s registers and spill stores of the decode kernels, by
    design, query dtype, cache (int8 or not) and G."""
    import re

    from ddlb_tpu_torch.ops import _build

    found = {}
    for name, usage in _build.ptxas_usage(_build.build_log("decode_attention")).items():
        design = "mma" if "decode_mma" in name else "simt" if "decode_simt" in name else None
        if design is None:
            continue
        dtype = ("bfloat16" if "bfloat16" in name else "float16" if "__half" in name
                 else "float32")
        cache = "int8" if "aLi" in name else dtype  # KV = signed char
        found[f"{design} {dtype} {cache} G={re.findall(r'Li(\d+)E', name)[-1]}"] = usage
    return found


def kernel_phase_decode(da, smi):
    """K11 and K12 against their plain versions at the serving path's shapes
    (b = 8, 16 heads of 128; a decode cache of m + 1 = 8193 positions, the
    serve pool of 17 pages of 128), MHA and GQA-4, bf16 and int8, a window,
    ragged positions with 0 and a parked lane, sentinel pages; fp16 and f32
    at smaller shapes. Then each timed at the path's shape beside its
    plain version, its library yardstick and its bound, back to back
    through the wrapper and from a CUDA graph. Fails if a decode kernel
    spills. Returns the two entries of the ``kernels`` line."""
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
    # the speculate path's draft steps at m = 8192: positions up to
    # m + n_new + spec_k (4) of a cache that long
    check_decode(da, b, SPEC_S, h, h, "bfloat16", False, 0, False, "ragged")
    paged_err, paged_in = check_decode(da, b, S_pool, h, h, "bfloat16", False, 0, True, "ragged")
    for args in (
        (b, SERVING_LOAD_PAGES * PAGE_SIZE, h, h, "bfloat16", False, 0, True, "ragged"),
        # the serving_cluster path's router shards: 4 slots each
        (b // 2, SERVING_LOAD_PAGES * PAGE_SIZE, h, h, "bfloat16", False, 0, True, "ragged"),
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
        """Back to back through the wrapper (``ms``) and from a CUDA graph
        (``graph_ms``), beside the plain version and the library call on
        the same two timers."""
        kernel = ((lambda: da.paged_decode_attention(*args, **kw)) if paged
                  else (lambda: da.decode_attention(*args, **kw)))
        calls = {
            "ms": kernel,
            "plain_ms": lambda: (da.paged_decode_attention_plain if paged
                                 else da.decode_attention_plain)(*args, **kw),
        }
        iters = {"ms": 50, "plain_ms": 3}
        if yardstick is not None:
            calls["library_ms"] = yardstick
            iters["library_ms"] = 50
        times, turns = time_turns(calls, iters)
        times.setdefault("library_ms", None)
        times["graph_ms"] = graph_ms(kernel)
        times["library_graph_ms"] = graph_ms(yardstick) if yardstick is not None else None
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
        var_out[key] = {"max_abs_err": err, **times, "bound_ms": bound[0],
                        "bound_by": bound[1]}
        print(f"K11 {key}: {json.dumps(times)}, bound {bound[0]!r} ms ({bound[1]}; {smi}); "
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
        print(f"{what}: {json.dumps(times)}, bound {bound[0]!r} ms ({bound[1]}; "
              f"{smi}); turns {turns}")
    # every launch of this phase, checks and timed calls, by design
    phase_tiles = dict(da.DECODE_TILES)
    ptxas = decode_ptxas()

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
            "graph_ms": times["graph_ms"],
            "library_graph_ms": times["library_graph_ms"],
            "design": "mma",
            "phase_tiles": phase_tiles,
            "ptxas": ptxas,
        }

    decode = entry("decode_attention", "ddlb_tpu/ops/decode_attention.py:116",
                   dec_err, dec_times, dec_bound)
    decode["variants"] = var_out
    decode["library_ms_note"] = (
        "SDPA, q [b, h, 1, dh], a boolean pos mask (enable_gqa for GQA); "
        "null for int8: no PyTorch call dequantizes inside attention; "
        "ms back to back through the wrapper, graph_ms from a CUDA graph"
    )
    paged = entry("paged_decode_attention", "ddlb_tpu/ops/decode_attention.py:236",
                  paged_err, paged_times, paged_bound)
    paged["library_ms_note"] = "the gather pool[table] plus SDPA with the live mask, timed together"
    spilled = {name: u for name, u in ptxas.items() if u.get("spill_stores")}
    if spilled:
        fail(f"the decode kernels spill: {spilled}")
    return decode, paged


# -- the int8 GEMM (K7) -----------------------------------------------------------


#: K7's checks, bit for bit against its plain version: (m, n, k, output
#: dtype, tag of a shape that is also timed). The GEMM path's 8192^3; the
#: decode MLP's two products at batch 8 (the first into float32, before
#: the activation); the int8 prefill MLP's at m = 8192 (65,536 rows);
#: ragged and small shapes in every output dtype: both sides of the
#: small-m cut (64, 65), small_m's widths N = 8, 32 and 64 with k split
#: and unsplit (33,800 columns make 529 weight tiles, one split), output
#: rows that are not a multiple of 16 bytes (wgmma's staged epilogue
#: instead of its TMA stores), and k not a multiple of 16 (the mma
#: tile). Each shape runs on a column-major weight (the paths' layout:
#: wgmma, small_m, or mma where TMA cannot take the widths) and on a
#: row-major one (mma).
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
    (17, 1000, 1040, "float16", None),
    (64, 33800, 256, "bfloat16", None),
    (65, 200, 2048, "float32", None),
    (300, 1003, 512, "bfloat16", None),
)
#: timed iterations of (K7, its plain version, the library call) by tag
INT8_TIMED = {
    "gemm": (20, 2, 20),
    "decode_w1": (100, 10, 100),
    "decode_w2": (100, 10, 100),
    "prefill_w1": (5, 1, 5),
}
#: rows the decode yardstick pads A to: torch._int_mm takes m > 16 only
INT8_LIBRARY_ROWS = 32


def graph_ms(fn, calls=20, replays=5):
    """CUDA-event milliseconds per call of ``calls`` calls captured in one
    CUDA graph, the median of ``replays`` replays: the card's time without
    the caller's host work between launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    del graph
    samples.sort()
    return samples[len(samples) // 2]


def k7_ptxas():
    """``ptxas -v``'s registers and spill stores of K7's kernels, by tile,
    output dtype and (small_m) N or (mma) weight layout."""
    import re

    from ddlb_tpu_torch.ops import _build

    found = {}
    for name, usage in _build.ptxas_usage(_build.build_log("quantized_matmul")).items():
        if "int8_gemm" not in name:
            continue
        dtype = ("bfloat16" if "bfloat16" in name else "float16" if "__half" in name
                 else "float32")
        if "int8_gemm_wgmma" in name:
            key = f"wgmma {dtype}"
        elif "int8_gemm_small_m" in name:
            width = re.findall(r"Li(\d+)E", name)[-1]
            key = f"small_m N={width} {dtype}"
        else:
            key = f"mma {'col' if 'Lb1E' in name else 'row'} {dtype}"
        found[key] = usage
    return found


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
    epilogue), on a column-major and on a row-major weight, each launch on
    the tile ``tile_for`` names (counted in ``TILES``); then the tagged
    shapes timed on the column-major weight beside the plain version, the
    library call (``torch._int_mm`` on the column-major weight plus the
    same epilogue: ``int8_matmul``, itself held bit for bit to the plain
    version; at the decode shapes, which it refuses, on A padded with zero
    rows to ``INT8_LIBRARY_ROWS``, labelled so) and the bound; at 8192^3
    also the mma tile on the row-major weight (``mma_ms``), and at the
    decode shapes each time also from a CUDA graph (``graph_ms``). Returns
    K7's entry of the ``kernels`` line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    timed = {}
    qm.reset_launches()
    for m, n, k, dtype_name, tag in INT8_CHECKS:
        out_dtype = getattr(torch, dtype_name)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
        bq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
        sa = torch.rand((m, 1), generator=gen, device="cuda") * 2e-2 + 1e-4
        sb = torch.rand((1, n), generator=gen, device="cuda") * 2e-2 + 1e-4
        bq_col = qm.column_major(bq)
        want = qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)
        err = 0.0
        for layout, weight in (("col", bq_col), ("row", bq)):
            tile = qm.tile_for(m, n, k, layout, aq.data_ptr(), weight.data_ptr())
            what = f"K7 {m}x{n}x{k} -> {dtype_name}, {layout}-major weight, {tile} tile"
            before = dict(qm.TILES)
            got = qm.int8_matmul_kernel(aq, weight, sa, sb, out_dtype=out_dtype)
            torch.cuda.synchronize()
            if qm.TILES != dict(before, **{tile: before[tile] + 1}):
                fail(f"{what}: launches by tile {qm.TILES}, before {before}")
            err = max(err, float((got.double() - want.double()).abs().max()))
            if not torch.equal(got, want):
                fail(f"{what}: {int((got != want).sum())} elements differ from the "
                     f"plain version, max |err| {err}")
            print(f"{what}: bit for bit equal to the plain version: ok")
            del got
        del want
        if tag is None:
            continue
        iters, plain_iters, lib_iters = INT8_TIMED.get(tag, (0, 0, 0))
        if not iters:
            continue
        calls = {
            "ms": lambda: qm.int8_matmul_kernel(aq, bq_col, sa, sb, out_dtype=out_dtype),
            "plain_ms": lambda: qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype),
        }
        iterations = {"ms": iters, "plain_ms": plain_iters}
        if tag == "gemm":
            calls["mma_ms"] = lambda: qm.int8_matmul_kernel(aq, bq, sa, sb, out_dtype=out_dtype)
            iterations["mma_ms"] = iters
        note = None
        lib_a, lib_sa = aq, sa
        if m <= 16:  # torch._int_mm refuses m <= 16: A padded with zero rows
            lib_a = torch.zeros((INT8_LIBRARY_ROWS, k), dtype=torch.int8, device="cuda")
            lib_sa = torch.ones((INT8_LIBRARY_ROWS, 1), device="cuda")
            lib_a[:m], lib_sa[:m] = aq, sa
            note = (f"torch._int_mm on A padded with zero rows to m = {INT8_LIBRARY_ROWS} "
                    f"(it refuses m <= 16) and a column-major weight, plus the epilogue")
        lib = qm.int8_matmul(lib_a, bq_col, lib_sa, sb, out_dtype=out_dtype)
        if not torch.equal(lib[:m], qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=out_dtype)):
            fail(f"K7 {tag}: the library yardstick differs from the plain version")
        del lib
        calls["library_ms"] = lambda: qm.int8_matmul(lib_a, bq_col, lib_sa, sb,
                                                     out_dtype=out_dtype)
        iterations["library_ms"] = lib_iters
        times, turns = time_turns(calls, iterations)
        if m <= qm.SMALL_M:
            times["graph_ms"] = graph_ms(calls["ms"])
            times["library_graph_ms"] = graph_ms(calls["library_ms"])
        bound = int8_bound(m, n, k, torch.empty((), dtype=out_dtype).element_size())
        tile = qm.tile_for(m, n, k, "col", aq.data_ptr(), bq_col.data_ptr())
        print(f"K7 {tag} ({m}x{n}x{k} -> {dtype_name}, {tile} tile): {json.dumps(times)}, "
              f"bound {bound[0]!r} ms ({bound[1]}; {smi}); turns {turns}")
        timed[tag] = {"shape": [m, n, k], "out": dtype_name, "tile": tile,
                      "max_abs_err": err, **times,
                      "bound_ms": bound[0], "bound_by": bound[1]}
        if note:
            timed[tag]["library_ms_note"] = note
        del aq, bq, bq_col, sa, sb, lib_a, lib_sa, calls
        torch.cuda.empty_cache()
    # every launch of this phase, checks and timed calls, by tile
    phase_tiles = dict(qm.TILES)
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
        "tile": main["tile"],
        "mma_ms": main["mma_ms"],
        "phase_tiles": phase_tiles,
        "ptxas": k7_ptxas(),
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
    # the compiled member (the JAX package's xla_gspmd): decode and prefill
    # at m = 2048, beside the einsum prefill above and an einsum spmd decode
    # (its set-up prefill is einsum, as in the JAX package: 34 GB of scores
    # at m = 8192)
    (2048, {"compiled": [{"phase": "decode", **SERVE_COMMON}],
            "spmd": [{"phase": "decode", "attn_kernel": "einsum", **SERVE_COMMON}]}, 2, 8),
    (2048, {"compiled": [{"phase": "prefill", **SERVE_COMMON}]}, 1, 3),
]


def int8_tile_counts(qm):
    """K7's launches by tile as the paths' counts key them (all zero
    without ``qm``)."""
    tiles = ("wgmma", "small_m", "mma")
    return {f"int8_{t}": (qm.TILES[t] if qm is not None else 0) for t in tiles}


def expected_serving_launches(row, calls):
    """The kernel launches one serving row makes in ``calls`` measured
    calls (warmups, timed iterations, the validation run): K8a once a
    layer per flash prompt pass (the decode rows' set-up prefill, each
    prefill or generate call, each serve admission), K11 once a layer per
    pallas decode step, K12 once a layer per tick of a paged pallas
    serve row; with an int8 MLP, K7 twice a layer (the expert's two
    products; one expert block at world 1) per forward: the set-up
    prefill, every call and the memoised oracle of the validation,
    the decode steps on K7's ``small_m`` tile and every prompt pass on
    ``wgmma``; nothing else."""
    from ddlb_tpu_torch.ops import quantized_matmul as qm

    o = row_options(row)
    L, phase = int(o["layers"]), o["phase"]
    flash = o["attn_kernel"] == "flash"
    want = {"tri": 0, "rect": 0, "chunk": 0, "decode": 0, "paged": 0, "k1": 0,
            "int8": 0, **dict.fromkeys(BWD_KEYS, 0), **int8_tile_counts(None)}
    if o["mlp_kernel"] != "bf16":
        forwards = {"decode": 1 + calls + 1, "prefill": calls + 1}.get(phase)
        if forwards is None:
            fail(f"no K7 launch rule for an int8 MLP in phase={phase}")
        want["int8"] = 2 * L * forwards
        # a decode step's products run the batch's rows (small_m); the
        # prompt passes (set-up prefill, each prefill call, the oracle)
        # batch x prompt rows (wgmma)
        steps = 2 * L * calls if phase == "decode" else 0
        step_tile = "small_m" if int(o["batch"]) <= qm.SMALL_M else "wgmma"
        want[f"int8_{step_tile}"] += steps
        want["int8_wgmma"] += want["int8"] - steps
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
        return {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES,
                **int8_tile_counts(qm)}

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


# -- the speculate path ------------------------------------------------------------


#: scripts/config_speculate.json: its three entries at m = 2048 as written
#: (einsum: the generate twin, spec_k 2/4/8, the int8 GQA-4 cache); at
#: m = 8192 spec_k 4 on the flash prefill and the pallas draft steps (an
#: einsum prefill at 8192 would build 34 GB of scores). Every row n_new 64,
#: 2 layers, a 1-layer draft of seed + 1.
SPEC_CONFIG = os.path.join("scripts", "config_speculate.json")
SPEC_FAST = {"phase": "speculate", "n_new": 64, "layers": 2, "spec_k": 4,
             "draft_layers": 1, "attn_kernel": "flash", "decode_kernel": "pallas",
             **SERVE_COMMON}
SPEC_WARMUPS, SPEC_ITERATIONS = 1, 2


def speculate_rows():
    """(m, implementations) of the speculate path, one dict of lists each."""
    with open(SPEC_CONFIG) as f:
        entries = json.load(f)["benchmark"]["implementations"]
    at_2048 = {}
    for entry in entries:
        entry = dict(entry)
        at_2048.setdefault(entry.pop("name"), []).append(entry)
    return [(2048, at_2048), (8192, {"spmd": [SPEC_FAST]})]


def expected_speculate_launches(row, calls):
    """The launches of ``calls`` measured calls of one speculate-path row:
    K8a once a layer per flash prefill (speculate: the target's ``layers``
    and the draft's ``draft_layers``; generate: the target's), K11 once a
    draft layer per draft step, ``spec_k + 1`` steps a round (the draft
    also consumes its last proposal; the verify chunk is einsum), from the
    row's ``spec_rounds``; a pallas generate once a layer per decode step
    (``n_new - 1``); nothing else."""
    o = row_options(row)
    L, phase = int(o["layers"]), o["phase"]
    want = {"tri": 0, "rect": 0, "chunk": 0, "decode": 0, "paged": 0, "k1": 0,
            "int8": 0, **dict.fromkeys(BWD_KEYS, 0), **int8_tile_counts(None)}
    draft = int(o["draft_layers"]) if phase == "speculate" else 0
    if o["attn_kernel"] == "flash":
        want["tri"] = calls * (L + draft)
    if o["decode_kernel"] == "pallas":
        if phase == "speculate":
            want["decode"] = calls * draft * (int(o["spec_k"]) + 1) * row["spec_rounds"]
        else:
            want["decode"] = calls * L * (int(o["n_new"]) - 1)
    return want


def chains_agree(what, got, want, impl, S0):
    """``got`` on the greedy chain ``want`` but where a row leaves it at a
    near-tie of the oracle's logits on the agreed prefix (top-2 gap below
    the family's tie tolerance; the token one of the two), the rule of the
    family's generate validation. Returns (rows exact, rows forgiven)."""
    import numpy as np

    forgiven = 0
    for i in np.argwhere((got != want).any(axis=1))[:, 0]:
        t = int(np.argmax(got[i] != want[i])) - S0
        if t < 0:
            fail(f"{what}: row {i} prompt changed")
        logits = impl._reference(want[:, :S0 + t]).astype(np.float32)[i]
        order = np.argsort(logits)
        gap = float(logits[order[-1]] - logits[order[-2]])
        if gap >= impl._tie_tol() or got[i, S0 + t] not in order[-2:]:
            fail(f"{what}: row {i} leaves the generate chain at step {t}, top-2 gap "
                 f"{gap!r} (tie tolerance {impl._tie_tol()!r})")
        forgiven += 1
    return got.shape[0] - forgiven, forgiven


def speculate_path(run_benchmark, k1, fa, da, qm, smi):
    """Drive every speculate-path row (one ``run_benchmark`` call a row,
    counts read around each), check each row's launches exactly, and
    print each row's ms, tokens/s and acceptance. Then, outside the
    counted window, each speculate row's tokens against its generate
    twin's (the same options at phase=generate) on the same prompt.
    Returns (the launch totals of the path, the rows)."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    def counts():
        return {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES,
                **int8_tile_counts(qm)}

    rows = []
    total_start = counts()
    calls = SPEC_WARMUPS + SPEC_ITERATIONS + 1
    for m, impls in speculate_rows():
        for impl_id, spec in assign_impl_ids(generate_config_combinations(impls)).items():
            name = spec.pop("implementation")
            before = counts()
            (row,) = drive_path(run_benchmark, "cuda", "transformer_decode",
                                (m, SERVE_N, SERVE_K), {name: [spec]},
                                warmups=SPEC_WARMUPS, iterations=SPEC_ITERATIONS,
                                extra_keys=("spec_rounds", "spec_proposals",
                                            "spec_accept_rate"))
            after = counts()
            got = {key: after[key] - before[key] for key in after}
            want = expected_speculate_launches(row, calls)
            if got != want:
                fail(f"speculate row {row['option']}: launches {got}, expected {want}")
            o = row_options(row)
            ms = row["median time (ms)"]
            row["tokens_per_s"] = int(o["batch"]) * int(o["n_new"]) / (ms / 1e3)
            print(json.dumps({"speculate_row": o["phase"], "m": m, "option": row["option"],
                              "median_ms": ms, "tokens_per_s": row["tokens_per_s"],
                              "spec_k": int(o["spec_k"]) if o["phase"] == "speculate" else None,
                              "spec_rounds": row.get("spec_rounds"),
                              "spec_accept_rate": row.get("spec_accept_rate"),
                              "launches": got, "card": smi}))
            rows.append(row)
            torch.cuda.empty_cache()
    end = counts()
    launches = {key: end[key] - total_start[key] for key in end}
    chain_check(rows)
    return launches, rows


#: the options a speculate row and its generate twin do not share
SPEC_ONLY = ("spec_k", "draft_layers")


def chain_check(rows, device="cuda"):
    """Each speculate row's tokens against its generate twin's: the same
    model options at phase=generate, built through the member on the same
    seeded prompt; exact but at near-ties (``chains_agree``)."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import _infer_scalar
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    cls = load_impl_class("transformer_decode", "spmd")
    twins = {}
    for row in rows:
        o = row_options(row)
        if o["phase"] != "speculate":
            continue
        shared = {key: o[key] for key in ("n_new", "layers", "attn_kernel", "decode_kernel",
                                          "kv_cache", "n_kv_heads", "batch", "vocab",
                                          "n_heads")}
        key = (row["m"], tuple(sorted(shared.items())))
        if key not in twins:
            twin = cls(row["m"], SERVE_N, SERVE_K, dtype="bfloat16", device=device,
                       phase="generate", **{k: _infer_scalar(v) for k, v in shared.items()})
            twins[key] = twin, twin.run().cpu().numpy()
        twin, want = twins[key]
        spec = cls(row["m"], SERVE_N, SERVE_K, dtype="bfloat16", device=device,
                   phase="speculate",
                   **{k: _infer_scalar(o[k]) for k in (*shared, *SPEC_ONLY)})
        got = spec.run().cpu().numpy()
        exact, forgiven = chains_agree(f"speculate {row['option']}", got, want, twin,
                                       row["m"])
        print(json.dumps({"speculate_chain": row["option"], "m": row["m"],
                          "rows_exact": exact, "rows_at_a_near_tie": forgiven}))
        del spec
        torch.cuda.empty_cache()


# -- the serving_load path ------------------------------------------------------------


#: scripts/config_serving_load.json's engine and static entries as written
#: (tiny, float32, no kernel), then the full serving width at m (mean
#: prompt) 512: 48 requests of 32 new tokens on average (at most 64), a
#: paged pool of half the contiguous size, a Zipf population of 4 prefixes
#: of 256 tokens (the hot one shared), flash admissions and pallas ticks;
#: each member under the engine's capacity (20 requests/s) and over it
#: (400/s), the engine also with head-of-line preemption after 8 ticks
SERVING_LOAD_CONFIG = os.path.join("scripts", "config_serving_load.json")
SERVING_LOAD_M = 512
SERVING_LOAD_COMMON = {"n_requests": 48, "out_mean": 32, "out_max": 64,
                       "cache_layout": "paged", "page_size": PAGE_SIZE,
                       "page_pool_frac": 0.5, "prefix_pop": 4, "prefix_len": 256,
                       "decode_kernel": "pallas", "attn_kernel": "flash",
                       **SERVE_COMMON}
SERVING_LOAD_ROWS = {
    "engine": [{"rate": [20.0, 400.0], **SERVING_LOAD_COMMON},
               {"rate": [400.0], "preempt_hol_ticks": 8, **SERVING_LOAD_COMMON}],
    "static": [{"rate": [20.0, 400.0], **SERVING_LOAD_COMMON}],
}
SERVING_LOAD_WARMUPS, SERVING_LOAD_ITERATIONS = 1, 1
#: the row columns printed for each serving_load row
SLO_KEYS = ("slo_offered_rps", "slo_completed", "slo_ttft_p50_ms", "slo_ttft_p95_ms",
            "slo_tpot_p50_ms", "slo_tpot_p95_ms", "slo_goodput_rps", "slo_attainment",
            "serve_queue_peak", "serve_occupancy", "serve_prefix_hits",
            "serve_preemptions", "serve_kv_evicted_tokens", "serve_peak_pages",
            "serve_admissions_deferred", "drains", "drain_ticks", "drain_prefills")


def serving_load_path(run_benchmark, k1, fa, da, qm, smi):
    """Drive the serving_load rows one at a time (counts read around
    each): the config's tiny entries, which must launch nothing, then the
    full-width rows, whose launches must be exactly K12 once a layer per
    engine tick of every drain (``drain_ticks``) and K8a once a layer per
    prompt prefill (the shared prefix's, once, and each admission the
    prefix did not serve, ``drain_prefills``). Prints each row's TTFT and
    TPOT percentiles and goodput. Returns (the launch totals, the rows)."""
    return drive_serving_rows(run_benchmark, k1, fa, da, qm, smi, ("engine", "static"),
                              SERVING_LOAD_ROWS, "serving_load_row")


def drive_serving_rows(run_benchmark, k1, fa, da, qm, smi, members, full_rows, key):
    """``members``' entries of ``scripts/config_serving_load.json`` as
    written (tiny, float32: no launch), then ``full_rows`` at the serving
    width, one row at a time with the counts read around each. A row's
    launches must be exactly K12 (K11 on a contiguous cache) once a layer
    per decode tick of its drains and set-up probes (``drain_ticks``,
    ``prewarm_ticks``) and K8a once a layer per prompt prefill: each
    engine's shared prefix, once, and each admission the prefix did not
    serve (``drain_prefills``, ``prewarm_prefills``). Prints one ``key``
    line a row. Returns (the launch totals, the rows)."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    def counts():
        return {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES,
                **int8_tile_counts(qm)}

    with open(SERVING_LOAD_CONFIG) as f:
        cfg = json.load(f)["benchmark"]
    tiny = {name: cfg["implementations"][name] for name in members}
    sweeps = [((cfg["m"][0], cfg["n"][0], cfg["k"][0]), tiny, cfg["dtype"],
               cfg["num_warmups"], cfg["num_iterations"]),
              ((SERVING_LOAD_M, SERVE_N, SERVE_K), full_rows, "bfloat16",
               SERVING_LOAD_WARMUPS, SERVING_LOAD_ITERATIONS)]
    rows = []
    total_start = counts()
    for shape, impls, dtype, warmups, iterations in sweeps:
        for impl_id, spec in assign_impl_ids(generate_config_combinations(impls)).items():
            name = spec.pop("implementation")
            before = counts()
            (row,) = drive_path(run_benchmark, "cuda", "serving_load", shape, {name: [spec]},
                                warmups=warmups, iterations=iterations,
                                extra_keys=SLO_KEYS + CLUSTER_KEYS, dtype=dtype)
            after = counts()
            got = {k: after[k] - before[k] for k in after}
            o = row_options(row)
            L = int(o["layers"])
            # the engines this rank runs: every engine of the row on one card
            engines = row.get("local_engines", row["serve_shards"])
            prefills = row["drain_prefills"] + row.get("prewarm_prefills", 0)
            ticks = row["drain_ticks"] + row.get("prewarm_ticks", 0)
            want = {k: 0 for k in got}
            if o["attn_kernel"] == "flash":
                want["tri"] = L * (engines * int(o["prefix_pop"] != "0") + prefills)
            if o["decode_kernel"] == "pallas":
                want["paged" if o["cache_layout"] == "paged" else "decode"] = L * ticks
            if got != want:
                fail(f"{key} {row['option']}: launches {got}, expected {want}")
            n = int(o["n_requests"])
            pooled = n * (row["drains"] - 1)
            # the validation proved the last drain's partition of the
            # trace; with nothing shed every pooled drain completed it all
            if row["serve_rejected"] == 0 and row["slo_completed"] != pooled:
                fail(f"{key} {row['option']}: {row['slo_completed']} completed of "
                     f"{pooled} in {row['drains'] - 1} pooled drains")
            print(json.dumps({key: name, "shape": list(shape), "rate": float(o["rate"]),
                              "preempt_hol_ticks": int(o["preempt_hol_ticks"]),
                              "median_ms": row["median time (ms)"],
                              **{k: row[k] for k in SLO_KEYS + CLUSTER_KEYS if k in row},
                              "launches": {k: c for k, c in got.items() if c},
                              "card": smi}))
            rows.append(row)
            torch.cuda.empty_cache()
    end = counts()
    return {k: end[k] - total_start[k] for k in end}, rows


# -- the serving_cluster path ---------------------------------------------------------


#: scripts/config_serving_load.json's router and disagg entries as written
#: (tiny, float32, no kernel), then the serving_load path's full width and
#: traffic (SERVING_LOAD_COMMON) through the cluster members, every engine
#: on the one card: router dp 2 under and over capacity and behind a token
#: bucket at the card's census rate; disagg p1+d1 under and over capacity,
#: and p2+d1 with the elastic pools
SERVING_CLUSTER_ROWS = {
    "router": [{"rate": [20.0, 400.0], "dp": 2, **SERVING_LOAD_COMMON},
               {"rate": [400.0], "dp": 2, "admission": "token_bucket",
                **SERVING_LOAD_COMMON}],
    "disagg": [{"rate": [20.0, 400.0], "prefill_shards": 1, "decode_shards": 1,
                **SERVING_LOAD_COMMON},
               {"rate": [400.0], "prefill_shards": 2, "decode_shards": 1, "elastic": 1,
                **SERVING_LOAD_COMMON}],
}
#: the cluster columns printed for each serving_cluster row
CLUSTER_KEYS = ("serve_topology", "serve_shards", "serve_handoffs", "serve_handoff_bytes",
                "serve_handoff_ms", "serve_rejected", "serve_resizes", "serve_pool_history",
                "serve_affinity_hits", "prewarm_ticks", "prewarm_prefills")


def serving_cluster_path(run_benchmark, k1, fa, da, qm, smi):
    """Drive the serving_load cluster members (``router``, ``disagg``)
    one row at a time, as ``serving_load_path`` drives the single engine;
    the launches of each row must be exact, set-up probes included.
    Returns (the launch totals, the rows)."""
    return drive_serving_rows(run_benchmark, k1, fa, da, qm, smi, ("router", "disagg"),
                              SERVING_CLUSTER_ROWS, "serving_cluster_row")


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
    (320, 320, 8, 8, 0, 0, "offset", 0, "bfloat16"),        # 64 x 5 query steps
    (129, 129, 4, 4, 0, 0, "offset", 0, "float16"),         # one past a tile
    (1000, 1000, 8, 2, 0, 0, "offset", 0, "float16"),       # ragged, GQA 4
    (2048, 2048, 8, 2, 0, 0, "offset", 0, "bfloat16"),      # GQA 8/2 triangle
    (1024, 2048, 8, 2, 1024, 0, "offset", 0, "bfloat16"),   # an offset, GQA
    (1024, 1024, 8, 8, 3072, 1024, "past", 0, "bfloat16"),  # a past ring chunk
    (1024, 1024, 8, 8, 1024, 1024, "diagonal", 0, "float16"),
    (777, 1500, 4, 2, 723, 0, "offset", 300, "bfloat16"),   # ragged, window
    (1000, 1000, 8, 2, 0, 0, "offset", 256, "float16"),
    (1024, 1024, 4, 4, 0, 0, "offset", 0, "float32"),
    (700, 900, 4, 2, 650, 100, "offset", 200, "float32"),
    # the band passes' edges: q_base - k_base = 64 mod 128, so the causal
    # edge straddles two key tiles; a window edge straddling two, GQA 4,
    # ragged skv; blocks with an empty band (a window wholly behind their
    # keys, rows past every key); none with sq != skv; the training ring
    # rows' past chunk, which the rectangle is also timed at (PAST_BWD)
    (384, 512, 8, 8, 192, 0, "offset", 0, "bfloat16"),
    (512, 1100, 8, 2, 576, 0, "offset", 200, "float16"),
    (256, 1024, 4, 4, 1000, 0, "offset", 100, "bfloat16"),
    (700, 1000, 8, 8, 0, 0, "none", 0, "bfloat16"),
    (2048, 2048, 32, 32, 2048, 0, "past", 0, "bfloat16"),
)
#: the rectangle's second timed shape: a past ring chunk of the training
#: ring rows (2048 rows and keys, 32 merged heads, no mask)
PAST_BWD = (2048, 2048, 32, 32, 2048, 0, "past", 0, "bfloat16")


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
    magnitudes the plain tile loop sums. Each call must run both passes on
    the kernel ``fa.backward_kernel`` names (``BACKWARD_TILES``). Returns
    (max |err| over dq, dk, dv and both inputs, the uniform inputs, keyword
    arguments)."""
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
    kernel = fa.backward_kernel(fa.backward_case(sq, skv, row_offset, col_offset, mode,
                                                 window)[0], dtype)
    errs, first = [], None
    for name, (q, k, v) in (("uniform", uniform), ("peaked", peaked)):
        o, lse = backward_forward(fa, q, k, v, row_offset, col_offset, mode, window)
        tiles = dict(fa.BACKWARD_TILES)
        got = fa.flash_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if fa.BACKWARD_TILES != dict(tiles, **{kernel: tiles[kernel] + 2}):
            fail(f"{what}: backward passes by kernel {fa.BACKWARD_TILES}, expected two "
                 f"more on {kernel} than {tiles}")
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
        print(f"{what}, {name} inputs, {kernel}: " + "; ".join(parts) + ": ok")
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
    autograd less SDPA forward: ``is_causal`` for the triangle, no mask for
    the past and none modes, the band as a boolean mask otherwise. Returns
    ({pass: ms}, plain ms, library ms or None, note)."""
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
    case = fa.backward_case(sq, skv, kw["row_offset"], kw["col_offset"], kw["causal"],
                            kw["window"])[0]
    if case == "tri":
        sdpa_kw["is_causal"] = True
        note = "SDPA with is_causal"
    elif kw["causal"] in ("past", "none"):
        note = "SDPA with no mask (the same three gradients)"
    else:
        rel = 0 if kw["causal"] == "diagonal" else kw["row_offset"] - kw["col_offset"]
        pos_q = rel + torch.arange(sq, device="cuda")[:, None]
        pos_k = torch.arange(skv, device="cuda")[None, :]
        band = pos_k <= pos_q
        if kw["window"]:
            band &= pos_k > pos_q - kw["window"]
        sdpa_kw["attn_mask"] = band
        note = "SDPA with the band as a boolean mask"
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
    offset, a past and a diagonal chunk, windows, the band's edges and
    empty bands, fp16 and f32), each on uniform and peaked inputs; then
    each pass timed at the full-width shape (the triangle) and at the
    windowed row's and ``PAST_BWD``'s (the rectangle) beside its bound, the
    plain version and SDPA's backward. Returns the four entries of the
    ``kernels`` line."""
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
    for extra in BWD_EXTRA:
        sq, skv, h, h_kv, ro, co, mode, window, dtype_name = extra
        case, _, _ = fa.backward_case(sq, skv, ro, co, mode, window)
        err, inputs, kw = check_flash_backward(fa, sq, skv, h, h_kv, dtype_name, ro, co,
                                               mode, window)
        errs[case].append(err)
        if extra == PAST_BWD:
            timed_inputs["past"] = (inputs, kw)
        del inputs
    kernels = {"tri": ("tri_bwd", "wgmma"), "rect": ("band_bwd", "band")}
    entries = []
    for case, (dq_line, dkv_line) in (("tri", (706, 741)), ("rect", (624, 664))):
        timed = {}
        for shape in (case, "past") if case == "rect" else (case,):
            inputs, kw = timed_inputs.pop(shape)
            q, k = inputs[0], inputs[1]
            what = (f"K10{'a/b' if case == 'tri' else 'c/d'} {kw['causal']} at {q.shape[0]} x "
                    f"{q.shape[1]} heads of {dh}, window {kw['window']}")
            times, plain_ms, library_ms, note = time_backward(fa, inputs, kw, smi, what)
            for pass_ in ("dq", "dkv"):
                bound = backward_bound(fa, q.shape[0], k.shape[0], q.shape[1], k.shape[1], dh,
                                       2, kw["row_offset"], kw["col_offset"], kw["causal"],
                                       kw["window"], pass_)
                print(f"{what} {pass_}: bound {bound[0]!r} ms ({bound[1]}; {smi})")
                timed[shape, pass_] = {
                    "ms": times[pass_],
                    "plain_ms": plain_ms,
                    "bound_ms": bound[0],
                    "bound_by": bound[1],
                    "library_ms": library_ms if pass_ == "dq" else None,
                    "plain_ms_note": "flash_backward_plain, both passes",
                    "library_ms_note": note if pass_ == "dq" else (
                        "null: SDPA's backward stands beside the dQ pass of the same case"),
                }
            del inputs
            torch.cuda.empty_cache()
        namespace, kernel = kernels[case]
        for pass_, line in (("dq", dq_line), ("dkv", dkv_line)):
            entry = {
                "name": f"flash_backward_{pass_}" + (" (rect)" if case == "rect" else ""),
                "kernel": kernel,
                "ptxas": wgmma_ptxas(namespace, f"flash_bwd_{pass_}_wgmma"),
                "route": "cuda",
                "source": "ddlb_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"ddlb_tpu/ops/flash_attention.py:{line}",
                "launches": None,
                "max_abs_err": max(errs[case]),
                **timed[case, pass_],
            }
            if case == "rect":
                entry["past"] = dict(timed["past", pass_], shape=list(PAST_BWD))
            entries.append(entry)
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
    compiled = {"xla_gspmd": cfg["implementations"]["xla_gspmd"]}
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
    wide_compiled = dict(wide, mode=["train"], attn_kernel=["einsum"])
    # the pipeline schedules: config_router.json's second entry as shipped
    # (gpipe and 1f1b), then the interleaved schedule at virtual=2 beside
    # its equal-depth gpipe twin
    pipelined = {key: value for key, value in router["implementations"][1].items()
                 if key != "name"}
    chunked = [dict(pipelined, schedule=[schedule], virtual=[2])
               for schedule in ("gpipe", "interleaved")]
    return [
        (shape, impls),
        (wide_shape, {"spmd": [wide]}),
        (wide_shape, {"spmd": [windowed]}),
        (shape, {"spmd": [int8]}),
        # the compiled member: the config's xla_gspmd entry as shipped
        # (latency_hiding_scheduler true and false), and the full width
        (shape, compiled),
        (wide_shape, {"compiled": [wide_compiled]}),
        (wide_shape, {"spmd": [pipelined]}),
        (wide_shape, {"spmd": chunked}),
    ]


def expected_training_launches(row, calls):
    """The kernel launches one training row makes in ``calls`` measured
    calls at world 1 (one device, a chain of ``virtual`` chunks, so each
    microbatch runs every layer of every chunk once): per layer, chunk and
    microbatch, the flash forward (K8a, or K8b under a window that cuts the
    band, or K9 under ring attention) once in the forward and once more
    when the backward recomputes the stage (``torch.utils.checkpoint`` in
    the GPipe loop, the backward tick's recompute in the table executor),
    and each backward pass once (K10a/K10b, or K10c/K10d under a window);
    an int8 MLP (``int8``, or ``int8_weights`` forward) runs K7 twice a
    layer, chunk and microbatch in each forward (two a train step, one a
    forward row) and in the row's one oracle loss, each on K7's wgmma
    tile. compute_only and compiled rows (einsum attention) launch no
    flash kernel; a compiled row with an int8 MLP runs K7 through its
    operators twice a layer and microbatch a call (the graph's forward:
    the straight-through backward is float32 products) and in the
    oracle."""
    o = row_options(row)
    want = {"tri": 0, "rect": 0, "chunk": 0, "decode": 0, "paged": 0, "k1": 0,
            "int8": 0, **dict.fromkeys(BWD_KEYS, 0), **int8_tile_counts(None)}
    if row["base_implementation"] in ("compute_only", "compiled"):
        if o["mlp_kernel"] == "bf16":
            return want
        if row["base_implementation"] == "compute_only":
            fail("no launch rule for a compute_only row with an int8 MLP")
        L, mb = int(o["layers_per_stage"]), int(o["microbatches"])
        want["int8"] = want["int8_wgmma"] = 2 * L * mb * (calls + 1)
        return want
    L, mb, v = int(o["layers_per_stage"]), int(o["microbatches"]), int(o["virtual"])
    train = o["mode"] == "train"
    passes = 2 if train else 1
    per_call = mb * L * v * calls
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
    if o["mlp_kernel"] != "bf16":
        # every product runs a microbatch's rows: the wgmma tile
        want["int8"] = want["int8_wgmma"] = 2 * passes * per_call + 2 * L * mb * v
    return want


def training_path(run_benchmark, k1, fa, da, qm, smi, rows=None, key="training_row"):
    """Drive every row of ``rows`` (each (family, shape, implementations);
    by default the ``transformer_step`` rows of ``training_rows``), one
    ``run_benchmark`` call per row with the counts read around it, check
    each row's launches exactly (``expected_training_launches``, or
    ``expected_serving_launches`` for a ``transformer_decode`` row), and
    print a ``key`` line a row: ms per step, tokens/s, model-FLOPs
    utilisation (``flops()`` over the time at the bf16 peak; training
    rows), peak memory and, for a compiled row, its first call. Returns
    the launch totals of the path."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    def counts():
        return {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES,
                **int8_tile_counts(qm)}

    if rows is None:
        rows = [("transformer_step", shape, impls) for shape, impls in training_rows()]
    calls = TRAIN_WARMUPS + TRAIN_ITERATIONS + 1
    total_start = counts()
    for family, shape, impls in rows:
        for impl_id, spec in assign_impl_ids(generate_config_combinations(impls)).items():
            name = spec.pop("implementation")
            before = counts()
            torch.cuda.reset_peak_memory_stats()
            (row,) = drive_path(run_benchmark, "cuda", family, shape, {name: [spec]},
                                warmups=TRAIN_WARMUPS, iterations=TRAIN_ITERATIONS)
            peak = torch.cuda.max_memory_allocated()
            after = counts()
            got = {k: after[k] - before[k] for k in after}
            o = row_options(row)
            ms = row["median time (ms)"]
            line = {key: o.get("mode", o.get("phase")), "member": name,
                    "shape": list(shape), "option": row["option"], "ms_per_step": ms}
            if family == "transformer_step":
                want = expected_training_launches(row, calls)
                line.update(tokens_per_s=int(o["batch"]) * row["m"] / (ms / 1e3),
                            tflops=row["Throughput (TFLOPS)"],
                            mfu=row["Throughput (TFLOPS)"] * 1e12 / PEAK_BF16_FLOPS)
            else:
                want = expected_serving_launches(row, calls)
                line.update(tokens_per_s=int(o["batch"]) / (ms / 1e3))
            if got != want:
                fail(f"{family} row {name} {row['option']}: launches {got}, expected {want}")
            line.update(launches={k: n for k, n in got.items() if n}, peak_row_bytes=peak,
                        card=smi, **{k: row[k] for k in COMPILE_KEYS if k in row})
            print(json.dumps(line))
            torch.cuda.empty_cache()
    end = counts()
    return {k: end[k] - total_start[k] for k in end}


# -- the router path: the learned routers, int8_weights, K7 compiled ---------


def router_rows():
    """This slice's rows, each (family, shape, implementations), at the full
    width of ``config_router.json``'s first entry (one card: tp = 1, one
    expert, so ``router_topk=1``): ``spmd`` train with ``router=topk`` at
    capacity factor 1.25 and 0.5 (half the tokens dropped), with
    ``expert_choice``, with ``topk`` under ``schedule=1f1b`` at microbatches
    4 (the aux term through the table executor), and the
    ``mlp_kernel=int8_weights`` forward; the ``compiled`` member's
    ``transformer_step`` with ``mlp_kernel=int8`` (train) and
    ``int8_weights`` (forward), and its ``transformer_decode`` int8 and
    int8_weights decode at the serving path's m = 2048 (K7 through its
    ``torch.library`` operators)."""
    with open(ROUTER_CONFIG) as f:
        router = json.load(f)["benchmark"]
    shape = (router["m"][0], router["n"][0], router["k"][0])
    wide = {key: value for key, value in router["implementations"][0].items()
            if key != "name"}
    topk = dict(wide, router=["topk"], router_topk=[1])
    block = dict(wide, router=["block"])
    compiled = dict(block, attn_kernel=["einsum"])
    return [
        ("transformer_step", shape, {"spmd": [dict(topk, capacity_factor=[1.25, 0.5])]}),
        ("transformer_step", shape, {"spmd": [dict(wide, router=["expert_choice"])]}),
        ("transformer_step", shape,
         {"spmd": [dict(topk, schedule=["1f1b"], microbatches=[4])]}),
        ("transformer_step", shape,
         {"spmd": [dict(block, mode=["forward"], mlp_kernel=["int8_weights"])]}),
        ("transformer_step", shape, {"compiled": [dict(compiled, mlp_kernel=["int8"])]}),
        ("transformer_step", shape,
         {"compiled": [dict(compiled, mode=["forward"], mlp_kernel=["int8_weights"])]}),
        ("transformer_decode", (2048, SERVE_N, SERVE_K),
         {"compiled": [{"phase": "decode", "mlp_kernel": ["int8", "int8_weights"],
                        **SERVE_COMMON}]}),
    ]


def schedule_memory(smi):
    """The pipeline schedules' activation memory at the full width: for
    each train row of ``config_router.json``'s second entry (gpipe, 1f1b)
    and its virtual=2 pair (gpipe, interleaved), the step's peak
    allocation above what its operands hold (one warm call, then the
    peak counter reset and one more call), printed beside its gpipe
    twin's with the schedule's stash slots and bubble from the tables.
    The row's own peak (``peak_row_bytes`` of the training lines) also
    holds the oracle's einsum attention, the same for every schedule."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import generate_config_combinations
    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.utils.pipeline_schedule import build_schedule

    out = []
    for shape, impls in training_rows()[-2:]:
        twin = None
        for spec in generate_config_combinations(impls)["spmd"]:
            impl = load_impl_class("transformer_step", "spmd")(
                *shape, dtype="bfloat16", device="cuda", **spec)
            impl.run()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            impl.run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - resident
            v = spec.get("virtual", 1)
            tables = build_schedule(spec["schedule"], 1, spec["microbatches"], v)
            slot = spec["batch"] // spec["microbatches"] * shape[0] * shape[1] * 2
            twin = peak if spec["schedule"] == "gpipe" else twin
            out.append({"schedule": spec["schedule"], "virtual": v,
                        "microbatches": spec["microbatches"], "peak_step_bytes": peak,
                        "gpipe_twin_bytes": twin, "stash_slots": tables.peak_stash,
                        "stash_slot_bytes": slot,
                        "bubble_fraction": tables.bubble_fraction})
            del impl
            torch.cuda.empty_cache()
    print(json.dumps({"schedule_memory": out, "card": smi}))
    return out


# -- the pipeline path: the pp_pipeline family ------------------------------

#: the pipeline family's configs, driven as shipped (the JAX member names
#: jax_spmd and xla_gspmd run as pytorch and compiled)
PP_CONFIGS = ("config_pp_pipeline.json", "config_schedules.json")


def pp_path(run_benchmark, counts, smi):
    """Drive ``PP_CONFIGS`` as shipped, each through the sweep runner with
    its own shape, warmups and iterations. The chain's products are
    ``torch.matmul``, as the JAX members' are ``jnp.matmul`` outside any
    Pallas kernel: the path launches no hand kernel, and this fails unless
    every count stays 0. Prints each ``schedules`` row's bubble fraction
    and stash slots from its tables on a line of its own. Returns the
    rows."""
    from ddlb_tpu_torch.utils.pipeline_schedule import build_schedule

    start = counts()
    rows = []
    for config in PP_CONFIGS:
        with open(os.path.join("scripts", config)) as f:
            cfg = json.load(f)["benchmark"]
        shape = (cfg["m"][0], cfg["n"][0], cfg["k"][0])
        got = drive_path(run_benchmark, "cuda", "pp_pipeline", shape, cfg["implementations"],
                         warmups=cfg["num_warmups"], iterations=cfg["num_iterations"])
        for row in got:
            if row["base_implementation"] != "schedules":
                continue
            o = row_options(row)
            tables = build_schedule(o["schedule"], row["world_size"],
                                    int(o["microbatches"]), int(o["virtual"]))
            print(json.dumps({
                "pp_schedule": o["schedule"], "virtual": tables.virtual,
                "microbatches": tables.microbatches, "shape": list(shape),
                "median_ms": row["median time (ms)"], "ticks": tables.ticks,
                "bubble_fraction": tables.bubble_fraction,
                "peak_stash": tables.peak_stash, "card": smi,
            }))
        rows += got
    end = counts()
    launched = {key: end[key] - start[key] for key in end if end[key] != start[key]}
    if launched:
        fail(f"hand kernels launched on the pipeline path: {launched}")
    return rows


# -- the collective trio's path: collectives, dp/ep cuda and overlap ----------

#: the members of scripts/config_collectives.json the port carries
#: (compute_only, jax_spmd as pytorch, pallas as cuda, xla_gspmd as
#: compiled) at both its shapes;
#: then dp_allreduce and ep_alltoall at their configs' 8192^3 bf16: the
#: cuda member's two algorithms and every overlap entry of
#: scripts/config_dp_allreduce.json and config_ep_alltoall.json
TRIO_CONFIGS = ("config_collectives.json", "config_ep_alltoall.json",
                "config_dp_allreduce.json")
TRIO_KERNEL_ALGORITHM = {"dp_allreduce": "ring_rdma", "ep_alltoall": "a2a_rdma"}


def trio_rows():
    """(primitive, shape, implementations) of the trio path, in order."""
    out = []
    for config in TRIO_CONFIGS:
        with open(os.path.join("scripts", config)) as f:
            cfg = json.load(f)["benchmark"]
        primitive, n, k = cfg["primitive"], cfg["n"][0], cfg["k"][0]
        impls = {}
        for block in cfg["implementations"]:
            block = dict(block)
            name = block.pop("name")
            if primitive == "collectives" and name in ("compute_only", "jax_spmd", "pallas",
                                                       "xla_gspmd"):
                impls.setdefault(name, []).append(block)
            elif name == "overlap":
                impls.setdefault(name, []).append(block)
        if primitive != "collectives":
            algorithm = TRIO_KERNEL_ALGORITHM[primitive]
            impls["cuda"] = [{"algorithm": ["xla_collective", algorithm]}]
        out += [(primitive, (m, n, k), impls) for m in cfg["m"]]
    return out


def expected_trio_launches(row, calls):
    """The kernel launches one trio row makes in ``calls`` measured calls at
    world 1: the collectives cuda member K4 (``all_gather``), K5
    (``reduce_scatter``) or both (``all_reduce``); the dp and ep cuda
    members K1 under ``xla_collective``, K3 (dp ``ring_rdma``) or K6 (ep
    ``a2a_rdma``); no other row launches a kernel."""
    want = {}
    if row["base_implementation"] != "cuda":
        return want
    o = row_options(row)
    if row["primitive"] == "collectives":
        if o["op"] in ("all_gather", "all_reduce"):
            want["k4"] = calls
        if o["op"] in ("reduce_scatter", "all_reduce"):
            want["k5"] = calls
    elif o["algorithm"] == "xla_collective":
        want["k1"] = calls
    elif row["primitive"] == "dp_allreduce":
        want["rs"] = calls
    else:
        want["k6"] = calls
    return want


def trio_path(run_benchmark, counts, smi):
    """Drive every trio row (one ``run_benchmark`` call per row, counts read
    around each) and check each row's launches exactly and the collectives
    rows' unit (GB/s). Returns the launch totals of the path."""
    import torch
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    calls = NUM_WARMUPS + NUM_ITERATIONS + 1
    total_start = counts()
    for primitive, shape, impls in trio_rows():
        for impl_id, spec in assign_impl_ids(generate_config_combinations(impls)).items():
            name = spec.pop("implementation")
            before = counts()
            (row,) = drive_path(run_benchmark, "cuda", primitive, shape, {name: [spec]},
                                extra_keys=("unit",))
            after = counts()
            got = {key: after[key] - before[key] for key in after}
            want = dict.fromkeys(got, 0)
            want.update(expected_trio_launches(row, calls))
            if got != want:
                fail(f"trio row {primitive} {row['base_implementation']} {row['option']}: "
                     f"launches {got}, expected {want}")
            unit = "GB/s" if primitive == "collectives" else "TFLOPS"
            if row["unit"] != unit:
                fail(f"trio row {primitive} {row['option']}: unit {row['unit']}, not {unit}")
        torch.cuda.empty_cache()
    end = counts()
    return {key: end[key] - total_start[key] for key in end}


# -- the topology path: the compositions and the transport axis ----------------

#: the configs whose composed entries (jax_spmd_hier / jax_spmd_striped, the
#: port's pytorch_hier / pytorch_striped) the topology path drives, in an
#: order that reuses the host oracle the trio path left (dp's 8192^3)
TOPOLOGY_CONFIGS = ("config_dp_allreduce.json", "config_ep_alltoall.json",
                    "config_collectives.json")
#: the topology path's rows are checks, not timings: few calls a row
TOPOLOGY_WARMUPS, TOPOLOGY_ITERATIONS = 1, 2


def topology_rows():
    """(primitive, shape, implementations) of the topology path, in order:
    the ``transport=dcn`` entries of ``config_transport_sweep.json`` (its
    ``ici`` entries, the default transport, are rows of the GEMM path at
    the same shape: ``pytorch`` AG_before, ``overlap`` p2p_pipeline and
    chunked 4, ``compiled``) and the ``cuda`` member of both tp families
    under ``transport=dcn`` (K1), then each config's composed entries at
    its first shape."""
    with open(os.path.join("scripts", "config_transport_sweep.json")) as f:
        cfg = json.load(f)["benchmark"]
    shape = (cfg["m"][0], cfg["n"][0], cfg["k"][0])
    dcn = {name: [dict(block, transport=["dcn"]) for block in blocks]
           for name, blocks in cfg["implementations"].items()}
    out = [(cfg["primitive"], shape, {**dcn, "cuda": [{"transport": ["dcn"]}]}),
           ("tp_rowwise", shape, {"cuda": [{"transport": ["dcn"]}]})]
    for config in TOPOLOGY_CONFIGS:
        with open(os.path.join("scripts", config)) as f:
            cfg = json.load(f)["benchmark"]
        impls = {}
        for block in cfg["implementations"]:
            block = dict(block)
            name = block.pop("name")
            if name in ("jax_spmd_hier", "jax_spmd_striped"):
                impls.setdefault(name, []).append(block)
        out.append((cfg["primitive"], (cfg["m"][0], cfg["n"][0], cfg["k"][0]), impls))
    return out


def topology_path(run_benchmark, counts):
    """Drive every topology row at world 1 (one ``run_benchmark`` call per
    row, counts read around each): each must be valid, a composed row must
    carry the composition it asked for (``auto`` resolves ``flat`` on one
    node), and the launches must be exact: K1 once a call in the ``cuda``
    rows, nothing in the others. Returns the launch totals of the path."""
    from ddlb_tpu_torch.cli.benchmark import assign_impl_ids, generate_config_combinations

    calls = TOPOLOGY_WARMUPS + TOPOLOGY_ITERATIONS + 1
    total_start = counts()
    for primitive, shape, impls in topology_rows():
        for spec in assign_impl_ids(generate_config_combinations(impls)).values():
            name = spec.pop("implementation")
            before = counts()
            (row,) = drive_path(run_benchmark, "cuda", primitive, shape, {name: [spec]},
                                warmups=TOPOLOGY_WARMUPS, iterations=TOPOLOGY_ITERATIONS,
                                extra_keys=("composition",))
            after = counts()
            got = {key: after[key] - before[key] for key in after}
            want = dict.fromkeys(got, 0)
            if row["base_implementation"] == "cuda":
                want["k1"] = calls
            if got != want:
                fail(f"topology row {primitive} {row['option']}: launches {got}, "
                     f"expected {want}")
            if name in ("jax_spmd_hier", "jax_spmd_striped"):
                asked = spec.get("composition", "striped" if "striped" in name else
                                 "hierarchical")
                if row.get("composition") != {"auto": "flat"}.get(asked, asked):
                    fail(f"topology row {primitive} {row['option']}: composition "
                         f"{row.get('composition')!r}, asked {asked!r}")
    end = counts()
    return {key: end[key] - total_start[key] for key in end}


def head_phase(run_benchmark, smi):
    """The LM head's product before and after it moved to the tensor
    cores: the full-width training row (train, the block router) and a
    pallas decode row at m = 8192, each driven four times in one process,
    alternating the head (tensor cores, float32, float32, tensor cores).
    "float32" is the product the port used before, ``torch.matmul`` of the
    upcast operands (the SIMT cores, TF32 off), put back in the models for
    the row; "tensor_cores" is ``ops.accum.float32_product``. Prints the
    rows' medians; fails unless every row is valid."""
    import torch
    from ddlb_tpu_torch.models import decode as dec
    from ddlb_tpu_torch.models import transformer as tm
    from ddlb_tpu_torch.ops import accum

    def float32_head(h, w):
        return torch.matmul(h.float(), w.float())

    wide_shape, wide = training_rows()[1]
    train = {"spmd": [dict(wide["spmd"][0], mode=["train"])]}
    decode = {"spmd": [{"phase": "decode", "attn_kernel": "flash",
                        "decode_kernel": "pallas", **SERVE_COMMON}]}
    rows = (("train", "transformer_step", wide_shape, train, TRAIN_WARMUPS, TRAIN_ITERATIONS),
            ("decode", "transformer_decode", (PATH_MNK, SERVE_N, SERVE_K), decode, 2, 8))
    medians = {}
    for label, primitive, shape, impls, warmups, iterations in rows:
        for head in ("tensor_cores", "float32", "float32", "tensor_cores"):
            fn = accum.float32_product if head == "tensor_cores" else float32_head
            tm.float32_product = dec.float32_product = fn
            try:
                (row,) = drive_path(run_benchmark, "cuda", primitive, shape, impls,
                                    warmups=warmups, iterations=iterations)
            finally:
                tm.float32_product = dec.float32_product = accum.float32_product
            medians.setdefault(label, {}).setdefault(head, []).append(
                row["median time (ms)"])
            torch.cuda.empty_cache()
    print(json.dumps({"head_product_ms": medians, "card": smi}))
    return medians


# -- the telemetry phase ------------------------------------------------------------


#: the telemetry phase's rows: tp_columnwise ``cuda`` at 4096^3 bf16 (K1),
#: then a serving_load ``engine`` row at the serving width with a short
#: drain (8 requests at 400/s: K8a prefills, K12 ticks), both on the host
#: clock with a barrier before every timed call
TELEMETRY_MNK = 4096
TELEMETRY_ITERATIONS = 10
TELEMETRY_SERVING = {"rate": 400.0, **SERVING_LOAD_COMMON, "n_requests": 8}
#: the kernels the profiler window must show by name, with the counter
#: whose rise over the window they must equal: K1, K8a and K12
PROFILED_KERNELS = (("k1", "k1_hopper::gemm_wgmma"), ("k8a", "tri::flash_fwd_wgmma"),
                    ("k12", "decode_mma"))
#: the span categories totalled per row
TELEMETRY_CATEGORIES = ("setup", "warmup", "profile", "timing", "validate", "barrier")


def telemetry_phase(smi):
    """Run ``telemetry_child`` in a process of its own, with
    ``DDLB_TPU_TRACE`` set to a temporary directory (a fresh process: the
    allocator's peak starts at zero, so the first row raises it). The child
    fails the run unless every check holds; its figures come back as one
    JSON line, printed here. Returns its launch counts (K1, K8a, K12) for
    the ``kernels`` line."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    out = os.path.join(tmp, "result.json")
    env = dict(os.environ, DDLB_TPU_TRACE=os.path.join(tmp, "trace"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--telemetry-child", tmp, out],
                              env=env, timeout=300)
        if proc.returncode != 0:
            fail(f"the telemetry phase failed (exit {proc.returncode})")
        with open(out) as f:
            result = json.load(f)
    except subprocess.TimeoutExpired:
        fail("the telemetry phase did not end within 300 s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["seconds"] = round(time.perf_counter() - t0, 1)
    result["card"] = smi
    print(json.dumps({"telemetry": result}))
    return result["launches"]


def _row_spans(events, impl_id):
    """The ``worker.row`` span of ``impl_id`` and the spans inside it (same
    process and thread, within its extent)."""
    rows = [e for e in events if e.get("ph") == "X" and e["name"] == "worker.row"
            and e["args"].get("impl") == impl_id]
    if len(rows) != 1:
        fail(f"telemetry: {len(rows)} worker.row spans for {impl_id}, expected 1")
    (row,) = rows
    end = row["ts"] + row["dur"] + 1.0

    def inside(e):
        return (e is not row and e["pid"] == row["pid"] and e["tid"] == row["tid"]
                and row["ts"] - 1.0 <= e["ts"] <= end
                and e["ts"] + e.get("dur", 0.0) <= end)

    return row, [e for e in events if e.get("ph") in ("X", "i") and inside(e)]


def _profiled_kernels(path):
    """Kernel events of a profiler Chrome trace by ``PROFILED_KERNELS``
    key, and the names of the kernels seen."""
    with open(path) as f:
        trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]
    counts = {key: sum(1 for e in kernels if symbol in e.get("name", ""))
              for key, symbol in PROFILED_KERNELS}
    return counts, sorted({e.get("name", "")[:80] for e in kernels})


def telemetry_child(tmp, out_path):
    """The telemetry phase (``DDLB_TPU_TRACE`` set by the parent): the two
    rows of ``TELEMETRY_*`` through the sweep runner with ``profile_dir``
    set, then every check of the phase against the trace, the rows, the
    launch counters and the profiler's Chrome traces; then the tp row
    six times more, tracing off and on in turns, for the spans' cost.
    Writes the figures to ``out_path``; exits non-zero on the first
    failed check."""
    import torch
    import torch.profiler
    from ddlb_tpu_torch import telemetry
    from ddlb_tpu_torch.benchmark import benchmark_worker
    from ddlb_tpu_torch.cli.benchmark import run_benchmark
    from ddlb_tpu_torch.ops import _build
    from ddlb_tpu_torch.ops import decode_attention as da
    from ddlb_tpu_torch.ops import flash_attention as fa
    from ddlb_tpu_torch.ops import matmul as k1
    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.telemetry import clocksync

    if not torch.cuda.is_available():
        fail("telemetry: no card")
    trace_dir, profile_dir = os.environ["DDLB_TPU_TRACE"], os.path.join(tmp, "profile")
    _build.build("matmul", "flash_attention", "decode_attention")
    for mod in (k1, fa, da):
        mod.reset_launches()

    def tiles():
        return {"k1": sum(k1.TILES.values()), "k8a": fa.FORWARD_TILES["wgmma"],
                "k12": da.DECODE_TILES["mma"]}

    windows = []

    class CountedProfile(torch.profiler.profile):
        """The runner's profiler, with the kernels' counters read at the
        window's edges (``torch.profiler.profile`` is looked up at call
        time, so the runner takes this one)."""

        def __enter__(self):
            self._before = tiles()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            after = tiles()
            windows.append({k: after[k] - self._before[k] for k in after})
            return out

    torch.profiler.profile = CountedProfile
    specs = (("tp_columnwise", (TELEMETRY_MNK,) * 3, {"cuda": [{}]}, "bfloat16",
              NUM_WARMUPS, TELEMETRY_ITERATIONS),
             ("serving_load", (SERVING_LOAD_M, SERVE_N, SERVE_K),
              {"engine": [TELEMETRY_SERVING]}, "bfloat16", 1, 2))
    rows, figures = [], []
    for primitive, (m, n, k), impls, dtype, warmups, iterations in specs:
        before_ticks = telemetry.global_snapshot().get("serve.ticks", 0.0)
        launches_before = tiles()
        (row,) = run_benchmark({
            "primitive": primitive, "m": m, "n": n, "k": k, "dtype": dtype,
            "validate": True, "num_iterations": iterations, "num_warmups": warmups,
            "time_measurement_backend": "host_clock", "barrier_at_each_iteration": True,
            "device": "cuda", "profile_dir": profile_dir,
            "output_csv": os.path.join(tmp, f"{primitive}.csv"), "implementations": impls,
        })
        ticks = telemetry.global_snapshot().get("serve.ticks", 0.0) - before_ticks
        launched = {key: tiles()[key] - launches_before[key] for key in launches_before}
        impl_id = row["implementation"]
        if not (row["valid"] and not row["error"] and math.isfinite(row["median time (ms)"])):
            fail(f"telemetry: {primitive} row not valid: {row['error']}")
        if not row["barrier_wait_s"] > 0.0:
            fail(f"telemetry: {primitive} barrier_wait_s {row['barrier_wait_s']}")
        if not rows and not row["hbm_high_water_bytes"] > 0:
            fail(f"telemetry: the process's first row has hbm_high_water_bytes "
                 f"{row['hbm_high_water_bytes']}")
        impl = load_impl_class(primitive, row["base_implementation"])
        wire = getattr(impl, "wire_bytes", None)
        if wire is not None:
            built = impl(m, n, k, dtype=dtype, device="cuda")
            want_wire = built.wire_bytes()
            del built
        else:
            want_wire = telemetry.ROW_METRIC_DEFAULTS["collective_bytes"]
        if row["collective_bytes"] != want_wire:
            fail(f"telemetry: {primitive} collective_bytes {row['collective_bytes']} "
                 f"!= wire_bytes() {want_wire}")
        skew = {key: row[key] for key in clocksync.SKEW_ROW_DEFAULTS}
        if repr(skew) != repr(clocksync.SKEW_ROW_DEFAULTS):
            fail(f"telemetry: {primitive} skew columns at world 1: {skew}")
        # the trace: one row span, its phases nested, a barrier and an
        # exchange per timed call
        events = telemetry.read_events(trace_dir)
        span, inner = _row_spans(events, impl_id)
        names = [e["name"] for e in inner]
        for phase in ("worker.setup", "worker.warmup", "worker.profile", "worker.timing",
                      "worker.validate"):
            if names.count(phase) != 1:
                fail(f"telemetry: {primitive} row holds {names.count(phase)} {phase}")
        barriers, exchanges = names.count("runtime.barrier"), names.count("clocksync.exchange")
        if not barriers == exchanges == iterations:
            fail(f"telemetry: {primitive} row: {barriers} runtime.barrier spans and "
                 f"{exchanges} clocksync.exchange instants for {iterations} barriers")
        if primitive == "serving_load":
            drains = names.count("serve.drain")
            marked = sum(e["args"]["steps"] for e in inner if e["name"] == "serve.ticks")
            if not (drains == row["drains"] and marked == ticks == row["drain_ticks"] > 0):
                fail(f"telemetry: serve.drain spans {drains} (drains {row['drains']}), "
                     f"serve.ticks instants count {marked}, metric {ticks}, "
                     f"drain_ticks {row['drain_ticks']}")
        if not os.path.isfile(os.path.join(trace_dir, "trace.json")):
            fail("telemetry: the runner merged no trace.json")
        # the profiler window: its kernel events by name against the
        # counters' rise over the same window
        window = windows[-1]
        seen, kernel_names = _profiled_kernels(
            os.path.join(profile_dir, f"{impl_id}-p0.json"))
        want = ("k1",) if primitive == "tp_columnwise" else ("k8a", "k12")
        for key in want:
            if not window[key] or seen[key] != window[key]:
                fail(f"telemetry: {primitive} profiler trace shows {seen[key]} "
                     f"{dict(PROFILED_KERNELS)[key]} kernels, the counters rose "
                     f"{window[key]} (kernels seen: {kernel_names})")
        categories = {}
        for e in inner:
            if e.get("ph") == "X" and e["cat"] in TELEMETRY_CATEGORIES:
                categories[e["cat"]] = categories.get(e["cat"], 0.0) + e["dur"] * 1e-6
        figures.append({
            "primitive": primitive, "shape": [m, n, k], "median_ms": row["median time (ms)"],
            "row_s": span["dur"] * 1e-6, "seconds_by_category": categories,
            **{key: row[key] for key in ("barrier_wait_s", "loop_overhead_s",
                                         "hbm_high_water_bytes", "collective_bytes",
                                         "hbm_peak_gib")},
            "profiled": {key: seen[key] for key in want}, "launches": launched,
        })
        rows.append(row)
        torch.cuda.empty_cache()
    # the spans' cost: the tp row with tracing off and on, in turns
    config = {"primitive": "tp_columnwise", "impl_id": "cuda_0",
              "base_implementation": "cuda", "m": TELEMETRY_MNK, "n": TELEMETRY_MNK,
              "k": TELEMETRY_MNK, "dtype": "bfloat16", "num_iterations": 5 * TELEMETRY_ITERATIONS,
              "num_warmups": NUM_WARMUPS, "device": "cuda"}
    overhead = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off", "off", "on"):
        if turn == "off":
            os.environ.pop("DDLB_TPU_TRACE", None)
        else:
            os.environ["DDLB_TPU_TRACE"] = trace_dir
        row = benchmark_worker(config)
        if not row["valid"]:
            fail(f"telemetry: the tracing-{turn} tp row is not valid: {row['error']}")
        overhead[turn].append(row["median time (ms)"])
    launches = {"k1": k1.LAUNCHES, "tri": fa.LAUNCHES["tri"], "paged": da.LAUNCHES["paged"]}
    if k1.TILES["wgmma"] != k1.LAUNCHES or da.DECODE_TILES["mma"] != da.LAUNCHES["paged"] \
            or fa.FORWARD_TILES["wgmma"] != fa.LAUNCHES["tri"]:
        fail(f"telemetry: launches by tile {k1.TILES} {fa.FORWARD_TILES} {da.DECODE_TILES}")
    others = {key: n for key, n in {**fa.LAUNCHES, **da.LAUNCHES}.items()
              if key not in ("tri", "paged") and n}
    if others:
        fail(f"telemetry: other kernels launched: {others}")
    with open(out_path, "w") as f:
        json.dump({"rows": figures, "median_ms_tracing": overhead, "launches": launches}, f)


def check_tiles(what, k1, cm, fa):
    """Every K1, K2 and K3 launch of a path ran the Hopper tile, every K8a
    launch the tri wgmma forward, every K8b and K9 launch the band wgmma
    forward, every K10a/K10b pass (``bwd_*_tri``) the tri_bwd wgmma
    backward and every K10c/K10d pass (``bwd_*_rect``) the band_bwd
    backward (the main paths are bf16, at 16-byte widths). Returns the
    path's launches by tile."""
    for name, tiles, launched in (("K1", k1.TILES, k1.LAUNCHES),
                                  ("K2", cm.TILES, cm.LAUNCHES["ag"]),
                                  ("K3", cm.RS_TILES, cm.LAUNCHES["rs"])):
        want = {"wgmma": launched, "wmma": 0, "simt": 0}
        if tiles != want:
            fail(f"{name}'s launches by tile on {what}: {tiles}, expected {want}")
    want_fa = {"wgmma": fa.LAUNCHES["tri"], "band": fa.LAUNCHES["rect"] + fa.LAUNCHES["chunk"],
               "simt": 0}
    if fa.FORWARD_TILES != want_fa:
        fail(f"the flash forward's launches by kernel on {what}: {fa.FORWARD_TILES}, "
             f"expected {want_fa}")
    want_bwd = {"wgmma": fa.LAUNCHES["bwd_dq_tri"] + fa.LAUNCHES["bwd_dkv_tri"],
                "band": fa.LAUNCHES["bwd_dq_rect"] + fa.LAUNCHES["bwd_dkv_rect"], "simt": 0}
    if fa.BACKWARD_TILES != want_bwd:
        fail(f"the flash backward's passes by kernel on {what}: {fa.BACKWARD_TILES}, "
             f"expected {want_bwd}")
    return {"k1": dict(k1.TILES), "k2": dict(cm.TILES), "k3": dict(cm.RS_TILES),
            "flash_forward": dict(fa.FORWARD_TILES), "flash_backward": dict(fa.BACKWARD_TILES)}


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
        from ddlb_tpu_torch.ops import alltoall_matmul as am
        from ddlb_tpu_torch.ops import collective_matmul as cm
        from ddlb_tpu_torch.ops import decode_attention as da
        from ddlb_tpu_torch.ops import flash_attention as fa
        from ddlb_tpu_torch.ops import matmul as k1
        from ddlb_tpu_torch.ops import quantized_matmul as qm
        from ddlb_tpu_torch.ops import ring_collectives as rc
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
    libs = ("matmul", "flash_attention", "decode_attention", "quantized_matmul",
            "collective_matmul", "ring_collectives", "alltoall_matmul")
    t0 = time.perf_counter()
    _build.build(*libs)
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas ({name}):", line.strip())
    matmul_entry = kernel_phase_matmul(k1, smi)
    ring_entries = kernel_phase_ring(cm, k1, smi)
    trio_entries = kernel_phase_trio(rc, am, k1, smi)
    forward_entry, chunk_entry = kernel_phase_flash(fa, smi)
    forward_entry["serving_prefill"] = kernel_phase_flash_serving(fa, smi)
    decode_entry, paged_entry = kernel_phase_decode(da, smi)
    int8_entry = kernel_phase_int8(qm, smi)
    torch.cuda.empty_cache()
    backward_entries = kernel_phase_flash_backward(fa, smi)
    torch.cuda.empty_cache()
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    def reset():
        k1.reset_launches()
        qm.reset_launches()
        fa.reset_launches()
        da.reset_launches()
        cm.reset_launches()
        rc.reset_launches()
        am.reset_launches()

    def trio_counts():
        return {"k4": rc.LAUNCHES["ag"], "k5": rc.LAUNCHES["rs"], "k6": am.LAUNCHES["a2a"]}

    def counts():
        return {"k1": k1.LAUNCHES, **cm.LAUNCHES, **trio_counts(), **fa.LAUNCHES,
                **da.LAUNCHES, "int8": qm.LAUNCHES}

    # 3. the main paths, each with the counts zeroed just before it
    launches, tiles = {}, {}
    reset()
    rows = []
    for primitive, implementations in GEMM_SWEEPS.items():
        rows += drive_path(run_benchmark, "cuda", primitive,
                           (PATH_MNK, PATH_MNK, PATH_MNK), implementations)
    gemm_launches = {"k1": k1.LAUNCHES, **cm.LAUNCHES}
    others = {**fa.LAUNCHES, **da.LAUNCHES, "int8": qm.LAUNCHES, **trio_counts()}
    # each cuda row runs its kernel once per warmup, per timed iteration
    # and for validation: K1 under xla_collective, K2 (tp_columnwise) or K3
    # (tp_rowwise) under ring_rdma; no other row launches any of them
    per_row = NUM_WARMUPS + NUM_ITERATIONS + 1
    expected = {"k1": 0, "ag": 0, "rs": 0}
    for r in rows:
        if r["base_implementation"] != "cuda":
            continue
        if row_options(r)["algorithm"] == "ring_rdma":
            expected["ag" if r["primitive"] == "tp_columnwise" else "rs"] += per_row
        else:
            expected["k1"] += per_row
    if gemm_launches != expected or not all(expected.values()):
        fail(f"K1/K2/K3 launched {gemm_launches} on the GEMM path, expected {expected}")
    if any(others.values()):
        fail(f"other kernels launched on the GEMM path: {others}")
    tiles["gemm"] = check_tiles("the GEMM path", k1, cm, fa)
    launches["gemm"] = gemm_launches
    print(f"GEMM path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    rows = []
    for primitive, implementations in QUANT_SWEEPS.items():
        rows += drive_path(run_benchmark, "cuda", primitive,
                           (PATH_MNK, PATH_MNK, PATH_MNK), implementations)
        torch.cuda.empty_cache()
    int8_launches = qm.LAUNCHES
    others = {**fa.LAUNCHES, **da.LAUNCHES, "k1": k1.LAUNCHES, **cm.LAUNCHES,
              **trio_counts()}
    # each kernel=pallas row runs K7 once per warmup, per timed iteration
    # and for validation; no kernel=xla row and no other member may
    # launch it
    pallas_rows = sum(1 for r in rows if r["base_implementation"] == "quantized"
                      and row_options(r)["kernel"] == "pallas")
    expected = pallas_rows * (NUM_WARMUPS + NUM_ITERATIONS + 1)
    if int8_launches != expected or int8_launches == 0:
        fail(f"K7 launched {int8_launches} times on the quantized path, expected {expected}")
    # at 8192^3 on the members' column-major weights, every launch on wgmma
    if qm.TILES != {"wgmma": int8_launches, "small_m": 0, "mma": 0}:
        fail(f"K7's launches by tile on the quantized path: {qm.TILES}, expected "
             f"{int8_launches} on wgmma")
    if any(others.values()):
        fail(f"other kernels launched on the quantized path: {others}")
    launches["quantized"] = {"int8": int8_launches, **int8_tile_counts(qm)}
    print(f"quantized path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    trio_launches = trio_path(run_benchmark, counts, smi)
    missing = [key for key in ("k1", "rs", "k4", "k5", "k6") if not trio_launches[key]]
    if missing:
        fail(f"the trio path did not launch {missing}: {trio_launches}")
    # K6 at 8192^3 bf16 runs the Hopper tile, every launch
    if am.TILES != {"wgmma": trio_launches["k6"], "simt": 0}:
        fail(f"K6's launches by tile on the trio path: {am.TILES}, expected "
             f"{trio_launches['k6']} on wgmma")
    tiles["trio"] = check_tiles("the trio path", k1, cm, fa)
    launches["trio"] = {key: n for key, n in trio_launches.items() if n}
    print(f"trio path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    t0 = time.perf_counter()
    topology_launches = topology_path(run_benchmark, counts)
    if not topology_launches["k1"]:
        fail(f"the topology path did not launch K1: {topology_launches}")
    tiles["topology"] = check_tiles("the topology path", k1, cm, fa)
    launches["topology"] = {key: n for key, n in topology_launches.items() if n}
    print(f"topology path done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t0:.1f} s)")

    reset()
    rows = []
    for implementations in ATTN_SWEEPS:
        rows += drive_path(run_benchmark, "cuda", "cp_ring_attention",
                           (ATTN_M, ATTN_N, ATTN_K), implementations)
        torch.cuda.empty_cache()
    flash_launches = dict(fa.LAUNCHES)
    others = {**da.LAUNCHES, "k1": k1.LAUNCHES, "int8": qm.LAUNCHES, **cm.LAUNCHES,
              **trio_counts()}
    expected = expected_flash_launches(rows)
    if flash_launches != expected or not all(
            flash_launches[key] for key in ("tri", "rect", "chunk")):
        fail(f"flash kernels launched {flash_launches} on the attention "
             f"path, expected {expected}")
    if any(others.values()):
        fail(f"K1, K7 or the decode kernels launched on the attention path: {others}")
    tiles["attention"] = check_tiles("the attention path", k1, cm, fa)
    launches["attention"] = flash_launches
    print(f"attention path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    serving_launches, _ = serving_path(run_benchmark, k1, fa, da, qm, smi)
    if not (serving_launches["decode"] and serving_launches["paged"]
            and serving_launches["tri"] and serving_launches["int8"]):
        fail(f"the serving path did not launch K11, K12, K8a and K7: {serving_launches}")
    # every decode row of the path is bf16: each K11/K12 launch on the
    # tensor-core design
    want_tiles = {"mma": serving_launches["decode"] + serving_launches["paged"], "simt": 0}
    if da.DECODE_TILES != want_tiles:
        fail(f"K11/K12 launches by design on the serving path: {da.DECODE_TILES}, "
             f"expected {want_tiles}")
    if any(cm.LAUNCHES.values()) or any(trio_counts().values()):
        fail(f"K2-K6 launched on the serving path: {cm.LAUNCHES} {trio_counts()}")
    tiles["serving"] = check_tiles("the serving path", k1, cm, fa)
    launches["serving"] = serving_launches
    print(f"serving path done at {time.perf_counter() - t_start:.1f} s")

    for path, drive, needed in (("speculate", speculate_path, ("tri", "decode")),
                                ("serving_load", serving_load_path, ("tri", "paged")),
                                ("serving_cluster", serving_cluster_path, ("tri", "paged"))):
        reset()
        path_launches, _ = drive(run_benchmark, k1, fa, da, qm, smi)
        missing = [key for key in needed if not path_launches[key]]
        if missing:
            fail(f"the {path} path did not launch {missing}: {path_launches}")
        # bf16 throughout: every K11/K12 launch (the chain checks' included)
        # on the tensor-core design
        want_mma = {"mma": da.LAUNCHES["decode"] + da.LAUNCHES["paged"], "simt": 0}
        if da.DECODE_TILES != want_mma:
            fail(f"K11/K12 launches by design on the {path} path: {da.DECODE_TILES}, "
                 f"expected {want_mma}")
        others = {key: path_launches[key] for key in path_launches
                  if key not in ("tri", "decode", "paged")}
        if any(others.values()) or any(cm.LAUNCHES.values()) or any(trio_counts().values()):
            fail(f"other kernels launched on the {path} path: {others} {cm.LAUNCHES} "
                 f"{trio_counts()}")
        tiles[path] = check_tiles(f"the {path} path", k1, cm, fa)
        launches[path] = {key: n for key, n in path_launches.items() if n}
        print(f"{path} path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    training_launches = training_path(run_benchmark, k1, fa, da, qm, smi)
    missing = [key for key in ("tri", "rect", "chunk", "int8", *BWD_KEYS)
               if not training_launches[key]]
    if missing:
        fail(f"the training path did not launch {missing}: {training_launches}")
    if any(cm.LAUNCHES.values()) or any(trio_counts().values()):
        fail(f"K2-K6 launched on the training path: {cm.LAUNCHES} {trio_counts()}")
    tiles["training"] = check_tiles("the training path", k1, cm, fa)
    launches["training"] = training_launches
    schedule_memory(smi)
    print(f"training path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    router_launches = training_path(run_benchmark, k1, fa, da, qm, smi, router_rows(),
                                    key="router_row")
    missing = [key for key in ("tri", "int8", "bwd_dq_tri", "bwd_dkv_tri")
               if not router_launches[key]]
    if missing:
        fail(f"the router path did not launch {missing}: {router_launches}")
    if any(cm.LAUNCHES.values()) or any(trio_counts().values()):
        fail(f"K2-K6 launched on the router path: {cm.LAUNCHES} {trio_counts()}")
    tiles["router"] = check_tiles("the router path", k1, cm, fa)
    launches["router"] = router_launches
    print(f"router path done at {time.perf_counter() - t_start:.1f} s")

    reset()
    pp_rows = pp_path(run_benchmark, counts, smi)
    launches["pipeline"] = {}
    print(f"pipeline path done ({len(pp_rows)} rows) at {time.perf_counter() - t_start:.1f} s")

    head_phase(run_benchmark, smi)
    print(f"head product phase done at {time.perf_counter() - t_start:.1f} s")

    # the telemetry phase runs in a process of its own; its counts are its
    # own process's, zeroed there before its rows
    launches["telemetry"] = telemetry_phase(smi)
    print(f"telemetry phase done at {time.perf_counter() - t_start:.1f} s")
    print(f"launches by path: {json.dumps(launches)}")
    print(f"K1, K2, K3 and flash launches by tile or kernel, by path: {json.dumps(tiles)}")

    # 4. results
    def total(key):
        return sum(path.get(key, 0) for path in launches.values())

    matmul_entry["launches"] = total("k1")
    for entry, key in zip(ring_entries, ("ag", "rs")):
        entry["launches"] = total(key)
    # K8a and K8b share an entry point; each has its own entry in the line
    rect_entry = forward_entry.pop("rect")
    forward_entry.pop("also_replaces")
    forward_entry["launches"] = total("tri")
    rect_entry["launches"] = total("rect")
    # K8a at the serving shapes: the prefills of the serving, speculate,
    # serving_load and serving_cluster paths
    forward_entry["serving_prefill"]["launches"] = sum(
        launches[path].get("tri", 0)
        for path in ("serving", "speculate", "serving_load", "serving_cluster", "telemetry"))
    chunk_entry["launches"] = total("chunk")
    # K8b and K9 by path; every launch ran band::flash_fwd_wgmma (check_tiles)
    rect_entry["launches_by_path"] = {path: n["rect"] for path, n in launches.items()
                                      if n.get("rect")}
    chunk_entry["launches_by_path"] = {path: n["chunk"] for path, n in launches.items()
                                       if n.get("chunk")}
    decode_entry["launches"] = total("decode")
    paged_entry["launches"] = total("paged")
    for entry, key in ((forward_entry, "tri"), (decode_entry, "decode"), (paged_entry, "paged")):
        entry["launches_by_path"] = {path: n[key] for path, n in launches.items()
                                     if n.get(key)}
    # K11 and K12 together on the serving path
    decode_entry["serving_tiles"] = paged_entry["serving_tiles"] = want_tiles
    int8_entry["launches"] = total("int8")
    int8_entry["launches_by_path"] = {
        "quantized": launches["quantized"]["int8"], "serving": serving_launches["int8"],
        "training": training_launches["int8"], "router": router_launches["int8"],
    }
    int8_entry["launches_by_tile"] = {
        t: total(f"int8_{t}") for t in ("wgmma", "small_m", "mma")}
    if int8_entry["launches_by_tile"]["mma"]:
        fail(f"K7 ran the mma tile on a main path: {int8_entry['launches_by_tile']}")
    for entry, key in zip(backward_entries, BWD_KEYS):
        entry["launches"] = total(key)
    for entry, key in zip(trio_entries, ("k4", "k5", "k6")):
        entry["launches"] = total(key)
    # K2, K3 and K6 ran the Hopper tile at the paths' shapes (asserted above)
    for entry, library, kernel in ((ring_entries[0], "collective_matmul", "ring_ag_wgmma_kernel"),
                                   (ring_entries[1], "collective_matmul", "ring_rs_wgmma_kernel"),
                                   (trio_entries[2], "alltoall_matmul", "a2a_wgmma_kernel")):
        entry["tile"] = "wgmma"
        entry["ptxas"] = ptxas_registers(library, kernel)
    trio_entries[0]["ptxas"] = ptxas_registers("ring_collectives", "ring_all_gather_kernel")
    trio_entries[1]["ptxas"] = ptxas_registers("ring_collectives", "ring_reduce_scatter_kernel")
    print(json.dumps({"compiled_rows": COMPILED_ROWS, "card": smi}))
    print(json.dumps({"kernels": [matmul_entry, *ring_entries, *trio_entries, int8_entry,
                                  forward_entry, rect_entry, chunk_entry,
                                  *backward_entries, decode_entry, paged_entry]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--telemetry-child"]:
        telemetry_child(*sys.argv[2:4])
    else:
        main()
