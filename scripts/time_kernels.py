"""Time K1, K8a, K8b, K9 and K10a-K10d, K7, or K11/K12, on one card, for one checkout.

    python scripts/time_kernels.py --tree DIR \
        [--phase flash|backward|int8|quantized_path|flash_paths|decode|decode_splits]
        [--label NAME]

Runs ``chip_smoke.py``'s kernel phases of the checkout at ``DIR``: with
``--phase flash`` (the default) ``kernel_phase_matmul`` (K1),
``kernel_phase_flash`` (K8a, K8b and K9), ``kernel_phase_flash_serving``
(K8a at the serving prefill's shape) and ``kernel_phase_flash_backward``
(K10a-K10d); with ``--phase backward`` ``backward_turns`` (this script's
own timing, the same for every checkout: the flash backward's two passes
through ``backward_pass`` at ``BACKWARD_SHAPES``, the rectangle's windowed
training row and a ``past`` ring chunk, and the triangle, beside SDPA's
backward on the same inputs and each pass's bound); with ``--phase
int8`` ``kernel_phase_int8`` alone (K7 at the
GEMM path's, the decode MLP's and the prefill MLP's shapes, with its
timed variants); with ``--phase quantized_path`` the rows of
``chip_smoke.py``'s quantized path (``QUANT_SWEEPS`` at 8192^3 bf16
through the sweep runner, validated; each row's median host-clock ms
under ``rows``); with ``--phase flash_paths`` the rows that run the flash
kernels: ``chip_smoke.py``'s attention path (``ATTN_SWEEPS`` at m =
16384, n = 1024, k = 128 bf16) and its training rows (``training_rows``),
each row's median host-clock ms under ``rows``; with ``--phase decode``
``kernel_phase_decode`` (K11 and K12 checked against their plain versions
and timed), then ``decode_turns`` (this script's own timing, the same for
every checkout: K11 MHA, GQA-4, int8 and int8 GQA-4 at b 8, 8193 keys, 16
heads of 128, bf16, and K12 at the serve pool, each back to back through
the wrapper, ``ms``, and from a CUDA graph, ``graph_ms``, beside SDPA, or
the page gather plus SDPA, on the same two timers, and the bound), then
the ``decode_kernel=pallas`` decode rows at m = 8192 (bf16 and int8 cache,
MHA and GQA-4) and the paged ``decode_kernel=pallas`` serve row at m =
2048, each row's median and p95 host-clock ms under ``rows``; with
``--phase decode_splits`` (a checkout whose wrapper plans its launches,
``reset_plans``) the same five shapes from a CUDA graph at every split
count of ``SPLIT_SWEEP``, the sweep ``num_splits``' constants are tuned
from. It uses that checkout's own
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
LIBRARIES = {"flash": ("matmul", "flash_attention"), "backward": ("flash_attention",),
             "int8": ("quantized_matmul",),
             "quantized_path": ("quantized_matmul",),
             "flash_paths": ("matmul", "flash_attention", "decode_attention",
                             "quantized_matmul"),
             "decode": ("matmul", "flash_attention", "decode_attention",
                        "quantized_matmul"),
             "decode_splits": ("decode_attention",)}
#: the split counts ``--phase decode_splits`` times
SPLIT_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
#: the decode shapes ``decode_turns`` times: (key, kv heads, int8, paged)
DECODE_SHAPES = (("mha", 16, False, False), ("gqa4", 4, False, False),
                 ("int8", 16, True, False), ("int8_gqa4", 4, True, False),
                 ("paged", 16, False, True))


#: the flash backward's shapes ``backward_turns`` times, bf16, 128-wide
#: heads: (key, sequence of q and of k, heads, row offset, col offset, mode,
#: window). ``window``: the world-1 training row with ``attn_window=1024``
#: (K10c/K10d); ``past``: a ring chunk wholly in the past at the training
#: ring rows' 2048 x 32 heads (K10c/K10d, no mask); ``tri``: the full-width
#: training row's triangle (K10a/K10b)
BACKWARD_SHAPES = (("window", 4096, 64, 0, 0, "offset", 1024),
                   ("past", 2048, 32, 2048, 0, "past", 0),
                   ("tri", 4096, 64, 0, 0, "offset", 0))


def backward_turns(cs, fa):
    """Each of ``BACKWARD_SHAPES``: the dQ and the dK/dV pass through
    ``fa.backward_pass`` (``cs.cuda_ms``, 10 calls a window) beside SDPA's
    backward (forward plus backward through autograd less the forward; all
    three gradients; no mask for ``past``, the band as a boolean mask for a
    window, ``is_causal`` for the triangle), two turns each, and each
    pass's bound (``cs.backward_bound``). Inputs as ``chip_smoke.py``'s
    check draws them (uniform, a generator seeded afresh; o and lse from
    the plain forward)."""
    import torch
    import torch.nn.functional as F

    out = {}
    for key, s, h, ro, co, mode, window in BACKWARD_SHAPES:
        dh, dtype = cs.DECODE_DH, torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
        q, k, v = cs.uniform_inputs(s, s, h, h, dh, dtype, gen)
        do = (torch.rand((s, h, dh), generator=gen, device="cuda") * 2 - 1).to(dtype)
        o, lse = cs.backward_forward(fa, q, k, v, ro, co, mode, window)
        delta = fa.attention_delta(o, do)
        kw = {"scale": dh ** -0.5, "row_offset": ro, "col_offset": co, "causal": mode,
              "window": window}
        dq = torch.empty((s, h, dh), dtype=torch.float32, device="cuda")
        dk, dv = torch.empty_like(dq), torch.empty_like(dq)
        qt, kt, vt = (x.transpose(0, 1)[None].contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(0, 1)[None].contiguous()
        sdpa_kw = {"scale": kw["scale"]}
        if mode == "offset" and window:
            pos_q = ro + torch.arange(s, device="cuda")[:, None]
            pos_k = co + torch.arange(s, device="cuda")[None, :]
            sdpa_kw["attn_mask"] = (pos_k <= pos_q) & (pos_k > pos_q - window)
        elif mode == "offset":
            sdpa_kw["is_causal"] = True

        def sdpa_forward():
            return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

        calls = {
            "dq": lambda: fa.backward_pass("dq", q, k, v, do, lse, delta, (dq,), **kw),
            "dkv": lambda: fa.backward_pass("dkv", q, k, v, do, lse, delta, (dk, dv), **kw),
            "sdpa_forward": sdpa_forward,
            "sdpa_forward_backward": lambda: torch.autograd.grad(sdpa_forward(), (qt, kt, vt),
                                                                 dot),
        }
        times = {name: [] for name in calls}
        for _ in range(2):
            for name, call in calls.items():
                times[name].append(cs.cuda_ms(call, 10))
        case = fa.backward_case(s, s, ro, co, mode, window)[0]
        out[key] = {
            "kernel": fa.backward_kernel(case, dtype),
            "dq_ms": min(times["dq"]), "dkv_ms": min(times["dkv"]),
            "sdpa_backward_ms": min(times["sdpa_forward_backward"]) - min(times["sdpa_forward"]),
            "bound_ms": {p: cs.backward_bound(fa, s, s, h, h, dh, 2, ro, co, mode, window, p)[0]
                         for p in ("dq", "dkv")},
            "turns": times,
        }
        print(f"backward {key}: {json.dumps(out[key])}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, qt, kt, vt, dot, sdpa_kw, calls
        torch.cuda.empty_cache()
    return out


def decode_shapes(cs, da, key, h_kv, int8, paged):
    """One of ``DECODE_SHAPES`` as ``chip_smoke.py``'s check draws it (a
    generator seeded afresh): (kernel call, library call or None, bound)."""
    import torch
    import torch.nn.functional as F

    b, h, dh = cs.DECODE_B, cs.DECODE_H, cs.DECODE_DH
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    S = cs.SERVE_PAGES * cs.PAGE_SIZE if paged else cs.DECODE_S
    if paged:  # ragged, as chip_smoke's check: 0, a parked lane, drawn
        pos = torch.randint(0, S, (b,), generator=gen, device="cuda").to(torch.int32)
        pos[0], pos[-1] = 0, S
    else:
        pos = torch.full((b,), S - 1, dtype=torch.int32, device="cuda")
    q, k, v, ks, vs, _, _ = cs.decode_inputs(b, S, h, h_kv, torch.bfloat16, int8,
                                             gen, False, pos)
    kw = {"k_scale": ks, "v_scale": vs, "window": 0}
    live = torch.arange(S, device="cuda")[None, :] <= pos[:, None]
    if paged:
        ps = cs.PAGE_SIZE
        (k, v, kw["k_scale"], kw["v_scale"]), table = cs.paged_layout(
            k, v, ks, vs, pos, ps, 2 * b * (S // ps), gen)
        table[2] = k.shape[0]  # an all-sentinel row
        P = k.shape[0]
        mapped = ((table >= 0) & (table < P)).repeat_interleave(ps, dim=1)
        safe = table.long().clamp(0, P - 1)
        mask = (live & mapped)[:, None, None, :]

        def kernel():
            return da.paged_decode_attention(q, k, v, table, pos, **kw)

        def library():
            kk = k[safe].reshape(b, S, h_kv, dh).transpose(1, 2)
            vv = v[safe].reshape(b, S, h_kv, dh).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask)

        return kernel, library, cs.decode_bound(da, q, k, False, pos, S, 0, table, P, ps)

    def kernel():
        return da.decode_attention(q, k, v, pos, **kw)

    library = None
    if not int8:
        kt, vt, mask = k.transpose(1, 2), v.transpose(1, 2), live[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=h_kv < h)

    return kernel, library, cs.decode_bound(da, q, k, int8, pos, S, 0)


def decode_splits(cs, da):
    """Each of ``DECODE_SHAPES`` from a CUDA graph at every split count of
    ``SPLIT_SWEEP`` (``num_splits`` replaced, the plans forgotten)."""
    import torch

    tuned = da.num_splits
    out = {}
    try:
        for key, h_kv, int8, paged in DECODE_SHAPES:
            kernel, _, bound = decode_shapes(cs, da, key, h_kv, int8, paged)
            out[key] = {"bound_ms": bound[0], "tuned": None, "graph_ms": {}}
            for n in (None, *SPLIT_SWEEP):
                da.num_splits = tuned if n is None else (lambda *a, n=n, **k: n)
                da.reset_plans()
                ms = cs.graph_ms(kernel)
                if n is None:
                    out[key]["tuned"] = ms
                else:
                    out[key]["graph_ms"][n] = ms
            print(f"decode splits {key}: {json.dumps(out[key])}")
            del kernel
            torch.cuda.empty_cache()
    finally:
        da.num_splits = tuned
        da.reset_plans()
    return out


def host_us(fn, calls=200):
    """Host microseconds a call spends enqueuing ``fn``: ``calls`` calls on
    the host clock, stopped before the card catches up (the launch queue
    holds them all)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def decode_turns(cs, da):
    """K11's four variants and K12 at the serving path's shapes, each timed
    back to back through the wrapper (``cs.cuda_ms``, 50 calls) and from a
    CUDA graph (``cs.graph_ms``, 20 calls a replay), beside its library
    call on the same two timers (SDPA with the boolean ``pos`` mask,
    ``enable_gqa`` for GQA; for K12 the gather ``pool[table]`` plus SDPA;
    none for int8), its bound, and the wrapper's host time a call
    (``host_us``). Uses only the public wrappers and
    ``chip_smoke.py``'s input helpers, so every checkout is timed alike."""
    import torch

    out = {}
    for key, h_kv, int8, paged in DECODE_SHAPES:
        kernel, library, bound = decode_shapes(cs, da, key, h_kv, int8, paged)
        times = {"ms": [], "graph_ms": [], "library_ms": [], "library_graph_ms": []}
        for _ in range(2):
            times["ms"].append(cs.cuda_ms(kernel, 50))
            times["graph_ms"].append(cs.graph_ms(kernel))
            if library is not None:
                times["library_ms"].append(cs.cuda_ms(library, 50))
                times["library_graph_ms"].append(cs.graph_ms(library))
        out[key] = {name: min(t) if t else None for name, t in times.items()}
        out[key].update(turns=times, bound_ms=bound[0], bound_by=bound[1],
                        host_us=host_us(kernel))
        print(f"decode {key}: {json.dumps(out[key])}")
        del kernel, library
        torch.cuda.empty_cache()
    return out


def decode_rows(cs, run_benchmark):
    """The ``decode_kernel=pallas`` decode rows at m = 8192 (bf16 and int8
    cache, MHA and GQA-4) and the paged pallas serve row at m = 2048, as
    ``chip_smoke.py``'s serving path drives them; (median, p95) ms a row."""
    import torch

    common = cs.SERVE_COMMON
    runs = [
        ((cs.PATH_MNK, cs.SERVE_N, cs.SERVE_K),
         {"spmd": [{"phase": "decode", "attn_kernel": "flash", "decode_kernel": "pallas",
                    "kv_cache": ["bf16", "int8"], "n_kv_heads": [0, 4], **common}]}, 2, 8),
        ((2048, cs.SERVE_N, cs.SERVE_K),
         {"spmd": [{"phase": "serve", "n_requests": 16, "n_new": 32, "attn_kernel": "flash",
                    "cache_layout": "paged", "page_pool_frac": [0.5],
                    "decode_kernel": "pallas", "dp": 1, "tp": 1, **common}]}, 1, 3),
    ]
    rows = {}
    for shape, impls, warmups, iterations in runs:
        for row in cs.drive_path(run_benchmark, "cuda", "transformer_decode", shape, impls,
                                 warmups=warmups, iterations=iterations):
            rows[f"transformer_decode {list(shape)} {row['implementation']} "
                 f"{row['option']}"] = [row["median time (ms)"], row.get("p95 time (ms)")]
        torch.cuda.empty_cache()
    return rows


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
    from ddlb_tpu_torch.ops import decode_attention as da
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
    rows, turns = {}, None
    try:
        if args.phase == "decode_splits":
            entries = []
            turns = decode_splits(chip_smoke, da)
        elif args.phase == "backward":
            entries = []
            turns = backward_turns(chip_smoke, fa)
        elif args.phase == "decode":
            from ddlb_tpu_torch.cli.benchmark import run_benchmark

            entries = list(chip_smoke.kernel_phase_decode(da, smi))
            torch.cuda.empty_cache()
            turns = decode_turns(chip_smoke, da)
            rows = decode_rows(chip_smoke, run_benchmark)
        elif args.phase in ("quantized_path", "flash_paths"):
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
        "kernels": {e["name"]: {key: e.get(key) for key in (*KEYS, "mma_ms", "sdpa_ms", "variants", "past",
                                                             "graph_ms", "library_graph_ms")
                                if key in e or key in KEYS}
                    for e in entries},
        "turns": turns,
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
