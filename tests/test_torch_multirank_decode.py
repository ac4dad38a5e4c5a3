"""The port's ``transformer_decode`` on a real 2-rank gloo world: decode
at (1, 2) and (2, 1), the int8 GQA decode, ``serve`` and ``speculate``
against the single-process oracle and the JAX package. Split from
``test_torch_multirank.py`` so that the test runner's workers can share
the multi-rank worlds (a file is one unit of work); two ranks are spawned,
never forked.
"""

import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import torch

WORLD = 2
#: seconds the whole world may take; the test fails when it runs out
DEADLINE_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -- transformer_decode over a (dp, tp) mesh of two ranks ----------------------
#
# Small width (d_model 64, 4 heads of 16, d_ff 128, vocab 64, 2 layers, batch
# 4, m = 16), float32. Each rank returns its logits rows (decode), or its
# completions (serve), and its own validation verdict; the parent holds the
# logits against the port's single-process oracle with the same expert
# count (tp experts: world 1 cannot hold the tp = 2 model any other way) at
# atol 1e-5, the served tokens against the JAX engine on a (1, 2) mesh of
# the CPU simulation, token for token, and the speculated tokens and
# acceptance counters against JAX's make_speculate_fn on a mesh of the same
# shape (the accepted count is the global batch's minimum: both dp ranks
# run JAX's rounds).

DEC_M, DEC_N, DEC_K = 16, 64, 128
DEC_COMMON = dict(batch=4, vocab=64, n_heads=4, layers=2)
DEC_CASES = [
    ("decode", 1, 2, {}),
    ("decode", 2, 1, {}),
    ("decode", 1, 2, {"decode_kernel": "pallas", "n_kv_heads": 2, "kv_cache": "int8"}),
    ("serve", 1, 2, {"n_new": 4, "n_requests": 6, "attn_kernel": "einsum"}),
    ("speculate", 2, 1, {"n_new": 6, "spec_k": 2, "attn_kernel": "einsum"}),
    ("speculate", 1, 2, {"n_new": 6, "spec_k": 2, "attn_kernel": "einsum"}),
]


def _decode_rank_main(rank, port, results):
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    from ddlb_tpu_torch.primitives.registry import load_impl_class

    try:
        out = {}
        for i, (phase, dp, tp, opts) in enumerate(DEC_CASES):
            impl = load_impl_class("transformer_decode", "spmd")(
                DEC_M, DEC_N, DEC_K, dtype="float32", device="cpu", phase=phase,
                dp=dp, tp=tp, **DEC_COMMON, **opts,
            )
            result = impl.run()
            valid = impl.validate(result)
            if phase == "serve":
                payload = [(c.request_index, c.slot, c.tokens) for c in impl._serve_completions]
            elif phase == "speculate":
                payload = (result.numpy(), impl._spec_stats)
            else:
                payload = result.numpy()
            out[i] = (payload, valid, impl.mesh.dp_rank, impl.mesh.tp_rank)
        results.put((rank, "ok", out, None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _decode_oracle(opts, tp):
    """The port's single-process oracle at position m, every row."""
    from ddlb_tpu_torch.models.decode import reference_logits
    from ddlb_tpu_torch.models.transformer import (
        TransformerConfig, example_tokens, init_params,
    )

    cfg = TransformerConfig(
        vocab=64, d_model=DEC_N, n_heads=4, d_ff=DEC_K, layers_per_stage=2,
        n_kv_heads=opts.get("n_kv_heads", 0), kv_cache=opts.get("kv_cache", "bf16"),
    )
    params = init_params(cfg, pp=1, n_experts=tp, seed=42)
    prompt, targets = example_tokens(4, DEC_M, 64, seed=42)
    toks = np.concatenate([prompt, targets[:, -1:]], axis=1)
    return reference_logits(params, torch.from_numpy(toks), cfg, tp=tp, dp=1).numpy()


def _jax_engine_completions(opts):
    """The JAX engine on a (1, 2) mesh over the serve case's workload."""
    import jax

    from ddlb_tpu.models.serving import ContinuousBatchingEngine, Request
    from ddlb_tpu.models.transformer import TransformerConfig, example_tokens, init_params

    cfg = TransformerConfig(vocab=64, d_model=DEC_N, n_heads=4, d_ff=DEC_K,
                            layers_per_stage=2, attn_kernel=opts["attn_kernel"])
    mesh = jax.make_mesh((1, 2), ("dp", "tp"), devices=jax.devices()[:2])
    params = init_params(cfg, pp=1, n_experts=2, seed=42)
    prompts, _ = example_tokens(opts["n_requests"], DEC_M, 64, seed=42)
    workload = [(np.asarray(prompts[i]), 1 + (i + 3) % opts["n_new"])
                for i in range(opts["n_requests"])]
    eng = ContinuousBatchingEngine(
        mesh, cfg, params, max_batch=4, max_len=max(p.size + m for p, m in workload)
    )
    for prompt, m in workload:
        eng.submit(Request(prompt, max_new=m))
    return [(c.request_index, c.slot, c.tokens) for c in eng.run()]


def _jax_speculate(opts, dp, tp):
    """JAX's greedy speculation on a (dp, tp) mesh: (tokens, stats)."""
    import jax
    from dataclasses import replace

    import ddlb_tpu.models.decode as jdec
    from ddlb_tpu.models.transformer import TransformerConfig, example_tokens, init_params

    cfg = TransformerConfig(vocab=64, d_model=DEC_N, n_heads=4, d_ff=DEC_K,
                            layers_per_stage=2, attn_kernel=opts["attn_kernel"])
    cfg_d = replace(cfg, layers_per_stage=1)
    mesh = jax.make_mesh((dp, tp), ("dp", "tp"), devices=jax.devices()[:dp * tp])
    n_new, k = opts["n_new"], opts["spec_k"]
    spec, (sh, sh_d) = jdec.make_speculate_fn(mesh, cfg, cfg_d, n_new=n_new, spec_k=k,
                                              with_stats=True)
    params = {n: jax.device_put(v, sh[n])
              for n, v in init_params(cfg, pp=1, n_experts=tp, seed=42).items()}
    params_d = {n: jax.device_put(v, sh_d[n])
                for n, v in init_params(cfg_d, pp=1, n_experts=tp, seed=43).items()}
    prompt, _ = example_tokens(4, DEC_M, 64, seed=42)
    tokens, stats = jax.jit(spec)(
        params, params_d, jdec.init_cache(cfg, 4, DEC_M + n_new + k, mesh),
        jdec.init_cache(cfg_d, 4, DEC_M + n_new + k, mesh), prompt)
    return np.asarray(tokens), {name: int(v) for name, v in stats.items()}


def test_two_rank_transformer_decode():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_decode_rank_main, args=(r, port, results), daemon=True)
        for r in range(WORLD)
    ]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, status, payload, _ = results.get(timeout=DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {WORLD}-rank world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * WORLD

    for i, (phase, dp, tp, opts) in enumerate(DEC_CASES):
        if phase == "serve":
            want = _jax_engine_completions(opts)
        elif phase == "speculate":
            want = _jax_speculate(opts, dp, tp)
        else:
            want = _decode_oracle(opts, tp)
        for rank in range(WORLD):
            payload, valid, dp_rank, tp_rank = got[rank][i]
            assert valid, (rank, DEC_CASES[i])
            assert (dp_rank, tp_rank) == divmod(rank, tp)
            if phase == "serve":
                assert len(payload) == len(want)
                for (ri, slot, toks), (wi, wslot, wtoks) in zip(payload, want):
                    assert (ri, slot) == (wi, wslot)
                    np.testing.assert_array_equal(toks, np.asarray(wtoks))
            elif phase == "speculate":
                rows = slice(dp_rank * 4 // dp, (dp_rank + 1) * 4 // dp)
                np.testing.assert_array_equal(payload[0], want[0][rows])
                assert payload[1] == want[1], (rank, payload[1], want[1])
            else:
                rows = slice(dp_rank * 4 // dp, (dp_rank + 1) * 4 // dp)
                np.testing.assert_allclose(payload, want[rows], rtol=0, atol=1e-5,
                                           err_msg=f"rank {rank} case {DEC_CASES[i]}")
