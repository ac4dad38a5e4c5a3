"""The port's sharding logic on a real 2-rank gloo world.

At world 1 every collective is the identity, so this is the test of the
split, the all-gather, the reduce-scatter, the all-reduce, the ring hop and
the all-to-alls: two ranks are spawned (never forked: the parent has JAX
and torch threads), each builds every member at d = 2 on the CPU, and the
parent checks each rank's output against the numpy product (the numpy
routed product, the numpy causal attention) of the same seeded operands,
or, for the quantized members, bit for bit against the JAX member on a
two-device mesh of the CPU simulation (both quantize the same shards; a
sum of two float32 partials rounds once in gloo and in XLA alike). The
overlap members and ``cuda;algorithm=ring_rdma`` are also held against
their JAX twins on that mesh (``overlap``; ``pallas`` in Pallas interpret
mode) within ``validation_atol``, and the plain K2/K3 rings bit for bit
against the JAX kernels under the distributed interpreter. A world of its
own runs the collective trio's last members (the ``collectives`` family,
the ``cuda`` and ``overlap`` members of ``dp_allreduce`` and
``ep_alltoall``: the plain K4, K5 and K6) against their JAX twins.
"""

import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import torch

WORLD = 2
M, N, K = 64, 48, 96
#: seconds the whole world may take; the test fails when it runs out
DEADLINE_S = 300

#: (family, member, options); run by every rank in this order
CASES = [
    ("tp_columnwise", "pytorch", {"order": "AG_before"}),
    ("tp_columnwise", "pytorch", {"order": "AG_after"}),
    ("tp_columnwise", "cuda", {"order": "AG_before"}),
    ("tp_columnwise", "cuda", {"order": "AG_after"}),
    ("tp_columnwise", "compute_only", {"size": "sharded"}),
    ("tp_rowwise", "pytorch", {}),
    ("tp_rowwise", "cuda", {}),
    ("tp_rowwise", "compute_only", {"size": "sharded"}),
    ("dp_allreduce", "pytorch", {"strategy": "all_reduce"}),
    ("dp_allreduce", "pytorch", {"strategy": "rs_ag"}),
    ("ep_alltoall", "pytorch", {}),
    ("ep_alltoall", "compute_only", {"size": "sharded"}),
] + [
    (family, "quantized", {"kernel": kernel, "quantize": quantize})
    for family in ("tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall")
    for kernel, quantize in (("xla", "static"), ("pallas", "dynamic"))
] + [
    (family, "overlap", opts)
    for family in ("tp_columnwise", "tp_rowwise")
    for opts in (
        {"algorithm": "default"},
        {"algorithm": "coll_pipeline", "s": 4},
        {"algorithm": "p2p_pipeline", "direction": "unidirectional"},
        {"algorithm": "p2p_pipeline", "direction": "bidirectional"},
        {"algorithm": "chunked", "chunk_count": 2},
    )
] + [
    (family, "cuda", {"algorithm": "ring_rdma"})
    for family in ("tp_columnwise", "tp_rowwise")
]
#: the port's members whose JAX counterparts the parent runs on a
#: two-device mesh too (the port's ``cuda`` is the JAX ``pallas``, its
#: ring_rdma in Pallas interpret mode)
JAX_TWINS = {"overlap": "overlap", "cuda": "pallas"}

#: K2/K3's plain rings at d = 2: seeded [-1, 1] operands rounded to
#: multiples of 1/64, whose products and sums are exact in float32 in any
#: order, so the bf16 results match the JAX kernels bit for bit
RING_KM, RING_KN, RING_KK = 32, 48, 64

#: cp_ring_attention at seq 64, 4 heads of 16 (32 rows a rank)
ATTN_M, ATTN_N, ATTN_K = 64, 64, 16
ATTN_WINDOW = {"window": 24, "n_kv_heads": 2}
ATTN_CASES = [
    ("ring", {"skip_masked_blocks": True}),
    ("ring", {"skip_masked_blocks": False}),
    ("allgather", {}),
    ("ulysses", {"compute": "einsum"}),
    ("ulysses", {"compute": "flash"}),
    ("flash", {}),
    ("ring_flash", {"skip_masked_blocks": True}),
    ("ring_flash", {"skip_masked_blocks": False}),
    ("ring", ATTN_WINDOW),
    ("flash", ATTN_WINDOW),
    ("ulysses", {"compute": "flash", **ATTN_WINDOW}),
    ("ring_flash", ATTN_WINDOW),
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, results):
    """One rank: every case in f32 (outputs returned) and bf16 (validate
    only), then the divisibility rejections."""
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    from ddlb_tpu_torch.primitives.registry import load_impl_class

    try:
        out = {}
        for i, (family, name, opts) in enumerate(CASES):
            for dtype in ("float32", "bfloat16"):
                impl = load_impl_class(family, name)(
                    M, N, K, dtype=dtype, device="cpu", **opts
                )
                result = impl.run()
                out[(i, dtype)] = (
                    result.float().numpy() if dtype == "float32" else None,
                    impl.validate(result),
                    impl.num_partitions,
                )
        for i, (name, opts) in enumerate(ATTN_CASES):
            for dtype in ("float32", "bfloat16"):
                impl = load_impl_class("cp_ring_attention", name)(
                    ATTN_M, ATTN_N, ATTN_K, dtype=dtype, device="cpu", **opts
                )
                result = impl.run()
                out[("attn", i, dtype)] = (
                    result.float().numpy() if dtype == "float32" else None,
                    impl.validate(result),
                    impl.num_partitions,
                )
        from ddlb_tpu_torch.ops import collective_matmul as cm
        from ddlb_tpu_torch.runtime import Runtime

        rt = Runtime("cpu")
        a, b = (torch.from_numpy(x) for x in _ring_operands())
        rows, kd = RING_KM // WORLD, RING_KK // WORLD
        for dtype in (torch.float32, torch.bfloat16):
            a_t, b_t = a.to(dtype), b.to(dtype)
            ag = cm.ring_ag_matmul(a_t[rank * rows:(rank + 1) * rows].contiguous(), b_t, rt)
            rs = cm.ring_matmul_rs(a_t[:, rank * kd:(rank + 1) * kd].contiguous(),
                                   b_t[rank * kd:(rank + 1) * kd].contiguous(), rt)
            out[("ring", str(dtype))] = (ag.float().numpy(), rs.float().numpy())
        rejected = []
        for family, shape in (("tp_columnwise", (M + 1, N, K)),
                              ("tp_rowwise", (M, N, K + 1))):
            try:
                load_impl_class(family, "pytorch")(*shape, device="cpu")
            except ValueError as exc:
                rejected.append(str(exc))
        results.put((rank, "ok", out, rejected))
    except BaseException:
        results.put((rank, "error", traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _expected_quantized(case_index, rank):
    """The JAX member on a two-device mesh: this rank's block of its rows
    (all of them where the family replicates its result)."""
    import jax

    from ddlb_tpu.primitives.registry import load_impl_class as load_jax

    family, name, opts = CASES[case_index]
    mesh = jax.make_mesh((WORLD,), ("tp",), devices=jax.devices()[:WORLD])
    full = np.asarray(load_jax(family, name)(M, N, K, dtype="float32", mesh=mesh,
                                             **opts).run())
    if family in ("tp_columnwise", "dp_allreduce"):
        return full
    rows = M // WORLD
    return full[rank * rows:(rank + 1) * rows]


def _ring_operands():
    rng = np.random.default_rng(11)
    a = rng.uniform(-1, 1, (RING_KM, RING_KK))
    b = rng.uniform(-1, 1, (RING_KK, RING_KN))
    return (np.round(a * 64) / 64).astype(np.float32), (np.round(b * 64) / 64).astype(np.float32)


def _jax_rings(dtype):
    """JAX's K2 and K3 in Pallas interpret mode on a two-device mesh:
    (the all-gathered product, the reduce-scattered rows)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ddlb_tpu.ops.collective_matmul import ring_ag_matmul, ring_matmul_rs

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("tp",))
    a, b = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in _ring_operands())
    out = []
    for fn, specs, out_spec in (
        (ring_ag_matmul, (P("tp", None), P(None, None)), P(None, None)),
        (ring_matmul_rs, (P(None, "tp"), P("tp", None)), P("tp", None)),
    ):
        body = lambda x, y, fn=fn: fn(  # noqa: E731
            x, y, axis_size=WORLD, block_n=16, block_k=16,
            interpret=pltpu.InterpretParams())
        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                                  out_specs=out_spec, check_vma=False))
        out.append(np.asarray(f(jax.device_put(a, NamedSharding(mesh, specs[0])),
                                jax.device_put(b, NamedSharding(mesh, specs[1])))
                              .astype(jnp.float32)))
    return out


def _expected_jax_twin(case_index, rank):
    """The JAX twin of an overlap or ring_rdma case on a two-device mesh:
    this rank's rows of its result (all of them for tp_columnwise)."""
    import jax

    from ddlb_tpu.primitives.registry import load_impl_class as load_jax

    family, name, opts = CASES[case_index]
    mesh = jax.make_mesh((WORLD,), ("tp",), devices=jax.devices()[:WORLD])
    full = np.asarray(load_jax(family, JAX_TWINS[name])(
        M, N, K, dtype="float32", mesh=mesh, **opts).run())
    if family == "tp_columnwise":
        return full
    rows = M // WORLD
    return full[rank * rows:(rank + 1) * rows]


def _expected(case_index, rank):
    family, name, opts = CASES[case_index]
    if name == "quantized":
        return _expected_quantized(case_index, rank)
    rng = np.random.default_rng(42)  # the primitives' default seed
    a = rng.uniform(-1.0, 1.0, (M, K)).astype(np.float32)
    rows, kd = M // WORLD, K // WORLD
    if family == "ep_alltoall":
        # expert e's weight [k, n] after the tokens; group e of each rank's
        # tokens through expert e
        w = rng.uniform(-1.0, 1.0, (WORLD, K, N)).astype(np.float32)
        g = M // WORLD**2
        if name == "compute_only":
            return a[:rows] @ w[0]
        mine = a[rank * rows:(rank + 1) * rows].reshape(WORLD, g, K)
        return np.concatenate([mine[e] @ w[e] for e in range(WORLD)])
    b = rng.uniform(-1.0, 1.0, (K, N)).astype(np.float32)
    full = a @ b
    if family == "dp_allreduce":
        return full
    if family == "tp_columnwise":
        # sharded compute_only: one rank's [m/d, k] @ [k, n] as rank 0 holds it
        return full[:rows] if name == "compute_only" else full
    if name == "compute_only":
        return a[:, :kd] @ b[:kd]  # rank 0's partial
    return full[rank * rows:(rank + 1) * rows]


def _expected_attention(case_index, rank):
    """Rank ``rank``'s rows of causal (windowed, GQA) softmax attention in
    numpy, on the family's seeded q, k, v (seed 42, drawn in that order)."""
    opts = ATTN_CASES[case_index][1]
    h, dh = ATTN_N // ATTN_K, ATTN_K
    h_kv = opts.get("n_kv_heads") or h
    window = opts.get("window", 0)
    rng = np.random.default_rng(42)
    q = rng.uniform(-1, 1, (ATTN_M, h, dh)).astype(np.float32)
    k = rng.uniform(-1, 1, (ATTN_M, h_kv, dh)).astype(np.float32)
    v = rng.uniform(-1, 1, (ATTN_M, h_kv, dh)).astype(np.float32)
    pos = np.arange(ATTN_M)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    out = np.empty_like(q)
    for head in range(h):
        kv = head // (h // h_kv)
        s = np.where(mask, q[:, head] @ k[:, kv].T / np.sqrt(dh), -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        out[:, head] = (p / p.sum(-1, keepdims=True)) @ v[:, kv]
    rows = ATTN_M // WORLD
    return out[rank * rows:(rank + 1) * rows]


def test_two_rank_gloo_world():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(r, port, results), daemon=True)
        for r in range(WORLD)
    ]
    for p in procs:
        p.start()
    got = {}
    try:
        # drain before joining: a child blocks on exit until its queue
        # items are consumed
        for _ in range(WORLD):
            rank, status, payload, rejected = results.get(timeout=DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = (payload, rejected)
    except queue.Empty:
        raise AssertionError(
            f"the {WORLD}-rank world did not finish within {DEADLINE_S} s"
        )
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0] * WORLD

    from ddlb_tpu_torch.primitives.base import validation_atol

    rings = {dtype: _jax_rings(dtype) for dtype in ("float32", "bfloat16")}
    twins = {}
    for rank, (payload, rejected) in got.items():
        for dtype in ("float32", "bfloat16"):
            ag, rs = payload.pop(("ring", f"torch.{dtype}"))
            want_ag, want_rs = rings[dtype]
            rows = RING_KM // WORLD
            # exact sums on both sides: bit for bit, bf16 included
            np.testing.assert_array_equal(ag, want_ag, err_msg=f"K2 rank {rank} {dtype}")
            np.testing.assert_array_equal(rs, want_rs[rank * rows:(rank + 1) * rows],
                                          err_msg=f"K3 rank {rank} {dtype}")
        for key, (output, valid, partitions) in payload.items():
            if key[0] != "attn" and output is not None and CASES[key[0]][1] in JAX_TWINS:
                if (key[0], rank) not in twins:
                    twins[key[0], rank] = _expected_jax_twin(key[0], rank)
                np.testing.assert_allclose(
                    output, twins[key[0], rank], rtol=0,
                    atol=validation_atol("float32", K),
                    err_msg=f"rank {rank} case {CASES[key[0]]} against JAX",
                )
        for key, (output, valid, partitions) in payload.items():
            assert partitions == WORLD
            if key[0] == "attn":
                _, i, dtype = key
                case, want = ATTN_CASES[i], _expected_attention(i, rank)
            else:
                i, dtype = key
                case, want = CASES[i], _expected(i, rank)
            assert valid, (rank, case, dtype)
            if output is not None and case[1] == "quantized":
                np.testing.assert_array_equal(
                    output, want, err_msg=f"rank {rank} case {case}"
                )
            elif output is not None:
                np.testing.assert_allclose(
                    output, want, rtol=1e-5, atol=1e-5,
                    err_msg=f"rank {rank} case {case}",
                )
        assert len(rejected) == 2
        assert "m=65 must be divisible by partitions=2" in rejected[0]
        assert "k=97 must be divisible by partitions=2" in rejected[1]


def test_expected_operands_follow_the_primitive_seed():
    """The numpy stream ``_expected`` replays is the one
    ``Primitive._host_operands`` draws (seed 42, A then B)."""
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    impl = load_impl_class("tp_columnwise", "compute_only")(
        M, N, K, dtype="float32", device="cpu", size="unsharded"
    )
    a, b = impl._host_operands()
    np.testing.assert_array_equal(
        _expected(CASES.index(("tp_columnwise", "pytorch", {"order": "AG_before"})), 0),
        a @ b,
    )
    assert torch.equal(impl.a, torch.from_numpy(a))


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


# -- transformer_step over (dp, tp, pp) meshes of two ranks --------------------
#
# d_model 32, 4 heads of 8, d_ff 64, vocab 64, one layer a stage, batch 4,
# m = 16, float32. Each rank runs one spmd train step (or, under
# mode='forward', the loss alone, its parameters left as they are) and
# returns its loss and its slice of the parameters after the AdamW update;
# the parent holds
# them against the JAX package's train step on a CPU-simulation mesh of the
# same shape (jax.make_mesh lays out its devices with pp fastest, as
# runtime.Mesh places the ranks): the loss within 1e-5 and the slices of
# the updated parameters within 2e-6. The first AdamW step moves a
# parameter by lr * (u + wd * p) with u = g / (|g| + eps): where |u| >=
# 0.99 (|g| above about 1e-6) float32 gradients that agree to 1e-7 relative
# pin it far below 2e-6, and so they do where g is exactly 0 on both sides;
# where the gradient is tiny but not 0, typically a sum over ranks that
# nearly cancels, u follows the last bits of g, so there (under 5% of a
# leaf) the parameter is only held within 2 * lr. The learned routers run at
# E = tp experts (topk, its capacity binding at factor 0.5, expert_choice) and
# at pp = 2 under the 1f1b schedule (one expert, k = 1: the aux term through
# the table executor's cotangent). Then each rank's dq, dk, dv of the
# ring flash attention on its sequence chunk at d = 2 against jax.grad of
# the JAX package's ring_flash_attention at 1e-5.

STEP_M, STEP_N, STEP_K = 16, 32, 64
STEP_COMMON = dict(batch=4, vocab=64, n_heads=4, microbatches=2)
STEP_CASES = [
    (1, 2, 1, {"attention": "gathered"}),
    (1, 2, 1, {"attention": "ring"}),
    (1, 2, 1, {"attention": "ring", "attn_window": 6, "n_kv_heads": 2, "rope": True}),
    (1, 1, 2, {"attn_kernel": "einsum"}),
    (2, 1, 1, {"attn_kernel": "einsum"}),
    # the einsum ring: every hop in every rank's graph, live or not
    (1, 2, 1, {"attention": "ring", "attn_kernel": "einsum"}),
    (1, 2, 1, {"attention": "ring", "attn_kernel": "einsum", "attn_window": 5}),
    (1, 1, 2, {}),
    # the loss alone: parameters as they were, the loss the step's
    (1, 1, 2, {"mode": "forward"}),
    # the learned routers
    (1, 2, 1, {"router": "topk"}),
    (1, 2, 1, {"router": "topk", "capacity_factor": 0.5}),
    (1, 2, 1, {"router": "expert_choice"}),
    (1, 1, 2, {"router": "topk", "router_topk": 1, "schedule": "1f1b"}),
    # dp with flash; gathered GQA, rope and a window; the int8 MLP gathered
    # and ring; two layers a stage
    (2, 1, 1, {}),
    (1, 2, 1, {"n_kv_heads": 2, "rope": True, "attn_window": 6}),
    (1, 2, 1, {"mlp_kernel": "int8"}),
    (1, 2, 1, {"attention": "ring", "mlp_kernel": "int8"}),
    (1, 1, 2, {"layers_per_stage": 2}),
]
#: options of a case that are the member's, not the model config's
STEP_MEMBER_OPTIONS = ("mode", "schedule")
RING_S, RING_H, RING_DH = 32, 2, 8


def _ring_inputs():
    rng = np.random.default_rng(7)
    return [rng.normal(0, 1, (RING_S, RING_H, RING_DH)).astype(np.float32)
            for _ in range(4)]  # q, k, v, the output's cotangent


def _step_rank_main(rank, port, results):
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    from ddlb_tpu_torch.ops.flash_attention import ring_flash_attention
    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.runtime import Runtime

    try:
        out = {}
        for i, (dp, tp, pp, opts) in enumerate(STEP_CASES):
            impl = load_impl_class("transformer_step", "spmd")(
                STEP_M, STEP_N, STEP_K, dtype="float32", device="cpu",
                dp=dp, tp=tp, pp=pp, **STEP_COMMON, **opts,
            )
            result = impl.run()
            if opts.get("mode") == "forward":
                params, loss = impl._args[0], result
            else:
                params, _, loss = result
            coords = (impl.mesh.dp_rank, impl.mesh.tp_rank, impl.mesh.pp_rank)
            out[i] = ({k: v.numpy() for k, v in params.items()}, float(loss),
                      impl.validate(result), coords)
        mesh = Runtime("cpu").mesh(1, WORLD, 1)
        s_loc = RING_S // WORLD
        q, k, v, w = (torch.from_numpy(x[rank * s_loc:(rank + 1) * s_loc].copy())
                      for x in _ring_inputs())
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = ring_flash_attention(
            q, k, v, shift=lambda *ts: mesh.shift("tp", *ts), axis_size=WORLD,
            axis_index=mesh.tp_rank, scale=RING_DH**-0.5,
        )
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        out["ring"] = [g.numpy() for g in grads]
        results.put((rank, "ok", out, None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_step(dp, tp, pp, opts):
    """The JAX package's train step on a (dp, tp, pp) mesh of the CPU
    simulation: (full parameters before and after one step, loss). Under
    ``mode='forward'`` the parameters after are those before (the step's
    loss is taken before its update, so it is the forward's loss)."""
    import jax

    from ddlb_tpu.models.pipeline import make_train_step_1f1b
    from ddlb_tpu.models.transformer import (
        TransformerConfig, example_tokens, init_params, make_train_step,
    )

    forward = opts.get("mode") == "forward"
    schedule = opts.get("schedule", "gpipe")
    opts = {k: v for k, v in opts.items() if k not in STEP_MEMBER_OPTIONS}
    cfg = TransformerConfig(vocab=64, d_model=STEP_N, n_heads=4, d_ff=STEP_K,
                            microbatches=2, **opts)
    mesh = jax.make_mesh((dp, tp, pp), ("dp", "tp", "pp"), devices=jax.devices()[:WORLD])
    if schedule == "gpipe":
        step, init_opt, shardings = make_train_step(mesh, cfg, donate=False)
    else:
        step, init_opt, shardings = make_train_step_1f1b(mesh, cfg, donate=False,
                                                         schedule=schedule)
    init = init_params(cfg, pp, n_experts=tp, seed=42)
    params = {k: jax.device_put(v, shardings[k]) for k, v in init.items()}
    tokens, targets = example_tokens(4, STEP_M, 64, seed=42)
    new, _, loss = step(params, init_opt(params), jax.device_put(tokens, shardings["data"]),
                        jax.device_put(targets, shardings["data"]))
    if forward:
        new = init
    return ({k: np.asarray(v) for k, v in init.items()},
            {k: np.asarray(v) for k, v in new.items()}, float(loss))


def _jax_ring_grads():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ddlb_tpu.ops.flash_attention import ring_flash_attention
    from ddlb_tpu.runtime import shard_map_compat

    q, k, v, w = (jnp.asarray(x) for x in _ring_inputs())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("tp",))

    def body(q, k, v):
        return ring_flash_attention(q, k, v, axis_name="tp", axis_size=WORLD,
                                    scale=RING_DH**-0.5, block_q=8, block_kv=8,
                                    interpret=True)

    def loss(q, k, v):
        o = shard_map_compat(body, mesh=mesh, in_specs=(P("tp"),) * 3,
                             out_specs=P("tp"), check_vma=False)(q, k, v)
        return jnp.sum(o * w)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def test_two_rank_transformer_step():
    from ddlb_tpu_torch.models.transformer import TransformerConfig, param_axes

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_step_rank_main, args=(r, port, results), daemon=True)
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

    for i, (dp, tp, pp, opts) in enumerate(STEP_CASES):
        init, want_params, want_loss = _jax_step(dp, tp, pp, opts)
        axes = param_axes(TransformerConfig(
            **{k: v for k, v in opts.items() if k not in STEP_MEMBER_OPTIONS}), want_params)
        lr, wd = 1e-2, 1e-4
        # u as the JAX step applied it; 0 (an unused embedding row) is exact
        # on both sides
        u = {name: np.abs((init[name] - new) / lr - wd * init[name])
             for name, new in want_params.items()}
        atol = {name: np.where((u[name] > 1e-3) & (u[name] < 0.99), 2 * lr, 2e-6)
                for name in u}
        for rank in range(WORLD):
            params, loss, valid, (d_i, t_i, p_i) = got[rank][i]
            assert valid, (rank, STEP_CASES[i])
            assert (d_i, t_i, p_i) == (rank // (tp * pp), rank // pp % tp, rank % pp)
            np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-5)
            for name, full in want_params.items():
                part, tol = full, atol[name]
                for axis, dim in axes[name].items():
                    n, at = {"tp": (tp, t_i), "pp": (pp, p_i)}[axis]
                    width = part.shape[dim] // n
                    cut = range(at * width, (at + 1) * width)
                    part, tol = np.take(part, cut, axis=dim), np.take(tol, cut, axis=dim)
                err = np.abs(params[name] - part)
                assert np.all(err <= tol), (
                    f"rank {rank} case {STEP_CASES[i]} {name}: "
                    f"{int(np.sum(err > tol))} elements beyond tolerance, max {err.max()}"
                )
                assert np.mean(tol > 2e-6) < 0.05, name

    want = _jax_ring_grads()
    s_loc = RING_S // WORLD
    for rank in range(WORLD):
        for name, g, full in zip("qkv", got[rank]["ring"], want):
            np.testing.assert_allclose(
                g, full[rank * s_loc:(rank + 1) * s_loc], rtol=0, atol=1e-5,
                err_msg=f"rank {rank} d{name}",
            )


# -- the collective trio's last members: collectives, dp/ep cuda and overlap ------
#
# Each rank runs every case below at d = 2 in float32 (outputs returned) and
# bfloat16 (validated; the cuda collectives also returned, bit for bit), and
# the parent holds the float32 outputs to the JAX twins on a two-device mesh
# of the CPU simulation: the collectives bit for bit (at d = 2 a reduction is
# one float32 sum, rounded once on both sides), the ``pallas`` twins in
# Pallas interpret mode (the plain K4/K5 rings, K3, K6), the GEMM members
# within ``validation_atol``. ``hierarchical`` runs twice: on one node, and
# with LOCAL_WORLD_SIZE=1 (two nodes of one card, so the across-node
# all-reduce carries the sum).

COLL_M, COLL_K = 64, 64
COLL_CASES = (
    [("compute_only", {"size": "sharded"})]
    + [("pytorch", {"op": op}) for op in
       ("all_gather", "all_reduce", "reduce_scatter", "all_to_all", "ppermute")]
    + [("pytorch", {"op": "all_reduce", "strategy": "rs_ag"}),
       ("pytorch", {"op": "all_reduce", "strategy": "hierarchical"}),
       ("pytorch", {"op": "all_reduce", "strategy": "hierarchical", "nodes": 2})]
    + [("cuda", {"op": op}) for op in ("all_gather", "reduce_scatter", "all_reduce")]
)
TRIO_CASES = (
    [("dp_allreduce", "cuda", {"algorithm": a}) for a in ("xla_collective", "ring_rdma")]
    + [("ep_alltoall", "cuda", {"algorithm": a}) for a in ("xla_collective", "a2a_rdma")]
    + [("dp_allreduce", "overlap", o) for o in (
        {"algorithm": "default"},
        {"algorithm": "coll_pipeline", "s": 4},
        {"algorithm": "p2p_pipeline", "direction": "unidirectional"},
        {"algorithm": "p2p_pipeline", "direction": "bidirectional"},
        {"algorithm": "chunked", "chunk_count": 2},
    )]
    + [("ep_alltoall", "overlap", o) for o in (
        {"algorithm": "default"},
        {"algorithm": "coll_pipeline", "s": 2},
        {"algorithm": "chunked", "chunk_count": 2},
    )]
)


def _trio_rank_main(rank, port, results):
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    from ddlb_tpu_torch.primitives.registry import load_impl_class

    try:
        out = {}
        for i, (name, opts) in enumerate(COLL_CASES):
            opts = dict(opts)
            nodes = opts.pop("nodes", 1)
            os.environ["LOCAL_WORLD_SIZE"] = str(WORLD // nodes)
            for dtype in ("float32", "bfloat16"):
                impl = load_impl_class("collectives", name)(
                    COLL_M, 8, COLL_K, dtype=dtype, device="cpu", **opts)
                result = impl.run()
                keep = dtype == "float32" or name == "cuda"
                out[("coll", i, dtype)] = (
                    result.float().numpy() if keep else None, impl.validate(result),
                    impl.wire_bytes())
        os.environ["LOCAL_WORLD_SIZE"] = str(WORLD)
        for i, (family, name, opts) in enumerate(TRIO_CASES):
            for dtype in ("float32", "bfloat16"):
                impl = load_impl_class(family, name)(M, N, K, dtype=dtype, device="cpu",
                                                     **opts)
                result = impl.run()
                out[("trio", i, dtype)] = (
                    result.float().numpy() if dtype == "float32" else None,
                    impl.validate(result), impl.num_partitions)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_collective_twin(case_index, dtype):
    """The JAX member of a collectives case on a two-device mesh: its global
    result (the ``pallas`` twin in Pallas interpret mode; ``hierarchical``
    held to ``rs_ag``, which it is on one node and, across nodes of one
    card, up to the order of one two-term float32 sum)."""
    import jax

    from ddlb_tpu.primitives.registry import load_impl_class as load_jax

    name, opts = COLL_CASES[case_index]
    opts = {key: v for key, v in opts.items() if key != "nodes"}
    if opts.get("strategy") == "hierarchical":
        opts["strategy"] = "rs_ag"
    jax_name = {"pytorch": "jax_spmd", "cuda": "pallas"}.get(name, name)
    mesh = jax.make_mesh((WORLD,), ("tp",), devices=jax.devices()[:WORLD])
    impl = load_jax("collectives", jax_name)(COLL_M, 8, COLL_K, dtype=dtype, mesh=mesh,
                                             **opts)
    return np.asarray(impl.run(), dtype=np.float32), impl.wire_bytes()


def _jax_trio_twin(case_index, rank):
    import jax

    from ddlb_tpu.primitives.registry import load_impl_class as load_jax

    family, name, opts = TRIO_CASES[case_index]
    mesh = jax.make_mesh((WORLD,), ("tp",), devices=jax.devices()[:WORLD])
    full = np.asarray(load_jax(family, JAX_TWINS[name])(
        M, N, K, dtype="float32", mesh=mesh, **opts).run())
    if family == "dp_allreduce":
        return full
    rows = M // WORLD
    return full[rank * rows:(rank + 1) * rows]


def test_two_rank_collective_trio():
    from ddlb_tpu_torch.primitives.base import validation_atol

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_trio_rank_main, args=(r, port, results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, status, payload = results.get(timeout=DEADLINE_S)
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

    twins = {}
    for rank, payload in got.items():
        for key, (output, valid, extra) in payload.items():
            kind, i, dtype = key
            case = COLL_CASES[i] if kind == "coll" else TRIO_CASES[i]
            assert valid, (rank, case, dtype)
            if output is None:
                continue
            if kind == "trio":
                assert extra == WORLD
                if (i, rank) not in twins:
                    twins[i, rank] = _jax_trio_twin(i, rank)
                np.testing.assert_allclose(
                    output, twins[i, rank], rtol=0, atol=validation_atol("float32", K),
                    err_msg=f"rank {rank} case {case} against JAX")
                continue
            if (i, dtype) not in twins:
                twins[i, dtype] = _jax_collective_twin(i, dtype)
            full, wire = twins[i, dtype]
            assert extra == wire, (case, extra, wire)
            op = case[1].get("op", "all_gather")
            if case[0] != "compute_only" and op not in ("all_gather", "all_reduce"):
                rows = full.shape[0] // WORLD
                full = full[rank * rows:(rank + 1) * rows]
            elif case[0] == "compute_only":
                full = full[:COLL_M // WORLD]
            np.testing.assert_array_equal(output, full,
                                          err_msg=f"rank {rank} case {case} {dtype}")
