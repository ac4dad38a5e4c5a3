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
against the JAX kernels under the distributed interpreter. The other
2-rank worlds are files of their own, so that the test runner's workers
can share them: ``test_torch_multirank_decode.py`` (``transformer_decode``),
``test_torch_multirank_step.py`` (``transformer_step``) and
``test_torch_multirank_trio.py`` (the collective trio's last members).
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
