"""The collective trio's last members on a real 2-rank gloo world: the
``collectives`` family and the ``cuda`` and ``overlap`` members of
``dp_allreduce`` and ``ep_alltoall`` (the plain K4, K5 and K6) against
their JAX twins. Split from ``test_torch_multirank.py`` so that the test
runner's workers can share the multi-rank worlds (a file is one unit of
work); two ranks are spawned, never forked.
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


M, N, K = 64, 48, 96
#: the port's members whose JAX counterparts the parent runs on a
#: two-device mesh too (the port's ``cuda`` is the JAX ``pallas``, its
#: ring_rdma in Pallas interpret mode)
JAX_TWINS = {"overlap": "overlap", "cuda": "pallas"}


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
