"""The port's sharding logic on a real 2-rank gloo world.

At world 1 every collective is the identity, so this is the test of the
split, the all-gather and the reduce-scatter: two ranks are spawned (never
forked: the parent has JAX and torch threads), each builds every member
at d = 2 on the CPU, and the parent checks each rank's output against the
numpy product of the same seeded operands.
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


def _expected(case_index, rank):
    rng = np.random.default_rng(42)  # the primitives' default seed
    a = rng.uniform(-1.0, 1.0, (M, K)).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, (K, N)).astype(np.float32)
    family, name, opts = CASES[case_index]
    full = a @ b
    rows, kd = M // WORLD, K // WORLD
    if family == "tp_columnwise":
        # sharded compute_only: one rank's [m/d, k] @ [k, n] as rank 0 holds it
        return full[:rows] if name == "compute_only" else full
    if name == "compute_only":
        return a[:, :kd] @ b[:kd]  # rank 0's partial
    return full[rank * rows:(rank + 1) * rows]


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

    for rank, (payload, rejected) in got.items():
        for (i, dtype), (output, valid, partitions) in payload.items():
            assert partitions == WORLD
            assert valid, (rank, CASES[i], dtype)
            if output is not None:
                np.testing.assert_allclose(
                    output, _expected(i, rank), rtol=1e-5, atol=1e-5,
                    err_msg=f"rank {rank} case {CASES[i]}",
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
