"""The ``pp_pipeline`` family on a 2-rank gloo world, against the JAX
members on a two-device mesh of the CPU simulation.

Each rank builds every member below at m = n = k = 32 on the CPU, in
float32 (its outputs returned) and bfloat16 (validated), and the parent
holds the float32 outputs of every rank to the JAX member's (the JAX
package's ``jax_spmd`` for ``pytorch``, ``xla_gspmd`` for ``compiled``)
within 1e-5: the chain output, the same on every rank, and for
``schedules`` each rank's float32 stage gradients against the JAX
member's rows of that rank (device-major, ``[p*v + c]``). The ring hops,
the drain ring, the schedule executor's table-driven hops and the final
broadcast all run over gloo here. The ``compiled`` member's eager program
is run once under ``CommDebugMode``: picking a stage out of the
``Shard(0)`` weight stack makes DTensor all-gather the whole stack, once
for each of the d stages, and nothing else.
"""

import traceback

import numpy as np
import pytest

import jax

from torch_parity import join_world, run_world

WORLD = 2
M = N = K = 32
#: seconds the world may take; the test fails when it runs out
DEADLINE_S = 300
CASES = [
    ("compute_only", {"size": "sharded"}),
    ("compute_only", {"size": "unsharded"}),
    ("pytorch", {"microbatches": 1}),
    ("pytorch", {"microbatches": 2}),
    ("pytorch", {"microbatches": 4}),
    ("schedules", {"schedule": "gpipe", "microbatches": 4}),
    ("schedules", {"schedule": "1f1b", "microbatches": 4}),
    ("schedules", {"schedule": "1f1b", "microbatches": 1}),
    ("schedules", {"schedule": "interleaved", "virtual": 2, "microbatches": 4}),
    ("schedules", {"schedule": "gpipe", "virtual": 2, "microbatches": 2}),
    ("compiled", {}),
]
JAX_NAMES = {"pytorch": "jax_spmd", "compiled": "xla_gspmd"}


def _rank_main(rank, port, results):
    join_world(rank, WORLD, port)
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from ddlb_tpu_torch.primitives.registry import load_impl_class

    try:
        out = {}
        for i, (name, opts) in enumerate(CASES):
            for dtype in ("float32", "bfloat16"):
                impl = load_impl_class("pp_pipeline", name)(M, N, K, dtype=dtype, device="cpu",
                                                             **opts)
                result = impl.run()
                payload = None
                if dtype == "float32":
                    parts = result if isinstance(result, tuple) else (result,)
                    payload = [p.float().numpy() for p in parts]
                out[i, dtype] = (payload, impl.validate(result), impl.num_partitions)
                if name == "compiled" and dtype == "float32":
                    with CommDebugMode() as comm:
                        impl.programs[0](impl.a, impl.w)
                    out["comm"] = {str(op).split(".")[-1]: n
                                   for op, n in comm.get_comm_counts().items()}
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_twin(name, opts):
    from ddlb_tpu.primitives.registry import load_impl_class as load_jax

    mesh = jax.make_mesh((WORLD,), ("tp",), devices=jax.devices()[:WORLD])
    out = load_jax("pp_pipeline", JAX_NAMES.get(name, name))(
        M, N, K, dtype="float32", mesh=mesh, **opts).run()
    return [np.asarray(p, np.float32) for p in (out if isinstance(out, tuple) else (out,))]


@pytest.fixture(scope="module")
def world():
    return run_world(_rank_main, WORLD, DEADLINE_S)


@pytest.mark.parametrize("case", range(len(CASES)), ids=lambda i: f"{CASES[i][0]}-{CASES[i][1]}")
def test_member_matches_the_jax_member_on_two_ranks(world, case):
    name, opts = CASES[case]
    want = _jax_twin(name, opts)
    v = opts.get("virtual", 1)
    for rank in range(WORLD):
        (got, valid, partitions) = world[rank][case, "float32"]
        assert partitions == WORLD and valid, (rank, CASES[case])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5,
                                   err_msg=f"rank {rank} {CASES[case]} output")
        if name == "schedules":
            np.testing.assert_allclose(got[1], want[1][rank * v:(rank + 1) * v], rtol=0,
                                       atol=1e-5, err_msg=f"rank {rank} {CASES[case]} dW")
        _, valid_bf16, _ = world[rank][case, "bfloat16"]
        assert valid_bf16, (rank, CASES[case], "bfloat16")


def test_compiled_gathers_the_weight_stack_at_each_stage(world):
    for rank in range(WORLD):
        assert world[rank]["comm"] == {"all_gather_into_tensor": WORLD}, world[rank]["comm"]
