"""K6, the fused MoE all-to-all expert GEMM: the port's one-process version
(``alltoall_expert_matmul_virtual``) against the JAX package's Pallas kernel
under the distributed TPU interpreter on a d-device mesh of the CPU
simulation (as ``tests/test_pallas_ops.py`` runs it) and against the
blocked einsum oracle; and the plain version over ``Runtime.ring_shift``'s
shift-by-t exchanges on gloo worlds of 3 and 4 ranks, with the exchanges
themselves and the plain K4/K5 rings.

Tolerances: float32 within 1e-5 (both sides sum 32 products in float32, in
other orders); bf16 within one bf16 ulp (each side rounds the same float32
sum, computed in another order, once). The plain version equals the
virtual one bit for bit: the same products of the same groups.
"""

import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding, PartitionSpec as P

from ddlb_tpu.ops.alltoall_matmul import alltoall_expert_matmul
from ddlb_tpu_torch.ops import alltoall_matmul as am
from ddlb_tpu_torch.ops import chunked_fusion
from ddlb_tpu_torch.ops import ring_collectives as rc
from ddlb_tpu_torch.runtime import Runtime
from torch_parity import assert_within_bf16_ulps, to_numpy

G, N, K = 8, 32, 32
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _operands(d, seed):
    """Tokens ``[d*d*G, K]`` (rank r holds rows r*d*G ..) and experts
    ``[d, K, N]``, seeded uniform [-1, 1] float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (d * d * G, K)).astype(np.float32)
    w = rng.uniform(-1, 1, (d, K, N)).astype(np.float32)
    return a, w


def _jax_kernel(d, a, w, dtype):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d]), ("tp",))
    j_dtype = DTYPES[dtype][1]
    f = jax.jit(jax.shard_map(
        lambda a_s, w_s: alltoall_expert_matmul(
            a_s, w_s[0], axis_size=d, block_n=32, block_k=32,
            interpret=pltpu.InterpretParams()),
        mesh=mesh, in_specs=(P("tp", None), P("tp", None, None)),
        out_specs=P("tp", None), check_vma=False))
    out = f(jax.device_put(jnp.asarray(a).astype(j_dtype), NamedSharding(mesh, P("tp", None))),
            jax.device_put(jnp.asarray(w).astype(j_dtype),
                           NamedSharding(mesh, P("tp", None, None))))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_virtual_matches_the_jax_kernel_and_the_oracle(d, dtype):
    a, w = _operands(d, seed=d)
    t_dtype = DTYPES[dtype][0]
    shards = list(torch.from_numpy(a).to(t_dtype).split(d * G))
    experts = [torch.from_numpy(x).to(t_dtype) for x in w]
    outs = am.alltoall_expert_matmul_virtual(shards, experts)
    want = _jax_kernel(d, a, w, dtype)
    # the blocked einsum oracle on the placed (rounded) operands
    a_r = torch.cat(shards).float().numpy().reshape(d, d, G, K)
    w_r = torch.stack(experts).float().numpy()
    oracle = np.einsum("pegk,ekn->pegn", a_r, w_r).reshape(d * d * G, N)
    rows = d * G
    for r, out in enumerate(outs):
        assert out.shape == (rows, N) and out.dtype == t_dtype
        mine = slice(r * rows, (r + 1) * rows)
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(out), want[mine], rtol=0, atol=1e-5)
            np.testing.assert_allclose(to_numpy(out), oracle[mine], rtol=0, atol=1e-5)
        else:
            assert_within_bf16_ulps(out, want[mine])
            assert_within_bf16_ulps(out, oracle[mine])


def test_plain_at_world_one_is_the_expert_product():
    rt = Runtime("cpu")
    a = torch.randn(G, K, generator=torch.Generator().manual_seed(0)).bfloat16()
    w = torch.randn(K, N, generator=torch.Generator().manual_seed(1)).bfloat16()
    got = am.alltoall_expert_matmul(a, w, rt)
    assert torch.equal(got, (a.float() @ w.float()).bfloat16())
    before = dict(am.LAUNCHES)
    am.alltoall_expert_matmul(a, w, rt)
    assert am.LAUNCHES == before  # plain calls are not launches


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda a, w, rt: am.alltoall_expert_matmul(a, w[:8], rt), "contraction mismatch"),
        (lambda a, w, rt: am.alltoall_expert_matmul(a, w.float(), rt), "dtypes differ"),
        (lambda a, w, rt: am.alltoall_expert_matmul(a.int(), w.int(), rt), "K6 takes"),
        (lambda a, w, rt: am.alltoall_expert_matmul(a[:, :4], w[:4], rt), "16-byte units"),
        (lambda a, w, rt: am.alltoall_expert_matmul(a, w[:, :4], rt), "16-byte units"),
        (lambda a, w, rt: am.alltoall_expert_matmul(a[None], w, rt), "2-D operands"),
        (lambda a, w, rt: am.alltoall_expert_matmul_virtual([a[:3], a[:3]], [w, w]),
         "multiple of d=2"),
        (lambda a, w, rt: am.alltoall_expert_matmul_loopback([a, a], [w, w]), "cuda tensors"),
        (lambda a, w, rt: am.alltoall_expert_matmul_loopback([a, a], [w]), "2 token shards"),
        (lambda a, w, rt: am.A2ABuffers(list(range(9)), 0, 1, 8, 8, a.dtype, None), "1 to 8"),
    ],
)
def test_wrappers_reject_what_the_kernel_does_not_take(call, match):
    a = torch.zeros((G, K), dtype=torch.bfloat16)
    w = torch.zeros((K, N), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        call(a, w, Runtime("cpu"))


@pytest.mark.parametrize("dtype,k,n,tile", [
    (torch.bfloat16, 8192, 8192, "wgmma"),
    (torch.float16, 8192, 8192, "wgmma"),
    (torch.bfloat16, 520, 776, "wgmma"),
    (torch.float16, 72, 264, "wgmma"),
    (torch.float32, 8192, 8192, "simt"),
    (torch.float32, 36, 12, "simt"),
    (torch.bfloat16, 36, 8192, None),
    (torch.float16, 8192, 100, None),
])
def test_tile_choice_by_dtype_and_shape(dtype, k, n, tile):
    """K6 runs the Hopper tile on 16-bit operands and K1's SIMT tile on
    float32; it refuses 16-bit rows that are not a multiple of 16 bytes
    (its copies move 16-byte units), so every width it takes is one TMA
    can load."""
    if tile is None:
        with pytest.raises(ValueError, match="multiples of 16"):
            am.check_widths(k, n, dtype)
    else:
        am.check_widths(k, n, dtype)
        assert am.tile_for(dtype) == tile


def test_tile_choice_rejects_other_dtypes_and_counts_reset():
    with pytest.raises(ValueError, match="K6 takes"):
        am.tile_for(torch.int8)
    am.TILES["wgmma"] += 1
    am.reset_launches()
    assert am.TILES == {"wgmma": 0, "simt": 0} and am.LAUNCHES["a2a"] == 0


def test_buffer_layout():
    assert am.buffer_bytes(4, 8, 32, 16, torch.bfloat16) == am.FLAG_BYTES + 4 * 8 * 48 * 2
    bufs = am.loopback_buffers(3, 8, 32, 16, torch.float32, "cpu")
    assert bufs.d == 3 and bufs.epoch == 0 and bufs.ptrs[1] - bufs.ptrs[0] >= \
        am.buffer_bytes(3, 8, 32, 16, torch.float32)
    assert all(p % 256 == 0 for p in np.diff(bufs.ptrs))


# -- the shift-by-t exchanges on gloo worlds of 3 and 4 ranks -----------------------

DEADLINE_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shift_rank_main(rank, world, port, results):
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    try:
        rt = Runtime("cpu")
        mine = torch.full((2, 3), float(rank))
        shifts = {}
        for offset in range(-1, world + 1):
            for reverse in (False, True):
                (got,), handles = rt.ring_shift(mine, offset=offset, reverse=reverse)
                for h in handles:
                    h.wait()
                shifts[offset, reverse] = float(got[0, 0])
        a, w = _operands(world, seed=40 + world)
        rows = world * G
        x = torch.from_numpy(a[rank * rows:(rank + 1) * rows]).bfloat16()
        blocks = chunked_fusion.ring_a2a_chunk(
            torch.arange(world, dtype=torch.float32).repeat_interleave(2).reshape(world, 2)
            + 10 * rank, rt)
        out = am.alltoall_expert_matmul(x, torch.from_numpy(w[rank]).bfloat16(), rt)
        # the plain K4/K5 rings on the same world, [world G, K] a rank
        rings = (rc.ring_all_gather(x[:world * G], rt).float().numpy(),
                 rc.ring_reduce_scatter(x[:world * G], rt).float().numpy())
        results.put((rank, "ok", (shifts, blocks.numpy(), out.float().numpy(), rings)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("world", [3, 4])
def test_shift_by_t_exchanges_on_a_gloo_ring(world):
    """``Runtime.ring_shift(offset=t)`` sends to ``r + t`` and receives from
    ``r - t`` (the other way round with ``reverse``; an offset that is a
    multiple of the world returns the tensor); ``ring_a2a_chunk`` is the
    tiled all-to-all; the plain K6, K4 and K5 equal their one-process
    versions bit for bit (which ``test_torch_ring_collectives.py`` holds to
    the JAX kernels at these d)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_shift_rank_main, args=(r, world, port, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, status, payload = results.get(timeout=DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {world}-rank world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    a, w = _operands(world, seed=40 + world)
    want = am.alltoall_expert_matmul_virtual(
        list(torch.from_numpy(a).bfloat16().split(world * G)),
        [torch.from_numpy(x).bfloat16() for x in w])
    locals_ = [torch.from_numpy(a[r * world * G:(r * world + world) * G]).bfloat16()
               for r in range(world)]
    want_ag = rc.ring_all_gather_virtual(locals_)
    want_rs = rc.ring_reduce_scatter_virtual(locals_)
    for rank, (shifts, blocks, out, (ag, rs)) in got.items():
        np.testing.assert_array_equal(ag, want_ag[rank].float().numpy())
        np.testing.assert_array_equal(rs, want_rs[rank].float().numpy())
        for (offset, reverse), came_from in shifts.items():
            step = -offset if reverse else offset
            assert came_from == (rank - step) % world, (rank, offset, reverse)
        # block s came from rank s, which sent its block bound for this rank
        np.testing.assert_array_equal(blocks[:, 0], [rank + 10 * s for s in range(world)])
        np.testing.assert_array_equal(out, want[rank].float().numpy())
