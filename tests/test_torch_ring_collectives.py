"""The pure ring collectives K4 and K5: the port's one-process ring
(``ring_*_virtual``) and its plain ring over ``Runtime.ring_shift`` against
the JAX package's Pallas kernels, run under the distributed TPU interpreter
on a d-device mesh of the CPU simulation (``pltpu.InterpretParams()``, as
``tests/test_torch_collective_matmul.py`` runs K2/K3).

Tolerances. K4 moves data: bit for bit in every dtype. K5 in float32 folds
d terms, each hop rounding once, in the ring's order on both sides: within
1e-6 * d absolute. K5 in bf16 on dyadic operands (multiples of 1/64, whose
sums over a few ranks are exact in float32): bit for bit against the JAX
kernel and against a numpy fold in ring order that rounds every hop's sum
to bf16, the rounding of the JAX kernel's operand-dtype accumulator.
Each hop stays under the interpreter's 12 KB envelope
(``ddlb_tpu/ops/ring_collectives.py:29-37``).
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

from ddlb_tpu.ops.collective_matmul import ring_matmul_rs
from ddlb_tpu.ops.ring_collectives import ring_all_gather, ring_reduce_scatter
from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.ops import ring_collectives as rc
from ddlb_tpu_torch.runtime import Runtime
from torch_parity import to_numpy

#: rows a rank and row width: a K4 hop is [8, 64] (2 KB in f32); a K5 hop
#: is one of d chunks of [8 d, 64] / d
ROWS, K = 8, 64
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _payload(m, dtype, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (m, K)).astype(np.float32)
    if dyadic:
        a = np.round(a * 64) / 64
    t_dtype, j_dtype = DTYPES[dtype]
    return torch.from_numpy(a).to(t_dtype), jnp.asarray(a).astype(j_dtype)


def _jax_collective(kind, d, a):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d]), ("tp",))
    if kind == "all_gather":
        out_spec = P(None, None)

        def body(a_s):
            return ring_all_gather(a_s, axis_size=d, interpret=pltpu.InterpretParams())
    else:
        out_spec = P("tp", None)

        def body(a_s):
            return ring_reduce_scatter(a_s, axis_size=d, interpret=pltpu.InterpretParams())
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("tp", None),),
                              out_specs=out_spec, check_vma=False))
    return np.asarray(f(jax.device_put(a, NamedSharding(mesh, P("tp", None))))
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_ring_all_gather_virtual_matches_jax_bit_for_bit(d, dtype):
    a, a_j = _payload(d * ROWS, dtype, seed=d)
    want = _jax_collective("all_gather", d, a_j)
    outs = rc.ring_all_gather_virtual(list(a.split(ROWS)))
    assert len(outs) == d
    for out in outs:
        assert out.shape == (d * ROWS, K) and out.dtype == a.dtype
        np.testing.assert_array_equal(out.float().numpy(), want)
        assert torch.equal(out, a)


def _numpy_fold(a_locals):
    """K5's ring in numpy: chunk c is folded by ranks c+1, c+2, ..., c;
    every hop's sum rounded to the operand dtype (through torch)."""
    d = len(a_locals)
    rows = a_locals[0].shape[0] // d
    dtype = a_locals[0].dtype

    def rnd(x):
        return torch.from_numpy(x).to(dtype).float().numpy()

    out = []
    for c in range(d):
        acc = None
        for t in range(d):
            j = (c + 1 + t) % d
            part = a_locals[j][c * rows:(c + 1) * rows].float().numpy()
            acc = part if acc is None else rnd(part + acc)
        out.append(acc)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_ring_reduce_scatter_virtual_matches_jax(d, dtype):
    a, a_j = _payload(d * d * ROWS, dtype, seed=10 + d, dyadic=dtype == "bfloat16")
    want = _jax_collective("reduce_scatter", d, a_j)
    a_locals = list(a.split(d * ROWS))
    outs = rc.ring_reduce_scatter_virtual(a_locals)
    folds = _numpy_fold(a_locals)
    for r, out in enumerate(outs):
        assert out.shape == (ROWS, K) and out.dtype == a.dtype
        rows = want[r * ROWS:(r + 1) * ROWS]
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(out), rows, rtol=0, atol=1e-6 * d)
        else:
            np.testing.assert_array_equal(out.float().numpy(), rows)
            np.testing.assert_array_equal(out.float().numpy(), folds[r])


def test_ring_reduce_scatter_rounds_every_hop_in_bf16():
    """The operand-dtype accumulator shows: a bf16 ulp at 1 is 2^-7, so
    1 + 3 * 2^-10 rounds to 1 at each hop, while 1 + 2 * (3 * 2^-10) summed in
    float32 and rounded once is 1 + 2^-7 (the chunks whose ring adds 1
    before the two small terms)."""
    d = 3
    small = 3 * 2.0**-10
    a_locals = [torch.full((d * 2, 8), v, dtype=torch.bfloat16) for v in (1.0, small, small)]
    outs = rc.ring_reduce_scatter_virtual(a_locals)
    exact = sum(x.float() for x in a_locals).to(torch.bfloat16)
    assert not torch.equal(torch.cat(outs), exact[: d * 2])
    for out, fold in zip(outs, _numpy_fold(a_locals)):
        np.testing.assert_array_equal(out.float().numpy(), fold)


def test_plain_versions_at_world_one():
    rt = Runtime("cpu")
    a, _ = _payload(ROWS, "bfloat16", seed=3)
    assert torch.equal(rc.ring_all_gather(a, rt), a)
    assert torch.equal(rc.ring_reduce_scatter(a, rt), a)
    before = dict(rc.LAUNCHES)
    rc.ring_all_gather(a, rt)
    rc.ring_reduce_scatter(a, rt)
    assert rc.LAUNCHES == before  # plain calls are not launches


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda a, rt: rc.ring_all_gather(a.int(), rt), "K4/K5 take"),
        (lambda a, rt: rc.ring_all_gather(a.double(), rt), "K4/K5 take"),
        (lambda a, rt: rc.ring_reduce_scatter(a[:, :4], rt), "16-byte units"),
        (lambda a, rt: rc.ring_all_gather(a[None], rt), "2-D operands"),
        (lambda a, rt: rc.ring_all_gather(a[:0], rt), "non-empty"),
        (lambda a, rt: rc.ring_all_gather_loopback([a, a]), "cuda tensors"),
        (lambda a, rt: rc.ring_reduce_scatter_loopback([a, a[:4]]), "same shape"),
        (lambda a, rt: rc.ring_reduce_scatter_virtual([a[:3], a[:3]]), "not divisible"),
        (lambda a, rt: rc.loopback_ring("ag", 2, 8, a.dtype, "cpu"), "ring kind"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, match):
    a, _ = _payload(ROWS, "bfloat16", seed=4)
    with pytest.raises(ValueError, match=match):
        call(a, Runtime("cpu"))


def test_rings_share_the_collective_matmul_layout():
    """K4/K5's rings are ``collective_matmul.Ring``s of their own kinds,
    so a K2/K3 ring is refused by them and theirs by K2/K3."""
    ring = rc.loopback_ring("all_gather", 2, ROWS * K, torch.float32, "cpu")
    assert isinstance(ring, cm.Ring) and ring.kind == "all_gather" and ring.d == 2
    assert ring.owner.numel() >= 2 * cm.buffer_bytes(ROWS * K, torch.float32)
    a = torch.zeros((ROWS, K))
    with pytest.raises(ValueError, match="'ag' ring passed to the 'all_gather'"):
        cm.check_launch(cm.loopback_ring("ag", 2, ROWS * K, torch.float32, "cpu"),
                         "all_gather", (a,), ROWS * K)


def _check_flag_layout(kind, d, blocks):
    """Per-block flags of a ``kind`` ring at ring size ``d`` and a grid of
    ``blocks``: each block's arrival and credit words of every step are
    distinct words of the flag area, clear of the entry barrier (and K2/K3's
    step counters) in its first 1 KB; the slots follow the flag area as in
    every ring."""
    words = set()
    for b in range(blocks):
        for t in range(d):
            arrive, credit = rc.block_flag_offsets(b, t)
            words.update((arrive, credit))
            assert 1024 <= arrive < credit < cm.FLAG_BYTES
            assert arrive % 4 == credit % 4 == 0
    assert len(words) == 2 * blocks * d
    for chunk_numel, dtype in ((7, torch.bfloat16), (512 * 8192, torch.bfloat16),
                               (3, torch.float32)):
        size = torch.empty((), dtype=dtype).element_size()
        slot = -(-chunk_numel * size // 16) * 16
        assert cm.buffer_bytes(chunk_numel, dtype) == cm.FLAG_BYTES + 2 * slot
        ring = rc.loopback_ring(kind, d, chunk_numel, dtype, "cpu")
        assert ring.owner.numel() >= d * cm.buffer_bytes(chunk_numel, dtype)
        assert all(p % 256 == 0 for p in np.diff(ring.ptrs))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("blocks", [1, 66, 132, 264, rc.MAX_FLAG_BLOCKS])
def test_k5_flag_layout_fits_every_grid(d, blocks):
    """K5's per-block flags at every ring size and grid (two blocks an SM
    of an H100's 132 is 264; loopback shares them among d ranks)."""
    _check_flag_layout("reduce_scatter", d, blocks)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("blocks", [1, 66, 132, 264, rc.MAX_FLAG_BLOCKS])
def test_k4_flag_layout_fits_every_grid(d, blocks):
    """K4's per-block flags, the same words on its own ring."""
    _check_flag_layout("all_gather", d, blocks)


def test_k5_flag_layout_refuses_what_it_does_not_hold():
    assert rc.MAX_FLAG_BLOCKS >= 2 * 132  # two blocks on each SM of an H100
    for block, step in ((rc.MAX_FLAG_BLOCKS, 0), (-1, 0), (0, cm.MAX_RANKS)):
        with pytest.raises(ValueError, match="K4/K5 hold"):
            rc.block_flag_offsets(block, step)


# -- the plain K3 and K5 rings on gloo worlds of 2, 3 and 4 ranks ---------------------

DEADLINE_S = 120
#: K3 a rank: [d M_LOC, d KD] @ [d KD, N] over the world, rows M_LOC a rank out
M_LOC, KD, N = 8, 16, 32


def _plain_rank_main(rank, world, port, results):
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    import torch.distributed as dist

    try:
        rt = Runtime("cpu")
        a, b, payload = _plain_operands(world)
        k3 = cm.ring_matmul_rs(a[:, rank * KD:(rank + 1) * KD].contiguous(),
                               b[rank * KD:(rank + 1) * KD], rt)
        k5 = rc.ring_reduce_scatter(payload[rank * world * ROWS:(rank + 1) * world * ROWS], rt)
        results.put((rank, "ok", (k3.float().numpy(), k5.float().numpy())))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _plain_operands(world):
    """bf16 K3 operands (multiples of 1/64) and a K5 payload of
    [world^2 ROWS, K] (multiples of 1/64), from a seed."""
    rng = np.random.default_rng(60 + world)
    a = np.round(rng.uniform(-1, 1, (world * M_LOC, world * KD)) * 64) / 64
    b = np.round(rng.uniform(-1, 1, (world * KD, N)) * 64) / 64
    payload = np.round(rng.uniform(-1, 1, (world * world * ROWS, K)) * 64) / 64
    return tuple(torch.from_numpy(x.astype(np.float32)).bfloat16() for x in (a, b, payload))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_plain_k3_and_k5_on_a_gloo_ring_match_jax(world):
    """``ring_matmul_rs_plain`` and ``ring_reduce_scatter_plain`` (the
    wrappers on CPU tensors) on a gloo world of 2, 3 and 4 ranks, one hop
    of ``Runtime.ring_shift`` a step, against the JAX package's Pallas
    kernels under the distributed interpreter on a mesh of as many
    devices: bit for bit on bf16 multiples of 1/64 (every partial and
    every hop's sum exact in float32, both sides rounding the same values
    to bf16 at every hop)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=_plain_rank_main, args=(r, world, port, results), daemon=True)
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
    a, b, payload = _plain_operands(world)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("tp",))
    specs = (P(None, "tp"), P("tp", None))

    def k3_body(a_s, b_s):
        return ring_matmul_rs(a_s, b_s, axis_size=world, block_n=16, block_k=8,
                              interpret=pltpu.InterpretParams())

    k3 = jax.jit(jax.shard_map(k3_body, mesh=mesh, in_specs=specs, out_specs=P("tp", None),
                               check_vma=False))
    want_k3 = np.asarray(k3(*(jax.device_put(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                             NamedSharding(mesh, spec))
                              for x, spec in ((a, specs[0]), (b, specs[1]))))
                         .astype(jnp.float32))
    want_k5 = _jax_collective("reduce_scatter", world,
                              jnp.asarray(payload.float().numpy()).astype(jnp.bfloat16))
    for rank, (k3_out, k5_out) in got.items():
        np.testing.assert_array_equal(k3_out, want_k3[rank * M_LOC:(rank + 1) * M_LOC])
        np.testing.assert_array_equal(k5_out, want_k5[rank * ROWS:(rank + 1) * ROWS])
