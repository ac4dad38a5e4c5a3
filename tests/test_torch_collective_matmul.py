"""The ring collective matmuls K2 and K3: the port's one-process ring
(``ring_*_virtual``) against the JAX package's Pallas kernels, run under the
distributed TPU interpreter on a d-device mesh of the CPU simulation
(``pltpu.InterpretParams()``, as ``tests/test_pallas_ops.py`` runs them).

Tolerances. float32: 1e-5 absolute (both sides sum 32 products in float32,
in other orders). bf16 K2: within one bf16 ulp (each side rounds the same
float32 sum, computed in another order, once). bf16 K3 on dyadic operands
(multiples of 1/64, whose products and partial sums are exact in float32 in
any order): bit for bit against the JAX kernel and against a numpy fold in
ring order that rounds the partial and every hop's sum to bf16, the rounding
the JAX kernel pins (``test_ring_matmul_rs_wire_dtype_pin``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding, PartitionSpec as P

from ddlb_tpu.ops.collective_matmul import ring_ag_matmul, ring_matmul_rs
from ddlb_tpu_torch.ops import chunked_fusion
from ddlb_tpu_torch.ops import collective_matmul as cm
from ddlb_tpu_torch.runtime import Runtime
from ddlb_tpu_torch.utils.ring_schedule import coll_pipeline_row_map, ring_schedule
from torch_parity import assert_within_bf16_ulps, to_numpy

M_LOC, N, K = 16, 32, 32
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _operands(shape_a, shape_b, dtype, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape_a).astype(np.float32)
    b = rng.uniform(-1, 1, shape_b).astype(np.float32)
    if dyadic:
        a, b = np.round(a * 64) / 64, np.round(b * 64) / 64
    t_dtype, j_dtype = DTYPES[dtype]
    return (torch.from_numpy(a).to(t_dtype), torch.from_numpy(b).to(t_dtype),
            jnp.asarray(a).astype(j_dtype), jnp.asarray(b).astype(j_dtype))


def _jax_ring(kind, d, a, b):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d]), ("tp",))
    if kind == "ag":
        specs, out_spec = (P("tp", None), P(None, None)), P(None, None)

        def body(a_s, b_r):
            return ring_ag_matmul(a_s, b_r, axis_size=d, block_n=16, block_k=16,
                                  interpret=pltpu.InterpretParams())
    else:
        specs, out_spec = (P(None, "tp"), P("tp", None)), P("tp", None)

        def body(a_s, b_s):
            return ring_matmul_rs(a_s, b_s, axis_size=d, block_n=16, block_k=8,
                                  interpret=pltpu.InterpretParams())
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=out_spec,
                              check_vma=False))
    return f(jax.device_put(a, NamedSharding(mesh, specs[0])),
             jax.device_put(b, NamedSharding(mesh, specs[1])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_ring_ag_matmul_virtual_matches_jax(d, dtype):
    a, b, a_j, b_j = _operands((d * M_LOC, K), (K, N), dtype, seed=d)
    want = _jax_ring("ag", d, a_j, b_j)
    shards = list(a.split(M_LOC))
    outs = cm.ring_ag_matmul_virtual(shards, b)
    assert len(outs) == d
    for out in outs:
        assert out.shape == (d * M_LOC, N) and out.dtype == a.dtype
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(out), to_numpy(want), rtol=0, atol=1e-5)
        else:
            assert_within_bf16_ulps(out, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_ring_matmul_rs_virtual_matches_jax(d, dtype):
    kd = 16
    a, b, a_j, b_j = _operands((d * M_LOC, d * kd), (d * kd, N), dtype, seed=10 + d)
    want = to_numpy(_jax_ring("rs", d, a_j, b_j))
    a_shards = list(a.split(kd, dim=1))
    b_shards = list(b.split(kd))
    outs = cm.ring_matmul_rs_virtual(a_shards, b_shards)
    for r, out in enumerate(outs):
        assert out.shape == (M_LOC, N) and out.dtype == a.dtype
        rows = want[r * M_LOC:(r + 1) * M_LOC]
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(out), rows, rtol=0, atol=1e-5)
        else:
            # d roundings a hop on each side, in the same order: within d ulps
            assert_within_bf16_ulps(out, rows, ulps=d)


def _numpy_fold(a_shards, b_shards):
    """The ring in numpy: chunk c is folded by ranks c+1, c+2, ..., c; each
    partial and each sum rounded to bf16 (through torch's rounding)."""
    d = len(a_shards)
    m_loc = a_shards[0].shape[0] // d

    def bf16(x):
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    out = []
    for c in range(d):
        acc = None
        for t in range(d):
            j = (c + 1 + t) % d
            rows = a_shards[j][c * m_loc:(c + 1) * m_loc].float().numpy()
            part = bf16(rows @ b_shards[j].float().numpy())
            acc = part if acc is None else bf16(part + acc)
        out.append(acc)
    return out


@pytest.mark.parametrize("d", [2, 3, 4])
def test_ring_matmul_rs_bf16_rounds_every_hop_bit_for_bit(d):
    kd = 16
    a, b, a_j, b_j = _operands((d * M_LOC, d * kd), (d * kd, N), "bfloat16",
                               seed=20 + d, dyadic=True)
    a_shards, b_shards = list(a.split(kd, dim=1)), list(b.split(kd))
    outs = cm.ring_matmul_rs_virtual(a_shards, b_shards)
    want = np.asarray(_jax_ring("rs", d, a_j, b_j).astype(jnp.float32))
    folds = _numpy_fold(a_shards, b_shards)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out.float().numpy(), want[r * M_LOC:(r + 1) * M_LOC])
        np.testing.assert_array_equal(out.float().numpy(), folds[r])
    # the rounding at every hop shows: one float32 fold differs
    exact = sum(a_shards[j].float() @ b_shards[j].float() for j in range(d))
    assert not torch.equal(torch.cat(outs), exact.to(torch.bfloat16))


def test_ring_matmul_rs_gap_bound_covers_a_reordered_sum():
    """The bound holds for a K3 stand-in that sums each partial in another
    order (reversed k) and is tight enough to catch a dropped hop."""
    d, kd = 4, 64
    a, b, _, _ = _operands((d * M_LOC, d * kd), (d * kd, N), "bfloat16", seed=5)
    a_shards, b_shards = list(a.split(kd, dim=1)), list(b.split(kd))
    want = cm.ring_matmul_rs_virtual(a_shards, b_shards)
    bounds = cm.ring_matmul_rs_gap_bound(a_shards, b_shards)
    flipped = cm.ring_matmul_rs_virtual([x.flip(1) for x in a_shards],
                                        [x.flip(0) for x in b_shards])
    for r in range(d):
        assert bool(((flipped[r].float() - want[r].float()).abs() <= bounds[r]).all())
    dropped = want[0].float() - (a_shards[1][:M_LOC].float() @ b_shards[1].float())
    assert bool(((dropped - want[0].float()).abs() > bounds[0]).any())


def test_plain_versions_at_world_one_are_the_product():
    rt = Runtime("cpu")
    a, b, _, _ = _operands((M_LOC, K), (K, N), "bfloat16", seed=3)
    want = (a.float() @ b.float()).to(torch.bfloat16)
    assert torch.equal(cm.ring_ag_matmul(a, b, rt), want)
    assert torch.equal(cm.ring_matmul_rs(a, b, rt), want)
    before = dict(cm.LAUNCHES)
    cm.ring_ag_matmul(a, b, rt)
    assert cm.LAUNCHES == before  # plain calls are not launches


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda a, b, rt: cm.ring_ag_matmul(a, b[:8], rt), "contraction mismatch"),
        (lambda a, b, rt: cm.ring_ag_matmul(a, b.float(), rt), "operand dtypes differ"),
        (lambda a, b, rt: cm.ring_ag_matmul(a.int(), b.int(), rt), "K2/K3 take"),
        (lambda a, b, rt: cm.ring_ag_matmul(a[None], b, rt), "2-D operands"),
        (lambda a, b, rt: cm.ring_matmul_rs(a.int(), b.int(), rt), "K2/K3 take"),
        (lambda a, b, rt: cm.ring_ag_matmul_loopback([a, a], b), "cuda tensors"),
        (lambda a, b, rt: cm.Ring("ag", list(range(9)), 0, 1, a.dtype, None), "1 to 8"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, match):
    a, b, _, _ = _operands((M_LOC, K), (K, N), "bfloat16", seed=4)
    with pytest.raises(ValueError, match=match):
        call(a, b, Runtime("cpu"))


@pytest.mark.parametrize("dtype,k,n,tile", [
    (torch.bfloat16, 8192, 8192, "wgmma"),
    (torch.float16, 8192, 8192, "wgmma"),
    (torch.bfloat16, 520, 776, "wgmma"),
    (torch.float16, 72, 264, "wgmma"),
    (torch.float32, 8192, 8192, "simt"),
    (torch.float32, 33, 7, "simt"),
    (torch.bfloat16, 33, 8192, "wmma"),
    (torch.float16, 8192, 100, "wmma"),
    (torch.bfloat16, 4, 12, "wmma"),
])
def test_tile_choice_by_dtype_and_shape(dtype, k, n, tile):
    """K2 runs the Hopper tile where TMA can load its rows (16-bit, k and n
    a multiple of 16 bytes), K1's SIMT tile on float32, K1's wmma tile on
    other 16-bit widths."""
    assert cm.tile_for(dtype, k, n) == tile
    assert cm._kernel_tile("ag", dtype, k, n) == tile
    # K3 keeps K1's tiles
    assert cm._kernel_tile("rs", dtype, k, n) == ("simt" if dtype == torch.float32 else "wmma")


def test_tile_choice_rejects_other_dtypes():
    with pytest.raises(ValueError, match="K2/K3 take"):
        cm.tile_for(torch.int8, 64, 64)


def test_a_ring_serves_one_tile():
    """A ring's counters grow by the putting blocks of its tile, so a launch
    on another tile is refused before it reaches the card; the counts of
    launches by tile reset with the launch counts."""
    ring = cm.loopback_ring("ag", 2, 64 * 64, torch.bfloat16, "cpu")
    ring.tile = "wgmma"
    a, b = torch.zeros((64, 60), dtype=torch.bfloat16), torch.zeros((60, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="'wgmma' tile launched on the 'wmma' tile"):
        cm._launch("ag", ring, [a, a], [b, b], [a, a], 64, 64, 60)
    assert ring.epoch == 0
    cm.TILES["wgmma"] += 1
    cm.reset_launches()
    assert cm.TILES == {"wgmma": 0, "wmma": 0, "simt": 0}


def test_buffer_layout():
    assert cm.buffer_bytes(7, torch.bfloat16) == cm.FLAG_BYTES + 2 * 8 * 2
    assert cm.buffer_bytes(8, torch.float32) == cm.FLAG_BYTES + 2 * 8 * 4
    assert cm.buffer_bytes(3, torch.float16) % 16 == 0


@pytest.mark.parametrize("kind", ["ag_fwd", "ag_bwd", "rs_fwd", "rs_bwd"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_ring_schedule_matches_jax(kind, d):
    from ddlb_tpu import native

    np.testing.assert_array_equal(ring_schedule(d, kind), native.ring_schedule(d, kind))


@pytest.mark.parametrize("m,d,s", [(64, 2, 4), (96, 3, 8), (32, 4, 1)])
def test_coll_pipeline_row_map_matches_jax(m, d, s):
    from ddlb_tpu import native

    np.testing.assert_array_equal(coll_pipeline_row_map(m, d, s),
                                  native.coll_pipeline_row_map(m, d, s))


def test_ring_schedule_rejections():
    with pytest.raises(ValueError, match="unknown ring kind"):
        ring_schedule(2, "sideways")
    with pytest.raises(ValueError, match="positive"):
        ring_schedule(0)
    with pytest.raises(ValueError, match="multiple of d\\*s"):
        coll_pipeline_row_map(10, 2, 4)


def test_chunked_builders_pin_the_cuda_granularity():
    rt = Runtime("cpu")
    with pytest.raises(ValueError, match="pins chunk_count to the ring size"):
        chunked_fusion.build_chunked_ag_matmul(m=64, n=8, k=8, runtime=rt,
                                               chunk_count=2, path="cuda")
    with pytest.raises(ValueError, match="pins chunk_count to the ring size"):
        chunked_fusion.build_chunked_matmul_rs(m=64, n=8, k=8, runtime=rt,
                                               chunk_count=4, path="cuda")
    with pytest.raises(ValueError, match="must be divisible by partitions\\*chunk_count"):
        chunked_fusion.build_chunked_ag_matmul(m=63, n=8, k=8, runtime=rt, chunk_count=2)
    with pytest.raises(ValueError, match="path must be one of"):
        chunked_fusion.build_chunked_matmul_rs(m=64, n=8, k=8, runtime=rt,
                                               chunk_count=2, path="pallas")
    a, b, _, _ = _operands((64, 8), (8, 16), "bfloat16", seed=6)
    for build in (chunked_fusion.build_chunked_ag_matmul,
                  chunked_fusion.build_chunked_matmul_rs):
        step = build(m=64, n=16, k=8, runtime=rt, chunk_count=1, path="cuda")
        assert torch.equal(step(a, b), (a.float() @ b.float()).to(torch.bfloat16))
