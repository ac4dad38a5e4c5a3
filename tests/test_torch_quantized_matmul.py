"""The port's int8 quantization and int8 GEMMs against the JAX package's.

The same seeded float operands go through both packages' quantize
helpers (the JAX ones compiled by ``jax.jit``, as its members and its
model run them; and ``quantize_weight_stack`` also eagerly, as its
``init_params`` calls it), and the same int8 operands and scales through the JAX
``int8_matmul`` (XLA) and ``int8_matmul_pallas`` (Pallas, interpret
mode, as on the CPU by itself) and through the port's ``int8_matmul``
(``torch._int_mm``) and K7's plain version ``int8_matmul_plain`` (the
wrapper ``int8_matmul_kernel`` takes it for CPU tensors).

Tolerance: none. The quantize helpers are the same float32 operations
(a product with the float32 constant 1/127, which is what XLA makes of
``/ 127``, or the division itself where JAX runs eagerly; ``round``
half-to-even in both), the int8 sums are exact integers in
every implementation, and the epilogue ``acc * sa * sb`` has no addition
to contract, so every result is compared bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddlb_tpu.ops import quantized_matmul as jqm
from ddlb_tpu_torch.ops import quantized_matmul as qm
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _pair(x: np.ndarray, dtype: str):
    """The same float32 host array as a JAX array and a torch tensor of
    ``dtype`` (both round float32 to the dtype to nearest even)."""
    j = jnp.asarray(x, JDT[dtype])
    return j, _tensor_from_numpy(np.asarray(j))


def _assert_bit_equal(got: torch.Tensor, want) -> None:
    want = _tensor_from_numpy(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())


def _operands(shape, dtype, seed, zero_row=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32) * rng.uniform(0.1, 3.0)
    if zero_row:
        x[1] = 0.0  # the all-zero guard: scale 1e-30, q all zero
        x[:, 2] = 0.0
    return _pair(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,shape",
    [
        ("quantize_rowwise", (13, 40)),
        ("quantize_colwise", (40, 13)),
        ("quantize_weight_stack", (2, 3, 40, 13)),
    ],
)
def test_quantize_helpers_bit_equal(name, shape, dtype):
    j, t = _operands(shape, dtype, seed=len(shape))
    jq, js = jax.jit(getattr(jqm, name))(j)
    tq, ts = getattr(qm, name)(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _assert_bit_equal(tq, jq)
    _assert_bit_equal(ts, js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_weight_stack_bit_equal(dtype):
    j, t = _operands((2, 3, 40, 13), dtype, seed=9)
    jq, js = jqm.quantize_weight_stack(j)
    tq, ts = qm.quantize_weight_stack(t, eager=True)
    _assert_bit_equal(tq, jq)
    _assert_bit_equal(ts, js)


def test_zero_slices_quantize_to_zero():
    _, t = _operands((6, 8), "float32", seed=1)
    q, s = qm.quantize_rowwise(t)
    assert float(s[1, 0]) == pytest.approx(1e-30) and not q[1].any()
    q, s = qm.quantize_colwise(t)
    assert not q[:, 2].any()


def _int8_inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    bq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    sa = rng.uniform(1e-4, 2e-2, (m, 1)).astype(np.float32)
    sb = rng.uniform(1e-4, 2e-2, (1, n)).astype(np.float32)
    return (aq, bq, sa, sb), tuple(torch.from_numpy(x) for x in (aq, bq, sa, sb))


#: ragged shapes (one row, odd widths, k not a multiple of 16) and the
#: Pallas kernel's block-divisible ones
SHAPES = [(1, 24, 40), (7, 40, 64), (33, 48, 96), (64, 128, 256)]


@pytest.mark.parametrize("out", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_int8_gemms_bit_equal_to_xla(m, n, k, out):
    host, (aq, bq, sa, sb) = _int8_inputs(m, n, k, seed=m + n + k)
    want = jqm.int8_matmul(*(jnp.asarray(x) for x in host), out_dtype=JDT[out])
    for fn in (qm.int8_matmul, qm.int8_matmul_plain, qm.int8_matmul_kernel):
        _assert_bit_equal(fn(aq, bq, sa, sb, out_dtype=TDT[out]), want)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [(64, 128, 256), (16, 32, 96)])
def test_plain_bit_equal_to_pallas_interpret(m, n, k, out):
    host, (aq, bq, sa, sb) = _int8_inputs(m, n, k, seed=7)
    want = jqm.int8_matmul_pallas(
        *(jnp.asarray(x) for x in host), block_m=16, block_n=32, block_k=32,
        out_dtype=JDT[out], interpret=True,
    )
    before = qm.LAUNCHES
    _assert_bit_equal(qm.int8_matmul_kernel(aq, bq, sa, sb, out_dtype=TDT[out]), want)
    _assert_bit_equal(qm.int8_matmul_plain(aq, bq, sa, sb, out_dtype=TDT[out]), want)
    assert qm.LAUNCHES == before  # a CPU tensor takes the plain version


def test_column_major_weight_is_the_same_product():
    """The members' ``kernel=xla`` rows lay the weight out k-contiguous."""
    _, (aq, bq, sa, sb) = _int8_inputs(9, 24, 64, seed=3)
    col = bq.t().contiguous().t()
    assert not col.is_contiguous()
    assert torch.equal(qm.int8_matmul(aq, col, sa, sb), qm.int8_matmul(aq, bq, sa, sb))


@pytest.mark.parametrize("k", [1, 64, 8192])
def test_quantization_atol_matches_jax(k):
    assert qm.quantization_atol(k) == jqm.quantization_atol(k)


@pytest.mark.parametrize(
    "change,match",
    [
        (lambda a, b, sa, sb: (a.float(), b, sa, sb), "int8 operands"),
        (lambda a, b, sa, sb: (a, b[:-1], sa, sb), "contraction mismatch"),
        (lambda a, b, sa, sb: (a, b, sa.double(), sb), "float32"),
        (lambda a, b, sa, sb: (a, b, sa.t(), sb), r"scales must be \[9, 1\]"),
        (lambda a, b, sa, sb: (a[None], b, sa, sb), "2-D operands"),
    ],
)
def test_kernel_wrapper_rejects_bad_operands(change, match):
    _, ops = _int8_inputs(9, 24, 64, seed=5)
    with pytest.raises(ValueError, match=match):
        qm.int8_matmul_kernel(*change(*ops))


def test_kernel_wrapper_rejects_other_out_dtypes():
    _, ops = _int8_inputs(9, 24, 64, seed=5)
    with pytest.raises(ValueError, match="K7 int8_matmul writes"):
        qm.int8_matmul_kernel(*ops, out_dtype=torch.int32)


# -- the column-major int8 weights of K7's Hopper tiles --------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,shape,eager",
    [("quantize_colwise", (40, 13), False), ("quantize_weight_stack", (2, 3, 40, 13), False),
     ("quantize_weight_stack", (2, 3, 40, 13), True)],
)
def test_weight_roles_quantize_column_major(name, shape, eager, dtype):
    """The weight roles return the JAX package's values with every
    ``[k, n]`` matrix column-major (k contiguous) and contiguous scales;
    ``eager`` as the JAX ``init_params`` calls it."""
    j, t = _operands(shape, dtype, seed=11 + len(shape))
    jfn = getattr(jqm, name) if eager else jax.jit(getattr(jqm, name))
    jq, js = jfn(j)
    tq, ts = (qm.quantize_weight_stack(t, eager=True) if eager else getattr(qm, name)(t))
    _assert_bit_equal(tq, jq)
    _assert_bit_equal(ts, js)
    assert tq.stride()[-2:] == (1, shape[-2]) and ts.is_contiguous()
    for matrix in tq.reshape(-1, *shape[-2:]).unbind(0) if tq.dim() > 2 else [tq]:
        assert qm.layout_of(matrix) == "col"


def test_int8_weights_params_are_column_major_jax_values():
    """``init_params`` and ``params_from_numpy`` lay the ``int8_weights``
    expert stacks out column-major with the JAX package's values, and
    ``shard_params`` and ``place_params`` keep the layout."""
    from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
    from ddlb_tpu.models.transformer import init_params as jax_init
    from ddlb_tpu_torch.models import transformer as tmodel

    width = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, layers_per_stage=2,
                 mlp_kernel="int8_weights")
    jp = jax_init(JaxConfig(**width, dtype=jnp.bfloat16), pp=1, n_experts=2, seed=0)
    tc = tmodel.TransformerConfig(**width, dtype=torch.bfloat16)
    ours = tmodel.init_params(tc, pp=1, n_experts=2, seed=0)
    carried = tmodel.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    for params in (ours, carried):
        for name in ("moe_w1", "moe_w2"):
            _assert_bit_equal(params[name], jp[name])
            assert params[name].stride()[-2] == 1, name
    for r in range(2):
        placed = tmodel.place_params(tmodel.shard_params(carried, tc, 2, r), "cpu")
        for name in ("moe_w1", "moe_w2"):
            w = placed[name][0, 1, 0]
            assert qm.layout_of(w) == "col" and torch.equal(w, carried[name][0, 1, r])
        assert placed["embed"].is_contiguous()


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise", "dp_allreduce",
                                    "ep_alltoall"])
def test_member_weight_layout_is_column_major(family, kernel):
    """``QuantizedGEMMMixin._weight_layout``: both kernels read the same
    column-major int8 weight, the JAX package's quantized values."""
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    impl = load_impl_class(family, "quantized")(
        64, 48, 96, dtype="bfloat16", device="cpu", kernel=kernel, quantize="static")
    weight, float_weight = ((impl.wq, impl.w) if family == "ep_alltoall"
                            else (impl.bq, impl.b))
    assert qm.layout_of(weight) == "col" and not weight.is_contiguous()
    jq, _ = jax.jit(jqm.quantize_colwise)(
        jnp.asarray(float_weight.float().numpy()).astype(jnp.bfloat16))
    _assert_bit_equal(weight, jq)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [(64, 128, 256), (16, 32, 96)])
def test_plain_on_a_column_major_weight_bit_equal_to_pallas_interpret(m, n, k, out):
    host, (aq, bq, sa, sb) = _int8_inputs(m, n, k, seed=8)
    want = jqm.int8_matmul_pallas(
        *(jnp.asarray(x) for x in host), block_m=16, block_n=32, block_k=32,
        out_dtype=JDT[out], interpret=True,
    )
    col = qm.column_major(bq)
    assert qm.layout_of(col) == "col" and torch.equal(col, bq)
    before = qm.LAUNCHES
    _assert_bit_equal(qm.int8_matmul_kernel(aq, col, sa, sb, out_dtype=TDT[out]), want)
    _assert_bit_equal(qm.int8_matmul_plain(aq, col, sa, sb, out_dtype=TDT[out]), want)
    _assert_bit_equal(qm.int8_matmul(aq, col, sa, sb, out_dtype=TDT[out]), want)
    assert qm.LAUNCHES == before


#: ``chip_smoke.py``'s K7 shapes and the tile each runs on a column-major
#: weight at aligned bases: wgmma above ``SMALL_M`` rows, small_m at or
#: below, mma where k is not a multiple of 16
CHECKED_TILES = [
    (8192, 8192, 8192, "wgmma"), (8, 8192, 2048, "small_m"), (8, 2048, 8192, "small_m"),
    (65536, 8192, 2048, "wgmma"), (65536, 2048, 8192, "wgmma"), (1, 200, 2048, "small_m"),
    (127, 200, 2048, "wgmma"), (1000, 776, 520, "mma"), (2048, 2048, 2048, "wgmma"),
    (129, 131, 7, "mma"), (17, 1000, 1040, "small_m"), (64, 33800, 256, "small_m"),
    (65, 200, 2048, "wgmma"), (300, 1003, 512, "wgmma"),
]


@pytest.mark.parametrize("m,n,k,tile", CHECKED_TILES)
def test_tile_for_the_checked_shapes(m, n, k, tile):
    assert qm.tile_for(m, n, k, "col", 0, 4096) == tile
    assert qm.tile_for(m, n, k, "row", 0, 4096) == "mma"  # s8 wgmma reads K-major only
    assert qm.tile_for(m, n, k, "col", 1, 4096) == "mma"  # an unaligned base
    assert qm.tile_for(m, n, k, "col", 0, 4112) == tile   # 16-byte aligned is enough


def test_tile_for_covers_chip_smokes_checks():
    import chip_smoke

    assert [(m, n, k) for m, n, k, *_ in chip_smoke.INT8_CHECKS] == [
        (m, n, k) for m, n, k, _ in CHECKED_TILES]


def test_tile_for_edges():
    assert qm.tile_for(qm.SMALL_M, 64, 16, "col") == "small_m"
    assert qm.tile_for(qm.SMALL_M + 1, 64, 16, "col") == "wgmma"
    assert qm.tile_for(8, 64, 0, "col") == "mma"  # no k: nothing for TMA to load
    with pytest.raises(ValueError, match="layout"):
        qm.tile_for(8, 64, 16, "k-major")


def test_layout_of_reads_the_strides():
    _, (_, bq, _, _) = _int8_inputs(9, 24, 64, seed=3)
    assert qm.layout_of(bq) == "row"
    assert qm.layout_of(qm.column_major(bq)) == "col"
    assert qm.layout_of(bq[:1]) == "col"  # one row: both layouts at once
    assert qm.layout_of(bq[:, :1].contiguous()) == "col"
    with pytest.raises(ValueError, match="row-major or column-major"):
        qm.layout_of(bq[:, ::2])


def test_reset_launches_zeroes_the_tiles():
    qm.TILES["wgmma"] += 3
    qm.LAUNCHES += 3
    qm.reset_launches()
    assert qm.LAUNCHES == 0 and qm.TILES == {"wgmma": 0, "small_m": 0, "mma": 0}
