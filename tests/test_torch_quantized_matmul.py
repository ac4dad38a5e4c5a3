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
