"""Tests of the port that need an NVIDIA card; they skip elsewhere.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch, without the suite's JAX ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Tolerances. On integer-valued operands the kernel equals its plain version
bit for bit: every product and partial sum is an integer below 2**24, exact
in float32 in any order, and both sides round the same value once. On
uniform operands bf16/fp16 stay within ``k1.plain_gap_bound`` (the two
float32 summation orders plus one output rounding), f32 within atol
1e-5 * k (a tenth of the repo's f32 validation contract).
"""

import numpy as np
import pytest
import torch

from ddlb_tpu_torch.ops import matmul as k1
from ddlb_tpu_torch.primitives.registry import load_impl_class
from torch_parity import to_numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _uniform(shape, dtype, gen, device):
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,n,k,dtype",
    [
        (1024, 1024, 1024, torch.bfloat16),
        (1000, 776, 520, torch.bfloat16),
        (7, 9, 33, torch.bfloat16),
        (513, 257, 129, torch.float16),
        (300, 200, 100, torch.float32),
        (129, 131, 7, torch.float32),
    ],
)
def test_kernel_matches_plain(cuda_device, m, n, k, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = _uniform((m, k), dtype, gen, cuda_device)
    b = _uniform((k, n), dtype, gen, cuda_device)
    before = k1.LAUNCHES
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    want = k1.matmul_plain(a, b)
    assert got.shape == (m, n) and got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(
            to_numpy(got), to_numpy(want), rtol=0, atol=1e-5 * k
        )
    else:
        gap = (got.float() - want.float()).abs()
        bound = k1.plain_gap_bound(a, b, got, want)
        assert bool((gap <= bound).all()), float((gap - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("m,n,k", [(1000, 776, 520), (256, 384, 2048), (7, 9, 33)])
def test_kernel_exact_on_integer_operands(cuda_device, m, n, k, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randint(-4, 5, (m, k), generator=gen, device=cuda_device).to(dtype)
    b = torch.randint(-4, 5, (k, n), generator=gen, device=cuda_device).to(dtype)
    got = k1.matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.matmul_plain(a, b))


@pytest.mark.cuda
def test_kernel_rejects_strided_operands(cuda_device):
    a = torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k1.matmul(a.t(), a)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
def test_cuda_member_runs_k1_and_validates(cuda_device, family):
    impl = load_impl_class(family, "cuda")(1024, 512, 768, dtype="bfloat16")
    assert impl.device.type == "cuda"
    before = k1.LAUNCHES
    result = impl.run()
    assert k1.LAUNCHES == before + 1
    assert impl.validate(result)
