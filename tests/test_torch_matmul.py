"""K1, the port's hand-written GEMM (``ddlb_tpu_torch/ops/matmul.py``),
against the JAX package's Pallas GEMM run in interpret mode.

On the CPU the wrapper takes its plain version (the f32 product rounded
once), which is what these tests hold against Pallas: f32 at atol 1e-4
(the rule of ``test_pallas_ops.py``), bf16 within 1 bf16 ulp (both sides
sum in f32 and round once). The CUDA kernel itself cannot run here:
``test_torch_card.py`` holds it against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlb_tpu.ops.matmul import matmul as pallas_matmul
from ddlb_tpu_torch.ops import _build
from ddlb_tpu_torch.ops import matmul as k1
from torch_parity import assert_within_bf16_ulps, to_numpy


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 1, (m, k)).astype(np.float32),
        rng.normal(0, 1, (k, n)).astype(np.float32),
    )


@pytest.mark.parametrize("shape", [(256, 128, 256), (128, 256, 128)])
def test_plain_matches_pallas_f32(shape):
    m, k, n = shape
    a, b = _operands(m, k, n)
    want = pallas_matmul(
        jnp.asarray(a), jnp.asarray(b), block_m=128, block_n=128, block_k=64,
        interpret=True,
    )
    got = k1.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(256, 128, 256), (128, 256, 128)])
def test_plain_matches_pallas_bf16(shape):
    m, k, n = shape
    a, b = _operands(m, k, n, seed=1)
    a16 = jnp.asarray(a).astype(jnp.bfloat16)
    b16 = jnp.asarray(b).astype(jnp.bfloat16)
    want = pallas_matmul(
        a16, b16, block_m=128, block_n=128, block_k=64, interpret=True
    )
    got = k1.matmul(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    )
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulps(got, want)


def test_cpu_tensor_takes_plain_version_without_launch():
    a, b = (torch.from_numpy(x) for x in _operands(64, 32, 48))
    before = k1.LAUNCHES
    got = k1.matmul(a.half(), b.half())
    assert k1.LAUNCHES == before
    assert torch.equal(got, k1.matmul_plain(a.half(), b.half()))
    assert got.dtype == torch.float16


def test_plain_is_f32_sum_rounded_once():
    a, b = (torch.from_numpy(x).bfloat16() for x in _operands(32, 64, 16))
    want = (a.double() @ b.double()).float().bfloat16()
    assert_within_bf16_ulps(k1.matmul_plain(a, b), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_gap_bound_admits_order_not_error(dtype):
    """The bound the card holds K1 to admits another float32 summation
    order, and not a product that lost one term of k."""
    a, b = (torch.from_numpy(x).to(dtype) for x in _operands(64, 512, 48, seed=2))
    want = k1.matmul_plain(a, b)

    def within(got):
        gap = (got.float() - want.float()).abs()
        return bool((gap <= k1.plain_gap_bound(a, b, got, want)).all())

    assert within((a.float().flip(1) @ b.float().flip(0)).to(dtype))
    assert not within((a[:, 1:].float() @ b[1:].float()).to(dtype))


@pytest.mark.parametrize(
    "a_shape,b_shape,dtype,match",
    [
        ((64, 32), (64, 64), torch.float32, "contraction mismatch"),
        ((4, 4, 4), (4, 4), torch.float32, "2-D operands"),
        ((8, 8), (8, 8), torch.int32, "K1 matmul takes"),
        ((8, 8), (8, 8), torch.float64, "K1 matmul takes"),
    ],
)
def test_wrapper_rejects(a_shape, b_shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        k1.matmul(torch.zeros(a_shape, dtype=dtype), torch.zeros(b_shape, dtype=dtype))
    if match == "contraction mismatch":
        # the same error as the JAX kernel's wrapper
        with pytest.raises(ValueError, match=match):
            pallas_matmul(
                jnp.zeros(a_shape), jnp.zeros(b_shape), interpret=True
            )


def test_wrapper_rejects_mixed_dtypes():
    with pytest.raises(ValueError, match="dtypes differ"):
        k1.matmul(torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.bfloat16))


def test_only_cpu_tensors_take_the_plain_version():
    """Any device but the CPU launches the kernel or raises: a tensor on
    PyTorch's meta device is refused, not computed plainly."""
    a = torch.zeros((8, 8), device="meta")
    before = k1.LAUNCHES
    with pytest.raises(ValueError, match="cuda or cpu tensors"):
        k1.matmul(a, a)
    assert k1.LAUNCHES == before


def test_build_targets_sm90a_and_needs_nvcc(monkeypatch, tmp_path):
    cmd = _build.nvcc_command("nvcc", "matmul", tmp_path / "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/matmul.cu")
    assert _build.library_path("matmul").parent == _build.BUILD_DIR
    # with no compiler anywhere the build raises; it never falls back
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_path_tracks_source():
    path = _build.library_path("matmul")
    assert path.name.startswith("matmul-") and path.suffix == ".so"
    assert path == _build.library_path("matmul")


def test_library_path_tracks_headers(monkeypatch, tmp_path):
    """An edited ``csrc/*.cuh`` (the Hopper tile K2 and K6 include) gives
    every library a new path, so a stale build is never loaded."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in ("collective_matmul", "matmul")}
    header = csrc / "hopper_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in before}
    assert all(after[name] != before[name] for name in before)
    assert all(after[name].name.startswith(f"{name}-") for name in after)
    # the source itself still counts
    source = csrc / "collective_matmul.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build.library_path("collective_matmul") != after["collective_matmul"]


def test_ptxas_usage_reads_registers_and_spills():
    """``ptxas -v``'s lines in a build log, read per kernel: the numbers
    ``chip_smoke.py`` reports beside K2 and K6."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z16a2a_wgmma_kernelI13__nv_bfloat16EvN1_10A2ATmaArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for _Z16a2a_wgmma_kernelI13__nv_bfloat16EvN1_10A2ATmaArgsE",
        "    128 bytes stack frame, 128 bytes spill stores, 96 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 128 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_Z17a2a_matmul_kernelN1_7A2AArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for _Z17a2a_matmul_kernelN1_7A2AArgsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    assert _build.ptxas_usage(log) == {
        "_Z16a2a_wgmma_kernelI13__nv_bfloat16EvN1_10A2ATmaArgsE":
            {"spill_stores": 128, "registers": 168},
        "_Z17a2a_matmul_kernelN1_7A2AArgsE": {"spill_stores": 0, "registers": 128},
    }
    assert _build.ptxas_usage("") == {}
