"""Helpers shared by the ``test_torch_*`` files: move results between the
JAX package and its PyTorch port as numpy arrays, and the tolerances the
parity tests state."""

import numpy as np
import torch

#: bfloat16 keeps 8 significant bits (7 stored)
BF16_MANTISSA_BITS = 7


def to_numpy(x) -> np.ndarray:
    """A torch tensor or a JAX array as a float64 host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def bits(x) -> np.ndarray:
    """The raw bit patterns of a bf16/f32 torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        width = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return x.detach().cpu().contiguous().view(width[x.dtype]).numpy()
    host = np.asarray(x)
    return host.view(np.int16 if host.dtype.itemsize == 2 else np.int32)


def bf16_ulp(magnitude: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 values at ``magnitude`` (elementwise)."""
    m = np.maximum(np.abs(magnitude), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(m)) - BF16_MANTISSA_BITS)


def assert_within_bf16_ulps(got, want, ulps: float = 1.0, scale=None):
    """|got - want| <= ulps * bf16 spacing at ``scale`` (default: the
    larger of |got| and |want|), elementwise."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scale is None:
        scale = np.maximum(np.abs(got), np.abs(want))
    bound = ulps * bf16_ulp(scale)
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert np.all(err <= bound), (
        f"{int(np.sum(err > bound))} elements beyond {ulps} bf16 ulp; "
        f"worst at {worst}: {got[worst]} vs {want[worst]}"
    )
