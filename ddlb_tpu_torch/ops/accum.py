"""The plain members' library products.

``torch_matmul`` is the product in the operand dtype (``torch.matmul``).
``accum_matmul`` and ``float32_product`` keep a wider accumulator from
operands in their own dtype, the counterpart of JAX's ``jnp.matmul(a, b, preferred_element_type=f32)``:
bf16/fp16 operands multiplied with float32 sums and a float32 result. On
the card that is one tensor-core GEMM (``torch.mm(a, b,
out_dtype=torch.float32)``, ``aten::mm.dtype``). The CPU has no
``mm.dtype``; there the operands are upcast and multiplied in float32,
which is the same function (a bf16 or fp16 product is exact in float32),
summed in another order.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def torch_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library product of the plain members (``torch.matmul``).

    CUDA has no integer GEMM, so integer operands are multiplied in
    float64 and cast back. That is exact here: the seeded integers lie in
    [-3, 3] (``Primitive._host_operands``), so every partial sum is below
    9k, far inside float64's 2**53.
    """
    if a.is_floating_point():
        return a @ b
    return (a.double() @ b.double()).to(a.dtype)


def accum_matmul(a: torch.Tensor, b: torch.Tensor,
                 acc_t: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b`` (2-D) with the sums and the result in ``acc_t``. Integer
    operands multiply in float64, exact for the seeded operands (whose
    partial sums stay far below 2**53), and come back as ``acc_t``."""
    if not a.is_floating_point():
        return (a.double() @ b.double()).to(acc_t)
    if a.device.type == "cuda" and a.dtype in _HALF and acc_t == torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(acc_t) @ b.to(acc_t)


class _Float32Product(torch.autograd.Function):
    """``mm.dtype`` with the gradients of the float32 product of the upcast
    operands (``mm.dtype`` has no derivative of its own): each gradient is
    a float32 product, rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def float32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` with a float32 result, differentiable: the
    LM head of the training step, the oracle and the serving model. On the
    card bf16/fp16 operands go through the tensor cores; otherwise (the
    CPU, float32 operands) the float32 product of the upcast operands."""
    if x.device.type == "cuda" and x.dtype in _HALF and w.dtype == x.dtype:
        flat = _Float32Product.apply(x.reshape(-1, x.shape[-1]), w)
        return flat.reshape(*x.shape[:-1], w.shape[1])
    return torch.matmul(x.float(), w.float())
