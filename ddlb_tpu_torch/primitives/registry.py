"""String -> implementation-class resolution for the runner and the CLI.

Covers the two families this port carries so far. Member names follow the
upstream project (samnordmann/ddlb): ``pytorch`` is the explicit-collective
member (the JAX package's ``jax_spmd``), ``cuda`` the hand-kernel member
(the JAX package's ``pallas``). A family or member of the JAX package that
has no counterpart here yet raises ``ValueError`` saying so.
"""

from __future__ import annotations

import importlib
from typing import Tuple, Type

ALLOWED_PRIMITIVES = ("tp_columnwise", "tp_rowwise")

_REGISTRY = {
    "tp_columnwise": {
        "compute_only": (
            "ddlb_tpu_torch.primitives.tp_columnwise.compute_only",
            "ComputeOnlyTPColumnwise",
        ),
        "pytorch": (
            "ddlb_tpu_torch.primitives.tp_columnwise.pytorch",
            "PyTorchTPColumnwise",
        ),
        "cuda": (
            "ddlb_tpu_torch.primitives.tp_columnwise.cuda_impl",
            "CudaTPColumnwise",
        ),
    },
    "tp_rowwise": {
        "compute_only": (
            "ddlb_tpu_torch.primitives.tp_rowwise.compute_only",
            "ComputeOnlyTPRowwise",
        ),
        "pytorch": (
            "ddlb_tpu_torch.primitives.tp_rowwise.pytorch",
            "PyTorchTPRowwise",
        ),
        "cuda": (
            "ddlb_tpu_torch.primitives.tp_rowwise.cuda_impl",
            "CudaTPRowwise",
        ),
    },
}

#: families of the JAX package that the port does not carry yet
_NOT_PORTED_FAMILIES = (
    "dp_allreduce",
    "cp_ring_attention",
    "ep_alltoall",
    "pp_pipeline",
    "transformer_step",
    "transformer_decode",
    "collectives",
    "serving_load",
)
#: members of the ported families that the port does not carry yet
_NOT_PORTED_MEMBERS = ("xla_gspmd", "overlap", "quantized")
#: JAX package member name -> this package's name for the same member
_RENAMED = {"jax_spmd": "pytorch", "pallas": "cuda"}


def implementation_names(primitive: str) -> Tuple[str, ...]:
    check_primitive(primitive)
    return tuple(_REGISTRY[primitive])


def load_impl_class(primitive: str, name: str) -> Type:
    """Resolve ``(primitive, implementation-name)`` to its class."""
    check_primitive(primitive)
    table = _REGISTRY[primitive]
    if name not in table:
        if name in _NOT_PORTED_MEMBERS:
            raise ValueError(
                f"Implementation '{name}' of {primitive} is not yet ported "
                f"to ddlb_tpu_torch. Available: {sorted(table)}"
            )
        if name in _RENAMED:
            raise ValueError(
                f"'{name}' is the JAX package's name; the port's "
                f"counterpart is '{_RENAMED[name]}'"
            )
        raise ValueError(
            f"Unknown implementation '{name}' for {primitive}. "
            f"Available: {sorted(table)}"
        )
    module_name, class_name = table[name]
    return getattr(importlib.import_module(module_name), class_name)


def check_primitive(primitive: str) -> None:
    if primitive in _NOT_PORTED_FAMILIES:
        raise ValueError(
            f"Primitive '{primitive}' is not yet ported to ddlb_tpu_torch. "
            f"Ported: {ALLOWED_PRIMITIVES}"
        )
    if primitive not in ALLOWED_PRIMITIVES:
        raise ValueError(
            f"Unknown primitive '{primitive}'. Allowed: {ALLOWED_PRIMITIVES}"
        )
