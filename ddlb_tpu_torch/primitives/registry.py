"""String -> implementation-class resolution for the runner and the CLI.

Covers the families this port carries so far. The GEMM members follow
the upstream project (samnordmann/ddlb): ``pytorch`` is the
explicit-collective member (the JAX package's ``jax_spmd``), ``cuda`` the
tensor-parallel families' hand-kernel member (the JAX package's
``pallas``). ``quantized`` and the context-parallel attention members keep
their JAX names. A family or member of the JAX package that has no
counterpart here yet raises ``ValueError`` saying so.
"""

from __future__ import annotations

import importlib
from typing import Tuple, Type

ALLOWED_PRIMITIVES = (
    "tp_columnwise", "tp_rowwise", "dp_allreduce", "cp_ring_attention",
    "ep_alltoall", "transformer_decode", "transformer_step",
)

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
        "quantized": (
            "ddlb_tpu_torch.primitives.tp_columnwise.quantized",
            "QuantizedTPColumnwise",
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
        "quantized": (
            "ddlb_tpu_torch.primitives.tp_rowwise.quantized",
            "QuantizedTPRowwise",
        ),
    },
    "dp_allreduce": {
        name: (f"ddlb_tpu_torch.primitives.dp_allreduce.{name}", cls)
        for name, cls in (
            ("compute_only", "ComputeOnlyDPAllReduce"),
            ("pytorch", "PyTorchDPAllReduce"),
            ("quantized", "QuantizedDPAllReduce"),
        )
    },
    "ep_alltoall": {
        name: (f"ddlb_tpu_torch.primitives.ep_alltoall.{name}", cls)
        for name, cls in (
            ("compute_only", "ComputeOnlyEPAllToAll"),
            ("pytorch", "PyTorchEPAllToAll"),
            ("quantized", "QuantizedEPAllToAll"),
        )
    },
    "cp_ring_attention": {
        name: (f"ddlb_tpu_torch.primitives.cp_ring_attention.{name}", cls)
        for name, cls in (
            ("compute_only", "ComputeOnlyCPRingAttention"),
            ("ring", "RingCPRingAttention"),
            ("allgather", "AllGatherCPRingAttention"),
            ("flash", "FlashCPRingAttention"),
            ("ulysses", "UlyssesCPRingAttention"),
            ("ring_flash", "RingFlashCPRingAttention"),
        )
    },
    "transformer_step": {
        "spmd": (
            "ddlb_tpu_torch.primitives.transformer_step.spmd",
            "SPMDTransformerStep",
        ),
        "compute_only": (
            "ddlb_tpu_torch.primitives.transformer_step.compute_only",
            "ComputeOnlyTransformerStep",
        ),
    },
    "transformer_decode": {
        "spmd": (
            "ddlb_tpu_torch.primitives.transformer_decode.spmd",
            "SPMDTransformerDecode",
        ),
        "compute_only": (
            "ddlb_tpu_torch.primitives.transformer_decode.compute_only",
            "ComputeOnlyTransformerDecode",
        ),
    },
}

#: families of the JAX package that the port does not carry yet
_NOT_PORTED_FAMILIES = (
    "pp_pipeline",
    "collectives",
    "serving_load",
)
#: members of the ported families that the port does not carry yet: the
#: GSPMD and overlap members, and the data- and expert-parallel families'
#: topology compositions and ring-kernel ``pallas`` members (K3, K6)
_NOT_PORTED_MEMBERS = ("xla_gspmd", "overlap", "jax_spmd_hier", "jax_spmd_striped")
_NOT_PORTED_PALLAS = ("dp_allreduce", "ep_alltoall")
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
        if name in _NOT_PORTED_MEMBERS or (
            name == "pallas" and primitive in _NOT_PORTED_PALLAS
        ):
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
