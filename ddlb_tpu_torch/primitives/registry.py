"""String -> implementation-class resolution for the runner and the CLI.

Covers the families this port carries so far. The members follow the
upstream project (samnordmann/ddlb): ``pytorch`` is the
explicit-collective member (the JAX package's ``jax_spmd``), ``cuda`` the
hand-kernel member (the JAX package's ``pallas``), ``compiled`` the
compiler-partitioned member (the JAX package's ``xla_gspmd``: DTensor
placements under ``torch.compile``), and ``pytorch_hier`` /
``pytorch_striped`` the topology compositions (its ``jax_spmd_hier`` /
``jax_spmd_striped``). ``overlap``,
``quantized`` and the context-parallel attention members keep their JAX
names. A JAX package name of a member raises ``ValueError`` naming the
port's counterpart; an unknown family or member raises ``ValueError``
listing what there is.
"""

from __future__ import annotations

import importlib
from typing import Tuple, Type

ALLOWED_PRIMITIVES = (
    "tp_columnwise", "tp_rowwise", "dp_allreduce", "cp_ring_attention",
    "ep_alltoall", "transformer_decode", "transformer_step", "collectives",
    "pp_pipeline", "serving_load",
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
        "overlap": (
            "ddlb_tpu_torch.primitives.tp_columnwise.overlap",
            "OverlapTPColumnwise",
        ),
        "quantized": (
            "ddlb_tpu_torch.primitives.tp_columnwise.quantized",
            "QuantizedTPColumnwise",
        ),
        "compiled": (
            "ddlb_tpu_torch.primitives.tp_columnwise.compiled",
            "CompiledTPColumnwise",
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
        "overlap": (
            "ddlb_tpu_torch.primitives.tp_rowwise.overlap",
            "OverlapTPRowwise",
        ),
        "quantized": (
            "ddlb_tpu_torch.primitives.tp_rowwise.quantized",
            "QuantizedTPRowwise",
        ),
        "compiled": (
            "ddlb_tpu_torch.primitives.tp_rowwise.compiled",
            "CompiledTPRowwise",
        ),
    },
    "dp_allreduce": {
        name: (f"ddlb_tpu_torch.primitives.dp_allreduce.{module}", cls)
        for name, module, cls in (
            ("compute_only", "compute_only", "ComputeOnlyDPAllReduce"),
            ("pytorch", "pytorch", "PyTorchDPAllReduce"),
            ("quantized", "quantized", "QuantizedDPAllReduce"),
            ("cuda", "cuda_impl", "CudaDPAllReduce"),
            ("overlap", "overlap", "OverlapDPAllReduce"),
            ("compiled", "compiled", "CompiledDPAllReduce"),
            ("pytorch_hier", "pytorch_hier", "PyTorchHierDPAllReduce"),
            ("pytorch_striped", "pytorch_striped", "PyTorchStripedDPAllReduce"),
        )
    },
    "ep_alltoall": {
        name: (f"ddlb_tpu_torch.primitives.ep_alltoall.{module}", cls)
        for name, module, cls in (
            ("compute_only", "compute_only", "ComputeOnlyEPAllToAll"),
            ("pytorch", "pytorch", "PyTorchEPAllToAll"),
            ("quantized", "quantized", "QuantizedEPAllToAll"),
            ("cuda", "cuda_impl", "CudaEPAllToAll"),
            ("overlap", "overlap", "OverlapEPAllToAll"),
            ("compiled", "compiled", "CompiledEPAllToAll"),
            ("pytorch_hier", "pytorch_hier", "PyTorchHierEPAllToAll"),
            ("pytorch_striped", "pytorch_striped", "PyTorchStripedEPAllToAll"),
        )
    },
    "collectives": {
        name: (f"ddlb_tpu_torch.primitives.collectives.{module}", cls)
        for name, module, cls in (
            ("compute_only", "compute_only", "ComputeOnlyCollectives"),
            ("pytorch", "pytorch", "PyTorchCollectives"),
            ("cuda", "cuda_impl", "CudaCollectives"),
            ("compiled", "compiled", "CompiledCollectives"),
            ("pytorch_hier", "pytorch_hier", "PyTorchHierCollectives"),
            ("pytorch_striped", "pytorch_striped", "PyTorchStripedCollectives"),
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
    "pp_pipeline": {
        name: (f"ddlb_tpu_torch.primitives.pp_pipeline.{name}", cls)
        for name, cls in (
            ("compute_only", "ComputeOnlyPPPipeline"),
            ("pytorch", "PyTorchPPPipeline"),
            ("schedules", "SchedulePPPipeline"),
            ("compiled", "CompiledPPPipeline"),
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
        "compiled": (
            "ddlb_tpu_torch.primitives.transformer_step.compiled",
            "CompiledTransformerStep",
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
        "compiled": (
            "ddlb_tpu_torch.primitives.transformer_decode.compiled",
            "CompiledTransformerDecode",
        ),
    },
    "serving_load": {
        name: (f"ddlb_tpu_torch.primitives.serving_load.{name}", cls)
        for name, cls in (
            ("engine", "EngineServingLoad"),
            ("static", "StaticServingLoad"),
            ("router", "RouterServingLoad"),
            ("disagg", "DisaggServingLoad"),
        )
    },
}

#: JAX package member name -> this package's name for the same member
_RENAMED = {
    "jax_spmd": "pytorch", "pallas": "cuda", "xla_gspmd": "compiled",
    "jax_spmd_hier": "pytorch_hier", "jax_spmd_striped": "pytorch_striped",
}
#: unit of the runner's Throughput column, by family: the collectives
#: family's ``flops()`` is 1000 * wire bytes, so its column is GB/s
_THROUGHPUT_UNITS = {"collectives": "GB/s"}


def throughput_unit(primitive: str) -> str:
    """Unit of the Throughput column for this family (a copy of the JAX
    package's ``registry.throughput_unit``): keyed on the name alone, so
    the runner's error rows stamp it without loading the member."""
    check_primitive(primitive)
    return _THROUGHPUT_UNITS.get(primitive, "TFLOPS")


def port_member_name(name: str) -> str:
    """The port's name for a member named in a JAX package config
    (``registry._RENAMED``: ``jax_spmd`` -> ``pytorch``, ``pallas`` ->
    ``cuda``, ``xla_gspmd`` -> ``compiled``, ``jax_spmd_hier`` ->
    ``pytorch_hier``, ``jax_spmd_striped`` -> ``pytorch_striped``); other
    names as they are."""
    return _RENAMED.get(name, name)


def implementation_names(primitive: str) -> Tuple[str, ...]:
    check_primitive(primitive)
    return tuple(_REGISTRY[primitive])


def load_impl_class(primitive: str, name: str) -> Type:
    """Resolve ``(primitive, implementation-name)`` to its class."""
    check_primitive(primitive)
    table = _REGISTRY[primitive]
    if name not in table:
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
    if primitive not in ALLOWED_PRIMITIVES:
        raise ValueError(
            f"Unknown primitive '{primitive}'. Allowed: {ALLOWED_PRIMITIVES}"
        )
