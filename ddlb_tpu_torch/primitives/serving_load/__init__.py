"""serving_load: the serving engine and the serving cluster measured
under open-loop traffic.

Lazy re-exports: importing the family loads none of its members."""

from __future__ import annotations

_LAZY = {
    "ServingLoad": ("ddlb_tpu_torch.primitives.serving_load.base", "ServingLoad"),
    "EngineServingLoad": (
        "ddlb_tpu_torch.primitives.serving_load.engine",
        "EngineServingLoad",
    ),
    "StaticServingLoad": (
        "ddlb_tpu_torch.primitives.serving_load.static",
        "StaticServingLoad",
    ),
    "ClusterServingLoad": (
        "ddlb_tpu_torch.primitives.serving_load.cluster_base",
        "ClusterServingLoad",
    ),
    "RouterServingLoad": (
        "ddlb_tpu_torch.primitives.serving_load.router",
        "RouterServingLoad",
    ),
    "DisaggServingLoad": (
        "ddlb_tpu_torch.primitives.serving_load.disagg",
        "DisaggServingLoad",
    ),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        return getattr(importlib.import_module(module_name), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
