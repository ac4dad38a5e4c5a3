"""Primitive families of the port and their registry."""

from __future__ import annotations

from ddlb_tpu_torch.primitives.registry import (  # noqa: F401
    ALLOWED_PRIMITIVES,
    implementation_names,
    load_impl_class,
)
