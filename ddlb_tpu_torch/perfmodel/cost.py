"""The KV handoff's price: the part of the JAX package's
``perfmodel/cost.py`` (:173-220) the serving cluster reads.

``kv_bundle_bytes`` weighs a handoff bundle with the decode census's
per-row convention (``utils/hbm_budget.decode_budget``'s ``kv_cache``);
``kv_handoff_seconds`` floors the time to move it: read out of the
producer's memory, one link crossing, written into the consumer's,
``bytes * (2 / hbm_bw + 1 / link_bw)`` (on the card the link is NVLink).
This is the JAX function's closed form (its ``calib=None`` case): the
calibration table that can replace it (``perfmodel.calib``) waits for the
port's perfmodel tooling.
"""

from __future__ import annotations

from ddlb_tpu_torch.perfmodel.specs import ChipSpec


def kv_bundle_bytes(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    layers: int,
    kv_cache: str,
    tokens: int,
) -> float:
    """Bytes of K/V cache a ``tokens``-row bundle carries: K and V x
    layers x kv heads x head_dim a row, at the cache dtype's width."""
    head_dim = d_model // max(1, n_heads)
    kvh = n_kv_heads or n_heads
    itemsize = 1.0 if kv_cache == "int8" else 2.0
    return 2.0 * layers * kvh * head_dim * itemsize * float(tokens)


def kv_handoff_seconds(payload_bytes: float, spec: ChipSpec) -> float:
    """Latency floor of moving one KV bundle between two engines:
    ``bytes * (2 / hbm_bw + 1 / link_bw)``; 0 for an empty bundle."""
    if payload_bytes <= 0.0:
        return 0.0
    return float(payload_bytes) * (2.0 / spec.hbm_bw + 1.0 / spec.link_bw)
