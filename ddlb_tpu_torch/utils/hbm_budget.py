"""Device-memory census of the serving family's configurations.

The part of ``decode_budget`` from the JAX package's
``utils/hbm_budget.py`` (:105) that ``hbm_bytes()`` reads for its traffic
floor (weights + KV cache per pass): the same two components, in bytes,
of one ``transformer_decode`` configuration.

- ``weights``: embedding + untied LM head ``2 V D`` bf16, per layer the
  q/o projections ``2 D^2`` and k/v ``2 D^2 kv_frac`` bf16 and the routed
  MLP ``2 D F``;
- ``kv_cache``: ``layers * 2 * B * S_cache * h_kv * dh`` at 2 bytes
  (bf16) or 1 byte plus float32 per-(position, head) scales (int8), the
  horizon ``S_cache`` per phase as the spmd member allocates it.
"""

from __future__ import annotations

from typing import Dict


def decode_budget(
    *,
    ctx: int,
    d_model: int,
    d_ff: int,
    vocab: int,
    n_heads: int,
    batch: int,
    n_kv_heads: int = 0,
    layers: int = 1,
    kv_cache: str = "bf16",
    mlp_kernel: str = "bf16",
    phase: str = "decode",
    n_new: int = 32,
) -> Dict[str, float]:
    """``{"weights": bytes, "kv_cache": bytes}`` of one
    ``transformer_decode`` configuration on one card (tp = 1 weights)."""
    D, F, V, B, L = d_model, d_ff, vocab, batch, layers
    h_kv = n_kv_heads or n_heads
    kv_frac = h_kv / n_heads
    dh = D // n_heads

    w_bytes = 1 if mlp_kernel == "int8_weights" else 2
    embed_head = 2.0 * V * D * 2
    per_layer = (2.0 + 2.0 * kv_frac) * D * D * 2 + 2.0 * D * F * w_bytes
    weights = embed_head + L * per_layer

    horizons = {"decode": ctx + 1, "prefill": ctx, "generate": ctx + n_new,
                "serve": ctx + n_new}
    if phase not in horizons:
        raise ValueError(f"unknown phase {phase!r}")
    s_cache = horizons[phase]
    cache = L * 2.0 * B * s_cache * h_kv * dh * (1 if kv_cache == "int8" else 2)
    if kv_cache == "int8":
        cache += L * 2.0 * B * s_cache * h_kv * 4
    return {"weights": weights, "kv_cache": cache}
