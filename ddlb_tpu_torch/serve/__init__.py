"""The serving cluster in front of ``ContinuousBatchingEngine``: the
port of the JAX package's ``serve/``.

Three mechanisms behind one facade (``ServingCluster``):

- **disaggregated prefill/decode** (``cluster.py`` + ``handoff.py``):
  separate engine pools; prefill produces a ``KVBundle`` (prompt + the
  first generated token), decode admits it: the KV handoff, priced by
  ``perfmodel.cost.kv_handoff_seconds`` and counted in the
  ``serve_handoff*`` columns;
- a **prefix-affinity router** (``router.py``) for dp > 1: one engine
  per dp shard, shared-prefix affinity first, the least outstanding work
  otherwise;
- a **token-bucket admission controller** (``admission.py``) tuned
  against the decode HBM census: load past capacity is shed at the door
  as a counted ``rejected`` outcome.

The cluster is elastic and heals itself: with ``elastic=True`` the
prefill and decode pools resize mid-run toward the bottleneck (drain to
the survivors, flip the role, prewarm again; no request lost, journaled
in ``serve_pool_history``); an indicted shard earns re-admission through
a probation window (``observatory.health.exoneration_verdict``); and the
router's load comparisons are weighted by cost, so a degraded but live
shard draws proportionally less load.

Not ported: the JAX package's fault-injection and telemetry sites (the
port has no ``faults/`` or ``telemetry/``).

Lazy re-exports: importing the package loads none of its modules.
"""

from __future__ import annotations

_LAZY = {
    "KVBundle": ("ddlb_tpu_torch.serve.handoff", "KVBundle"),
    "TokenBucket": ("ddlb_tpu_torch.serve.admission", "TokenBucket"),
    "decode_token_rate": ("ddlb_tpu_torch.serve.admission", "decode_token_rate"),
    "PrefixAffinityRouter": ("ddlb_tpu_torch.serve.router", "PrefixAffinityRouter"),
    "ServingCluster": ("ddlb_tpu_torch.serve.cluster", "ServingCluster"),
    "ClusterCompletion": ("ddlb_tpu_torch.serve.cluster", "ClusterCompletion"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        return getattr(importlib.import_module(module_name), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
