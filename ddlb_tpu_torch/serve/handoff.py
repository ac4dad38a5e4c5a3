"""The KV-handoff unit: what a prefill engine hands a decode engine.

The counterpart of the JAX package's ``serve/handoff.py``. Disaggregated
serving splits one request's life across two engines: the prefill pool
computes the prompt's KV rows and the first generated token, then the
decode pool continues the greedy chain. The bundle is the seam: the
tokens so far (the original prompt, byte for byte, then everything
generated), the budget left, and the priced size of the KV rows that
would cross the link (``perfmodel.cost.kv_bundle_bytes``).

The consumer re-prefills the bundle's tokens rather than receiving cache
rows, as the JAX package's does: the token stream is identical by the
engine's greedy-chain contract (the bundle prompt is exactly the fold
``preempt()`` performs, so no token is generated twice), and the transfer
is priced, not performed (the ``serve_handoff_bytes`` /
``serve_handoff_ms`` columns).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class KVBundle:
    """One prefill -> decode (or drained shard -> survivor) migration."""

    #: cluster-global request id (stable across pools and handoffs: the
    #: exactly-once ledger keys on it)
    request_id: int
    #: tokens so far: the original prompt + the generated prefix (the
    #: resume prompt; its head is byte-identical to the original)
    tokens: np.ndarray
    #: generated tokens folded into ``tokens``
    generated: int
    #: budget still to generate on the consumer's side (>= 1: a request
    #: whose budget is spent completes in place and never bundles)
    remaining: int
    #: the workload's prefix-population rank (-1 = none): the router's
    #: affinity signal survives the handoff
    prefix_id: int
    #: KV rows the bundle carries (``tokens.size``)
    kv_tokens: int
    #: priced bundle size (``perfmodel.cost.kv_bundle_bytes``)
    payload_bytes: float
    #: the drain-clock second the producer finished
    produced_s: float

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.remaining < 1:
            raise ValueError(
                f"a bundle needs remaining budget >= 1, got {self.remaining}"
            )
