"""Token-bucket admission control tuned to the decode HBM census.

The counterpart of the JAX package's ``serve/admission.py``. A serving
deployment past its knee does not degrade gracefully: the queue grows
without bound and every request's TTFT collapses. The controller sheds the
excess at the door instead: a request is admitted while the bucket holds
its generated-token budget and rejected (a counted outcome,
``serve_rejected``) when it does not, so the admitted population keeps
its SLO and the overload shows in the rejection count.

The bucket's sustainable rate comes from the census the decode floor is
priced with (``utils/hbm_budget.decode_budget``): steady-state decode
re-reads the weights and the KV rows every token, so ``n_devices`` cards
sustain at most ``n_devices * hbm_bw / bytes_per_token`` tokens/second
(``decode_token_rate``). Callers scale it by an ``overcommit`` knob or
override it with a measured rate: the controller is a mechanism, the
tuning is policy.
"""

from __future__ import annotations


def decode_token_rate(
    *,
    ctx: int,
    d_model: int,
    d_ff: int,
    vocab: int,
    n_heads: int,
    batch: int,
    n_kv_heads: int,
    layers: int,
    kv_cache: str,
    mlp_kernel: str,
    spec,
    n_devices: int = 1,
) -> float:
    """Census-derived sustainable decode rate, tokens/second: the
    aggregate memory bandwidth over the weight + KV bytes re-read a token
    (``serving_load.hbm_bytes``'s convention; the JAX function's
    ``attn_kernel`` is left out: the decode census does not read it)."""
    from ddlb_tpu_torch.utils.hbm_budget import decode_budget

    census = decode_budget(
        ctx=ctx,
        d_model=d_model,
        d_ff=d_ff,
        vocab=vocab,
        n_heads=n_heads,
        batch=batch,
        n_kv_heads=n_kv_heads,
        layers=layers,
        kv_cache=kv_cache,
        mlp_kernel=mlp_kernel,
        phase="decode",
    )
    per_token = census["weights"] + census["kv_cache"]
    if per_token <= 0.0:
        return float("inf")
    return max(1, int(n_devices)) * spec.hbm_bw / per_token


class TokenBucket:
    """Deterministic token bucket over a caller-supplied clock.

    ``try_take(tokens, now_s)`` refills at ``rate_tps`` up to
    ``burst_tokens``, then debits the whole request (admitted) or nothing
    (rejected): a request is one unit of work, never partly admitted.
    Time comes from the caller (the drain clock), so tests replay exact
    schedules."""

    def __init__(self, rate_tps: float, burst_tokens: float) -> None:
        if rate_tps <= 0.0:
            raise ValueError(f"rate_tps must be > 0, got {rate_tps}")
        if burst_tokens <= 0.0:
            raise ValueError(
                f"burst_tokens must be > 0, got {burst_tokens}"
            )
        self.rate_tps = float(rate_tps)
        self.burst_tokens = float(burst_tokens)
        self._level = float(burst_tokens)  # start full: no cold-start shed
        self._last_s = 0.0
        self.admitted = 0
        self.rejected = 0

    def _refill(self, now_s: float) -> None:
        dt = max(0.0, float(now_s) - self._last_s)
        self._last_s = max(self._last_s, float(now_s))
        self._level = min(
            self.burst_tokens, self._level + dt * self.rate_tps
        )

    def level(self, now_s: float) -> float:
        """The bucket's level refilled to ``now_s`` (a gauge)."""
        self._refill(now_s)
        return self._level

    def try_take(self, tokens: float, now_s: float) -> bool:
        """Admit (debit ``tokens``) or reject (debit nothing)."""
        self._refill(now_s)
        if tokens <= self._level:
            self._level -= tokens
            self.admitted += 1
            return True
        self.rejected += 1
        return False
