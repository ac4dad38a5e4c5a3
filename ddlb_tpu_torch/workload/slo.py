"""Streaming SLO statistics for load-driven serving runs.

A copy of the JAX package's ``workload/slo.py`` (stdlib only): the same
event stream folds into the same ``slo_*`` columns in both packages
(``tests/test_torch_workload.py``).

Two pieces, both O(1) per observation so the drain loop they instrument
stays unperturbed:

- ``StreamingQuantile``: a sparse log-bucketed histogram (the
  HDR-histogram idea) with bounded RELATIVE error — bucket boundaries
  grow geometrically by ``1 + 2*rel_err``, a sample lands in one
  integer bucket via a log, and any reported quantile is the geometric
  midpoint of the bucket holding that rank, hence within ``rel_err`` of
  the true order statistic (within 1% of exact ``numpy.quantile`` on a
  10k-sample reference at the default ``rel_err``). Memory is one
  dict entry per occupied bucket (~a few hundred over µs→minutes).
- ``SLOTracker``: the per-request timeline ledger
  (arrival → admit/first-token → completion; the engine's admission
  computes the first token, so TTFT ends at admit) plus queue-depth
  gauges, folded into the ``slo_*`` row columns: TTFT/TPOT/E2E
  percentiles, goodput under the configured SLO bound (completed
  requests meeting BOTH bounds per second of drain), attainment, and
  preemption/eviction counters forwarded from the engine.

Definitions:

- **TTFT**: arrival → first generated token, queueing wait included —
  the user-visible "time to first token", not the prefill's device
  time.
- **TPOT**: (completion − first token) / (generated − 1) per request —
  steady-state per-token latency; requests generating one token have
  no TPOT sample.
- **goodput**: completed requests whose TTFT ≤ ``ttft_slo_ms`` AND
  TPOT ≤ ``tpot_slo_ms`` (one-token requests: TTFT alone), divided by
  the drain's makespan — the rate the service DELIVERS within its SLO,
  which load sweeps report instead of raw throughput.
- **attainment**: the same SLO predicate as a fraction of completed
  requests.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

#: default relative error of the streaming quantile buckets (0.4% —
#: comfortably inside the 1%-of-exact test contract)
DEFAULT_REL_ERR = 0.004


class StreamingQuantile:
    """Sparse log-bucketed streaming quantile estimator."""

    def __init__(
        self, rel_err: float = DEFAULT_REL_ERR, min_value: float = 1e-6
    ) -> None:
        if not 0.0 < rel_err < 0.5:
            raise ValueError(f"rel_err must be in (0, 0.5), got {rel_err}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        self._growth = 1.0 + 2.0 * rel_err
        self._log_growth = math.log(self._growth)
        self._min_value = min_value
        self._counts: Dict[int, int] = {}
        self._n = 0
        self._lo = math.inf
        self._hi = -math.inf

    def __len__(self) -> int:
        return self._n

    def add(self, value: float) -> None:
        """Count one sample (values below ``min_value`` — including any
        non-positive measurement artifact — clamp into bucket 0)."""
        value = float(value)
        if not math.isfinite(value):
            return
        self._n += 1
        self._lo = min(self._lo, value)
        self._hi = max(self._hi, value)
        if value <= self._min_value:
            bucket = 0
        else:
            bucket = int(
                math.log(value / self._min_value) / self._log_growth
            ) + 1
        self._counts[bucket] = self._counts.get(bucket, 0) + 1

    def quantile(self, q: float) -> float:
        """The ``q``-quantile (nearest-rank over buckets, geometric
        bucket midpoint, clamped to the exact observed min/max). NaN on
        an empty estimator."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self._n == 0:
            return float("nan")
        rank = q * (self._n - 1)
        cum = 0
        for bucket in sorted(self._counts):
            cum += self._counts[bucket]
            if cum > rank:
                if bucket == 0:
                    mid = self._min_value
                else:
                    lo = self._min_value * self._growth ** (bucket - 1)
                    mid = lo * math.sqrt(self._growth)
                return float(min(max(mid, self._lo), self._hi))
        return float(self._hi)


class _Timeline:
    """One request's timestamps (all offsets from the drain's t0)."""

    __slots__ = ("arrival_s", "first_token_s", "done_s", "new_tokens")

    def __init__(self, arrival_s: float) -> None:
        self.arrival_s = arrival_s
        self.first_token_s: Optional[float] = None
        self.done_s: Optional[float] = None
        self.new_tokens = 0


class SLOTracker:
    """Per-request timeline ledger + the ``slo_*`` row-column fold."""

    def __init__(
        self,
        ttft_slo_ms: float,
        tpot_slo_ms: float,
        rel_err: float = DEFAULT_REL_ERR,
    ) -> None:
        self.ttft_slo_ms = float(ttft_slo_ms)
        self.tpot_slo_ms = float(tpot_slo_ms)
        self._timelines: Dict[int, _Timeline] = {}
        self._ttft = StreamingQuantile(rel_err)
        self._tpot = StreamingQuantile(rel_err)
        self._e2e = StreamingQuantile(rel_err)
        self._slo_met = 0
        self._completed = 0
        self._queue_sum = 0.0
        self._queue_samples = 0
        self.queue_peak = 0
        #: recent queue-depth gauge ring (the dashboard sparkline feed)
        self.queue_recent: List[int] = []

    def new_drain(self) -> None:
        """Start another drain of the same trace: per-request timelines
        and the sparkline ring reset, while the percentile estimators,
        SLO counters and queue aggregates keep accumulating — a row's
        distributions POOL across its drains (one drain's p95 over a
        small trace is max-dominated noise; pooled order statistics are
        what make the SLO gate's baselines stable)."""
        self._timelines.clear()
        self.queue_recent = []

    # -- timeline events ----------------------------------------------------

    def arrived(self, index: int, arrival_s: float) -> None:
        self._timelines[index] = _Timeline(arrival_s)

    def first_token(self, index: int, t_s: float) -> None:
        """The request produced its first generated token (admission's
        prefill does this synchronously). Idempotent across preemptions:
        only the FIRST call counts — a preempted request's re-admission
        is a scheduling event, not a new first token."""
        tl = self._timelines[index]
        if tl.first_token_s is None:
            tl.first_token_s = t_s

    def finished(self, index: int, t_s: float, new_tokens: int) -> None:
        tl = self._timelines[index]
        tl.done_s = t_s
        tl.new_tokens = int(new_tokens)
        self._completed += 1
        ttft_ms = (tl.first_token_s - tl.arrival_s) * 1e3
        e2e_ms = (t_s - tl.arrival_s) * 1e3
        self._ttft.add(ttft_ms)
        self._e2e.add(e2e_ms)
        tpot_ms = None
        if tl.new_tokens > 1:
            tpot_ms = (t_s - tl.first_token_s) * 1e3 / (tl.new_tokens - 1)
            self._tpot.add(tpot_ms)
        met = ttft_ms <= self.ttft_slo_ms and (
            tpot_ms is None or tpot_ms <= self.tpot_slo_ms
        )
        if met:
            self._slo_met += 1

    def observe_queue(self, depth: int, recent_cap: int = 120) -> None:
        depth = int(depth)
        self._queue_sum += depth
        self._queue_samples += 1
        self.queue_peak = max(self.queue_peak, depth)
        self.queue_recent.append(depth)
        del self.queue_recent[:-recent_cap]

    # -- the fold -----------------------------------------------------------

    @property
    def completed(self) -> int:
        return self._completed

    def row_fields(
        self, makespan_s: float, offered_rps: float
    ) -> Dict[str, Any]:
        """The ``slo_*`` columns for one drained run (NaN marks 'no
        sample', the convention of every other measured column)."""
        nan = float("nan")
        queue_mean = (
            self._queue_sum / self._queue_samples
            if self._queue_samples
            else nan
        )
        goodput = (
            self._slo_met / makespan_s if makespan_s > 0.0 else nan
        )
        attainment = (
            self._slo_met / self._completed if self._completed else nan
        )
        return {
            "slo_offered_rps": round(float(offered_rps), 4),
            "slo_completed": self._completed,
            "slo_ttft_p50_ms": self._ttft.quantile(0.50),
            "slo_ttft_p95_ms": self._ttft.quantile(0.95),
            "slo_ttft_p99_ms": self._ttft.quantile(0.99),
            "slo_tpot_p50_ms": self._tpot.quantile(0.50),
            "slo_tpot_p95_ms": self._tpot.quantile(0.95),
            "slo_tpot_p99_ms": self._tpot.quantile(0.99),
            "slo_e2e_p95_ms": self._e2e.quantile(0.95),
            "slo_goodput_rps": (
                round(goodput, 4) if goodput == goodput else goodput
            ),
            "slo_attainment": (
                round(attainment, 4) if attainment == attainment else attainment
            ),
            "serve_queue_peak": self.queue_peak,
            "serve_queue_mean": (
                round(queue_mean, 3) if queue_mean == queue_mean else queue_mean
            ),
        }
