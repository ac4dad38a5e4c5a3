"""Seeded open-loop workload generation for the serving engine.

A copy of the JAX package's ``workload/generator.py`` (numpy only): the
same spec and seed give the same trace, field for field, in both
packages (``tests/test_torch_workload.py``).

An **open-loop** generator: arrival times are drawn from the offered
process independently of how fast the server drains them — the shape
under which queueing delay, saturation knees and SLO attainment are
actually defined (a closed loop self-throttles and can never show the
knee). Three generation axes, every one seeded and deterministic:

- **arrival process** — ``poisson`` (memoryless, the classic open-loop
  baseline) or ``bursty`` (a 2-state Markov-modulated Poisson process:
  fixed-length burst/quiet windows whose rates average to the offered
  ``rate_rps``, so sweeps over the process axis hold load constant and
  vary only its burstiness);
- **length mix** — prompt lengths are lognormal around ``prompt_mean``
  (the long-tail shape real prompt populations show), generated-token
  budgets exponential around ``out_mean``; both clipped to explicit
  bounds so an engine's ``max_len`` can be sized from the spec alone;
- **shared-prefix population** — ``prefix_pop`` distinct prefixes with
  Zipf(``prefix_alpha``) popularity, each ``prefix_len`` tokens drawn
  per-id deterministically. Rank 0 is the hot prefix (the "system
  prompt" case the engine's ``set_shared_prefix`` cache serves);
  ``prefix_id`` on each request says which population member it leads
  with, so a driver can measure hit rates against any caching policy.

Determinism contract: two calls
of ``generate_trace`` with equal specs produce identical traces —
arrival times, prompts, budgets, prefix assignments, all of it. Every
random stream derives from ``numpy.random.SeedSequence`` spawns of the
spec's single ``seed``, so adding a stream later cannot perturb the
existing ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

#: SeedSequence lane ids, one per independent stream (appending a new
#: stream appends a lane — existing traces never move)
_LANE_ARRIVAL = 0
_LANE_PROMPT_LEN = 1
_LANE_OUT_LEN = 2
_LANE_PREFIX_PICK = 3
_LANE_BODY = 4
_LANE_PREFIX_TOKENS = 5


@dataclass(frozen=True)
class TimedRequest:
    """One generated request: when it arrives and what it asks for."""

    index: int
    arrival_s: float            # offset from trace start
    prompt: np.ndarray          # [S0] int32 (prefix tokens included)
    max_new: int
    prefix_id: int              # population rank, -1 = no shared prefix


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a trace. Equal specs (seed included)
    generate equal traces — the spec IS the workload's identity."""

    n_requests: int
    rate_rps: float             # offered load, requests/second
    process: str = "poisson"    # "poisson" | "bursty"
    #: bursty (MMPP-2): in-burst rate multiplier and the fraction of
    #: time spent bursting; the quiet rate is solved so the long-run
    #: mean stays ``rate_rps`` (requires burst_duty * burst_factor < 1)
    burst_factor: float = 4.0
    burst_duty: float = 0.2
    burst_len_s: float = 2.0
    #: prompt-length mix: lognormal(mean=prompt_mean, sigma) clipped
    prompt_mean: int = 64
    prompt_sigma: float = 0.6
    prompt_min: int = 4
    prompt_max: int = 512
    #: output budget: exponential(out_mean) clipped
    out_mean: int = 16
    out_min: int = 1
    out_max: int = 128
    vocab: int = 512
    #: Zipf shared-prefix population (0 disables; prefix_len tokens
    #: prepended to every prompt, id drawn by popularity rank)
    prefix_pop: int = 0
    prefix_alpha: float = 1.1
    prefix_len: int = 0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.rate_rps <= 0.0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.process not in ("poisson", "bursty"):
            raise ValueError(
                f"unknown arrival process {self.process!r} "
                f"(poisson | bursty)"
            )
        if self.process == "bursty":
            if not 0.0 < self.burst_duty < 1.0:
                raise ValueError(
                    f"burst_duty must be in (0, 1), got {self.burst_duty}"
                )
            if self.burst_factor * self.burst_duty >= 1.0:
                raise ValueError(
                    "burst_factor * burst_duty must be < 1 so the quiet "
                    f"rate stays positive (got {self.burst_factor} * "
                    f"{self.burst_duty})"
                )
        if not 1 <= self.prompt_min <= self.prompt_max:
            raise ValueError("need 1 <= prompt_min <= prompt_max")
        if not 1 <= self.out_min <= self.out_max:
            raise ValueError("need 1 <= out_min <= out_max")
        if self.prefix_pop and self.prefix_len < 1:
            raise ValueError("prefix_pop > 0 needs prefix_len >= 1")
        if self.vocab < 2:
            raise ValueError("vocab must be >= 2")

    @property
    def max_total_tokens(self) -> int:
        """Upper bound on prompt + generated per request — what an
        engine's ``max_len`` must cover."""
        return self.prefix_len + self.prompt_max + self.out_max


def _rng(spec: WorkloadSpec, lane: int, extra: Tuple[int, ...] = ()):
    return np.random.default_rng(
        np.random.SeedSequence((spec.seed, lane) + extra)
    )


def prefix_tokens(spec: WorkloadSpec, prefix_id: int) -> np.ndarray:
    """The population member's tokens, generated per-id so a driver can
    materialize any prefix without the whole trace (rank 0 is the hot
    one ``set_shared_prefix`` wants)."""
    if not (0 <= prefix_id < spec.prefix_pop):
        raise ValueError(
            f"prefix_id {prefix_id} outside population [0, {spec.prefix_pop})"
        )
    rng = _rng(spec, _LANE_PREFIX_TOKENS, (prefix_id,))
    return rng.integers(1, spec.vocab, spec.prefix_len).astype(np.int32)


def _arrival_times(spec: WorkloadSpec) -> np.ndarray:
    """Arrival offsets for ``n_requests``, by integrating unit-rate
    exponentials through the (piecewise-constant) rate function — exact
    for both processes, no thinning loss."""
    rng = _rng(spec, _LANE_ARRIVAL)
    work = rng.exponential(1.0, spec.n_requests)  # unit-rate exponentials
    if spec.process == "poisson":
        return np.cumsum(work) / spec.rate_rps
    # bursty: fixed-length burst/quiet windows; the quiet rate solves
    # duty*f + (1-duty)*q = 1 so the long-run mean stays rate_rps
    f = spec.burst_factor
    duty = spec.burst_duty
    q = (1.0 - duty * f) / (1.0 - duty)
    burst_len = spec.burst_len_s
    quiet_len = burst_len * (1.0 - duty) / duty
    out = np.empty(spec.n_requests, np.float64)
    t = 0.0
    in_burst = True
    boundary = burst_len
    for i, w in enumerate(work):
        while True:
            rate = spec.rate_rps * (f if in_burst else q)
            # rate integral available before the next state boundary
            capacity = (boundary - t) * rate
            if w <= capacity:
                t += w / rate
                break
            w -= capacity
            t = boundary
            in_burst = not in_burst
            boundary += burst_len if in_burst else quiet_len
        out[i] = t
    return out


def _lognormal_lengths(
    rng, n: int, mean: float, sigma: float, lo: int, hi: int
) -> np.ndarray:
    mu = math.log(max(mean, 1.0)) - 0.5 * sigma * sigma
    raw = rng.lognormal(mu, sigma, n)
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)


def generate_trace(spec: WorkloadSpec) -> List[TimedRequest]:
    """The full trace, arrival-ordered. Identical per spec (seed
    included); prompts carry their prefix tokens inline so a consumer
    that ignores prefixes still replays the same byte stream."""
    arrivals = _arrival_times(spec)
    prompt_lens = _lognormal_lengths(
        _rng(spec, _LANE_PROMPT_LEN), spec.n_requests,
        spec.prompt_mean, spec.prompt_sigma,
        spec.prompt_min, spec.prompt_max,
    )
    raw_out = _rng(spec, _LANE_OUT_LEN).exponential(
        spec.out_mean, spec.n_requests
    )
    out_lens = np.clip(
        np.rint(raw_out), spec.out_min, spec.out_max
    ).astype(np.int64)
    if spec.prefix_pop:
        ranks = np.arange(1, spec.prefix_pop + 1, dtype=np.float64)
        weights = ranks ** (-spec.prefix_alpha)
        weights /= weights.sum()
        prefix_ids = _rng(spec, _LANE_PREFIX_PICK).choice(
            spec.prefix_pop, size=spec.n_requests, p=weights
        )
        prefixes = [
            prefix_tokens(spec, i) for i in range(spec.prefix_pop)
        ]
    else:
        prefix_ids = np.full(spec.n_requests, -1, np.int64)
    body_rng = _rng(spec, _LANE_BODY)
    trace: List[TimedRequest] = []
    for i in range(spec.n_requests):
        body = body_rng.integers(1, spec.vocab, int(prompt_lens[i])).astype(
            np.int32
        )
        pid = int(prefix_ids[i])
        prompt = (
            np.concatenate([prefixes[pid], body]) if pid >= 0 else body
        )
        trace.append(
            TimedRequest(
                index=i,
                arrival_s=float(arrivals[i]),
                prompt=prompt,
                max_new=int(out_lens[i]),
                prefix_id=pid,
            )
        )
    return trace
