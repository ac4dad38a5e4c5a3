"""Cross-rank clock alignment from collective rendezvous spans.

The port of the JAX package's ``telemetry/clocksync.py``. Every rank
stamps with its OWN clock. On one host CLOCK_MONOTONIC is system-wide,
but a multi-host world has one monotonic clock per machine with an
arbitrary offset and a slow relative drift, so "rank 3 entered the
collective 120 ms after rank 0" is not computable from raw stamps. This
module makes it computable from the collectives a run executes, which are
two-sided exchange points.

**Midpoint estimator.** A barrier (or any all-arrive-then-all-release
collective) has one world release instant ``T``: no rank exits before
the last rank enters. Rank ``r`` observes the span ``[B_r, E_r]`` on
its own clock, and ``T`` mapped onto that clock lies inside it. The
midpoint ``m_r = (B_r + E_r) / 2`` therefore estimates ``T`` on ``r``'s
clock with error at most the half-width ``u_r = (E_r - B_r) / 2``, and
the per-exchange offset of rank ``r`` against the reference rank is
``d = m_r - m_ref`` with a HARD error bound ``u_r + u_ref``. Across
repeated exchanges the offset is the median of the ``d`` samples (robust
to one skewed exchange), with a linear drift term fitted when the run is
long enough to resolve one. The reported ``uncertainty_s`` is
``max(u_r + u_ref) + max |residual|``.

**Row skew fold.** ``record_span`` keeps a cheap in-process log of the
collective spans the runtime executes (``Runtime.barrier``'s entries and
exits, ``Runtime.max_over_ranks``' result reduce). At the end of a
multi-process row the benchmark worker calls ``fold_row_skew``, which
shares every rank's stamps by a float64 all-gather, fits offsets, and
folds the aligned per-collective entry/exit stamps into the row's skew
columns (``SKEW_ROW_DEFAULTS``): how long collectives waited on their
last arrival (``skew_enter_s``), the exit spread (``skew_exit_s``),
WHICH rank was the dominant last arrival (``straggler_rank``), and the
waited-on-arrival share of total collective time (``straggler_frac``),
with the clock-alignment uncertainty bound alongside (``clock_unc_s``).

The constants, ``record_span`` / ``reset_row`` / ``row_spans``,
``OffsetFit``, ``fit_offsets`` and ``skew_from_spans`` are the JAX
package's, line for line. Monotonic clocks only: stamps are compared
across processes.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ddlb_tpu_torch.telemetry import logger, trace

#: sites whose spans are safe OFFSET-FIT exchange points: strictly
#: all-arrive-then-all-release semantics. ``runtime.collective`` (the
#: result allgather) is deliberately excluded from fitting — it is the
#: preferred slowdown-injection site, and a skewed exchange point used
#: for fitting would bias the very offsets that attribute it (the
#: median absorbs one, but a per-row fold may only see one).
FIT_SITES = ("runtime.barrier", "runtime.init")

#: spans kept per row before the oldest are dropped (a runaway loop
#: must not grow process memory; a row folding >8k collectives has
#: bigger problems than a truncated skew column)
MAX_ROW_SPANS = 8192

#: exchanges below which the fold declines to fit offsets at all: the
#: median's robustness argument needs several exchanges — with one or
#: two, a single skewed barrier IS the fit, absorbing half of any
#: genuine skew into the clock model and potentially naming the
#: innocent peer as the straggler. Below the floor the fold keeps raw
#: stamps (exact on one host) and clock_unc_s honestly goes NaN.
MIN_FIT_EXCHANGES = 3


def fit_exchange_count(sites) -> int:
    """How many of a row's recorded spans are safe offset-fit
    exchanges — the ONE predicate deciding both whether the fold fits
    offsets and whether the gather may rebase stamps per rank (the two
    must agree: a per-rank rebase is only sound when the fit absorbs
    it)."""
    return sum(1 for site in sites if site in FIT_SITES)

#: the cross-rank skew columns every result row carries (defaults on
#: single-process rows and on rows whose worker died before the fold).
#: ``straggler_rank`` is -1 (no straggler identified), matching the
#: world_size=-1 convention of dead rows.
SKEW_ROW_DEFAULTS: Dict[str, Any] = {
    "skew_enter_s": float("nan"),
    "skew_exit_s": float("nan"),
    "straggler_rank": -1,
    "straggler_frac": float("nan"),
    "clock_unc_s": float("nan"),
}

_lock = threading.Lock()
_row_spans: List[Tuple[str, float, float]] = []


def record_span(site: str, t_enter: float, t_exit: float) -> None:
    """Append one collective span (monotonic enter/exit stamps) to the
    process's row log. Cheap enough to be always-on: one tuple append
    under a lock, bounded by ``MAX_ROW_SPANS``."""
    with _lock:
        if len(_row_spans) >= MAX_ROW_SPANS:
            del _row_spans[0]
        _row_spans.append((site, float(t_enter), float(t_exit)))


def reset_row() -> None:
    """Drop the accumulated spans — the worker calls this at row start
    so the fold sees exactly this row's collectives."""
    with _lock:
        _row_spans.clear()


def row_spans() -> List[Tuple[str, float, float]]:
    """Snapshot of the spans recorded since the last ``reset_row``."""
    with _lock:
        return list(_row_spans)


class OffsetFit:
    """One rank's fitted clock offset against the reference rank.

    ``align(t)`` maps the rank's local monotonic stamp ``t`` onto the
    reference rank's clock: ``t - (offset_s + drift_per_s * (t - t0))``.
    ``uncertainty_s`` is the conservative bound described in the module
    docstring; every aligned event should carry it.
    """

    __slots__ = (
        "rank", "ref_rank", "offset_s", "drift_per_s", "t0",
        "uncertainty_s", "n_exchanges",
    )

    def __init__(
        self,
        rank: int,
        ref_rank: int,
        offset_s: float = 0.0,
        drift_per_s: float = 0.0,
        t0: float = 0.0,
        uncertainty_s: float = 0.0,
        n_exchanges: int = 0,
    ) -> None:
        self.rank = rank
        self.ref_rank = ref_rank
        self.offset_s = offset_s
        self.drift_per_s = drift_per_s
        self.t0 = t0
        self.uncertainty_s = uncertainty_s
        self.n_exchanges = n_exchanges

    def offset_at(self, t: float) -> float:
        return self.offset_s + self.drift_per_s * (t - self.t0)

    def align(self, t: float) -> float:
        return t - self.offset_at(t)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rank": self.rank,
            "ref_rank": self.ref_rank,
            "offset_s": self.offset_s,
            "drift_per_s": self.drift_per_s,
            "uncertainty_s": self.uncertainty_s,
            "n_exchanges": self.n_exchanges,
        }


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return (ordered[mid - 1] + ordered[mid]) / 2.0


#: drift is only resolvable when the exchanges span real time; below
#: these floors the slope would fit scheduler jitter, not clock drift
DRIFT_MIN_EXCHANGES = 8
DRIFT_MIN_RANGE_S = 0.5


def fit_offsets(
    spans_by_rank: Dict[int, Sequence[Tuple[float, float]]],
    ref_rank: Optional[int] = None,
) -> Dict[int, OffsetFit]:
    """Fit per-rank clock offsets from index-joined exchange spans.

    ``spans_by_rank[r][j]`` is rank ``r``'s local ``(enter, exit)`` for
    the j-th shared exchange (the caller joins by flight-recorder
    sequence number, or by position for an SPMD row — same collective,
    same index). Returns an ``OffsetFit`` per rank, the reference rank
    (default: lowest) mapping to the identity with zero uncertainty.
    Ranks with no usable exchanges get an identity fit with infinite
    uncertainty — aligned stamps then honestly claim no precision.
    """
    ranks = sorted(spans_by_rank)
    if not ranks:
        return {}
    ref = ranks[0] if ref_rank is None else ref_rank
    n = min((len(spans_by_rank[r]) for r in ranks), default=0)
    fits: Dict[int, OffsetFit] = {}
    ref_spans = list(spans_by_rank.get(ref, ()))[:n]
    for rank in ranks:
        if rank == ref:
            fits[rank] = OffsetFit(rank, ref, n_exchanges=n)
            continue
        spans = list(spans_by_rank[rank])[:n]
        if not spans or not ref_spans:
            fits[rank] = OffsetFit(
                rank, ref, uncertainty_s=float("inf"), n_exchanges=0
            )
            continue
        mids = [(b + e) / 2.0 for b, e in spans]
        deltas = [
            m - (rb + re) / 2.0
            for m, (rb, re) in zip(mids, ref_spans)
        ]
        halfw = [
            (e - b) / 2.0 + (re - rb) / 2.0
            for (b, e), (rb, re) in zip(spans, ref_spans)
        ]
        # width-outlier rejection: an exchange whose span is inflated
        # far beyond its peers (the first barrier carries the jit
        # compile; a bootstrap rendezvous can take seconds) contributes
        # a uselessly wide bound. Dropping wide exchanges preserves the
        # hard guarantee — the median-of-kept-deltas still errs at most
        # the kept max half-width — while tightening it to the clean
        # exchanges' scale.
        if len(halfw) > 2:
            cutoff = 4.0 * _median(halfw)
            kept = [j for j, w in enumerate(halfw) if w <= cutoff]
            if len(kept) >= 2:
                mids = [mids[j] for j in kept]
                deltas = [deltas[j] for j in kept]
                halfw = [halfw[j] for j in kept]
        t0 = mids[0]
        offset = _median(deltas)
        drift = 0.0
        t_range = mids[-1] - mids[0]
        if len(mids) >= DRIFT_MIN_EXCHANGES and t_range >= DRIFT_MIN_RANGE_S:
            # least squares around the median anchor: slope first, then
            # re-center the intercept as the median residual (keeps the
            # robustness of the median against one skewed exchange)
            xs = [m - t0 for m in mids]
            mean_x = sum(xs) / len(xs)
            mean_d = sum(deltas) / len(deltas)
            var = sum((x - mean_x) ** 2 for x in xs)
            if var > 0.0:
                drift = (
                    sum(
                        (x - mean_x) * (d - mean_d)
                        for x, d in zip(xs, deltas)
                    )
                    / var
                )
                offset = _median(
                    [d - drift * x for x, d in zip(xs, deltas)]
                )
        residuals = [
            abs(d - (offset + drift * (m - t0)))
            for m, d in zip(mids, deltas)
        ]
        fits[rank] = OffsetFit(
            rank,
            ref,
            offset_s=offset,
            drift_per_s=drift,
            t0=t0,
            # hard bound: per-exchange midpoint error <= the pair
            # half-widths, plus whatever the fit failed to explain
            uncertainty_s=max(halfw) + max(residuals),
            n_exchanges=len(mids),
        )
    return fits


def skew_from_spans(
    sites: Sequence[str],
    enters: Sequence[Sequence[float]],
    exits: Sequence[Sequence[float]],
    fit_sites: Sequence[str] = FIT_SITES,
) -> Dict[str, Any]:
    """The pure skew fold: per-rank aligned entry/exit stamps of a
    shared collective sequence -> the row's skew columns.

    ``enters[r][j]`` / ``exits[r][j]`` are rank ``r``'s LOCAL stamps
    for collective ``j`` (site ``sites[j]``); offsets are fitted from
    the ``fit_sites`` exchanges, every stamp is aligned, and per
    collective: the arrival spread is ``max(enter) - min(enter)`` (time
    the collective waited on its last arrival), the last arrival is the
    collective's straggler, and the total is ``max(exit) - min(enter)``.
    Separated from the allgather so the fold math is unit-testable with
    synthetic clocks.
    """
    out = dict(SKEW_ROW_DEFAULTS)
    n_ranks = len(enters)
    n = len(sites)
    if n_ranks < 2 or n == 0:
        return out
    fit_idx = [j for j in range(n) if sites[j] in fit_sites]
    if len(fit_idx) >= MIN_FIT_EXCHANGES:
        fits = fit_offsets(
            {
                r: [(enters[r][j], exits[r][j]) for j in fit_idx]
                for r in range(n_ranks)
            }
        )
    else:
        # too few safe exchange points in this row: NEVER fit from the
        # skew-bearing collectives themselves, and never from a lone
        # barrier either (an injected slowdown there would bias the
        # offsets by half its own magnitude — see MIN_FIT_EXCHANGES).
        # Raw stamps are exact on one host (system-wide
        # CLOCK_MONOTONIC) and the NaN clock_unc_s below says the
        # multi-host case carries no alignment claim.
        fits = {
            r: OffsetFit(
                r, 0,
                uncertainty_s=0.0 if r == 0 else float("nan"),
            )
            for r in range(n_ranks)
        }
    skew_enter = 0.0
    skew_exit = 0.0
    total = 0.0
    caused = [0.0] * n_ranks
    for j in range(n):
        a_enter = [fits[r].align(enters[r][j]) for r in range(n_ranks)]
        a_exit = [fits[r].align(exits[r][j]) for r in range(n_ranks)]
        first = min(a_enter)
        release = max(a_enter)
        end = max(a_exit)
        skew_j = release - first
        skew_enter += skew_j
        skew_exit += max(a_exit) - min(a_exit)
        total += max(end - first, 0.0)
        last = max(range(n_ranks), key=lambda r: a_enter[r])
        caused[last] += skew_j
    out["skew_enter_s"] = skew_enter
    out["skew_exit_s"] = skew_exit
    out["straggler_frac"] = skew_enter / total if total > 0.0 else 0.0
    if skew_enter > 0.0:
        out["straggler_rank"] = int(max(range(n_ranks), key=lambda r: caused[r]))
    unc = [
        f.uncertainty_s
        for f in fits.values()
        if f.rank != f.ref_rank and math.isfinite(f.uncertainty_s)
    ]
    out["clock_unc_s"] = max(unc) if unc else float("nan")
    return out


#: the fold's own exchanges: back-to-back one-element all-reduces whose
#: spans the offset fit reads (``fold_row_skew``)
FOLD_EXCHANGES = 5
#: the site of those exchanges in the folded span list
FOLD_SITE = "skew.fold"


def _exchange(runtime) -> Tuple[str, float, float]:
    """One fold exchange: a one-element sum over the world, waited for,
    between two monotonic stamps."""
    import torch

    token = torch.ones(1, device=runtime.device)
    t_enter = time.monotonic()
    runtime.all_reduce(token)
    runtime.synchronize()
    return FOLD_SITE, t_enter, time.monotonic()


def _gather_stamps(runtime, spans):
    """Every rank's ``(enter, exit)`` stamps as a float64 ``[ranks, n, 2]``
    array in rank order (two all-gathers through the runtime: the counts,
    then the stamps), or the list of counts when the ranks recorded
    different numbers of spans (then the stamps are not gathered: every
    rank sees the same counts and skips alike)."""
    import torch

    dev = runtime.device
    count = torch.tensor([len(spans)], dtype=torch.int64, device=dev)
    counts = runtime.blocks_by_rank(runtime.all_gather_rows(count)).cpu().tolist()
    if any(c != len(spans) for c in counts):
        return counts
    stamps = torch.tensor([[t0, t1] for _, t0, t1 in spans], dtype=torch.float64,
                          device=dev)
    gathered = runtime.blocks_by_rank(runtime.all_gather_rows(stamps))
    return gathered.cpu().numpy().reshape(len(counts), len(spans), 2)


def fold_row_skew(runtime) -> Dict[str, Any]:
    """One row's cross-rank skew columns, computed while the world is
    still in lock-step: the fold's own exchanges, then every rank's
    recorded spans shared by a float64 all-gather, offsets fitted, the
    aligned entry/exit stamps folded (``skew_from_spans``).

    The offsets are fitted on ``FOLD_EXCHANGES`` exchanges the fold makes
    itself, back to back (site ``FOLD_SITE``), and not on the row's
    barriers as the JAX package's fold does. A rank that arrives late at
    every barrier of a row (a persistent straggler) cannot be told from a
    clock that runs ahead by the midpoint estimator, which then absorbs
    half of its delay into the offset and reports the other half. The
    fold's exchanges follow one another with nothing between them, so no
    rank is late to any of them but the first (which the width-outlier
    rejection drops where it stands out); they enter the fold as
    collectives of the row too, with the skew they carry.

    Returns ``SKEW_ROW_DEFAULTS`` untouched on single-process worlds and
    on rows that recorded no collectives. A fold failure, or ranks that
    recorded different numbers of spans, keep the defaults with a
    warning: skew attribution never discards the measurement it
    annotates. The JAX fold's fault-injection site (``skew.fold``) is not
    ported (the port has no ``faults/``).
    """
    spans = row_spans()
    if getattr(runtime, "num_processes", 1) <= 1 or not spans:
        return dict(SKEW_ROW_DEFAULTS)
    try:
        with trace.span("skew.fold", cat="skew", collectives=len(spans)):
            spans += [_exchange(runtime) for _ in range(FOLD_EXCHANGES)]
            gathered = _gather_stamps(runtime, spans)
        if isinstance(gathered, list):
            logger.warn(
                f"cross-rank skew fold skipped: the ranks recorded different "
                f"numbers of collectives ({gathered}); row keeps default "
                f"skew columns"
            )
            return dict(SKEW_ROW_DEFAULTS)
        sites = [site for site, _, _ in spans]
        return skew_from_spans(
            sites,
            [list(gathered[r, :, 0]) for r in range(gathered.shape[0])],
            [list(gathered[r, :, 1]) for r in range(gathered.shape[0])],
            fit_sites=(FOLD_SITE,),
        )
    except Exception as exc:
        logger.warn(
            f"cross-rank skew fold failed ({type(exc).__name__}: {exc}); "
            f"row keeps default skew columns"
        )
        return dict(SKEW_ROW_DEFAULTS)
