"""Persistent-straggler indictment: a transient hiccup or bad hardware.

The counterpart of the JAX package's ``observatory/health.py``. The skew
fold says which rank a row's collectives waited on; this module says
whether that straggler is a one-off (a scheduler stall) or a persistently
degraded component that every later run will hit again, by folding
straggler observations across rows and runs into a verdict a rank.

An **observation** is one banked or current row's ``straggler_rank`` /
``skew_enter_s`` / ``clock_unc_s`` (``observations_from_history``,
``observations_from_rows``). It *qualifies* only when it names a rank,
its skew clears the noise floor ``MIN_SKEW_S``, and its skew exceeds the
row's own clock-alignment uncertainty (a NaN uncertainty, a fold that
made no alignment claim, contributes nothing).

The **verdict** (``verdict_from_observations``) refuses thin evidence: a
persistent indictment needs ``MIN_OBSERVATIONS`` qualifying observations
with one rank causing at least ``DOMINANCE`` of them; a single skewed row
is refused, and stragglers that trade places classify *transient*. A
persistent verdict names the rank, the candidate hardware (the device
and its ring-neighbour links) and the counts. ``regress.detect_health``
gates it; the serving cluster reads ``exoneration_verdict``, the same
corroboration in reverse.

The JAX package's ``observations_from_timeline`` (the flight recorder's
world timeline) waits for ``faults/`` and ``relaunch_policy`` for the
supervised launcher. Stdlib only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ddlb_tpu_torch.observatory.regress import finite

#: a persistent indictment needs at least this many qualifying
#: observations: a single skewed row never indicts
MIN_OBSERVATIONS = 3

#: ...and one rank must cause at least this share of them: stragglers
#: alternating between ranks are host noise, not hardware
DOMINANCE = 0.6

#: the noise floor an observation's arrival skew must clear, seconds
MIN_SKEW_S = 0.05

HEALTHY = "healthy"
TRANSIENT = "transient"
PERSISTENT = "persistent"


def qualifying_rank(
    rank: Any, skew_s: Any, unc_s: Any, min_skew_s: float
) -> Optional[int]:
    """The qualifying rank of one observation, or None. ``unc_s``
    semantics: a finite bound gates the skew (within the bound = no
    claim); NaN/None means the source made no alignment claim at all —
    refused, matching ``detect_skew``'s NaN-uncertainty rule; 0.0 is an
    exact-clock claim (raw single-host stamps) and gates nothing."""
    try:
        r = int(rank)
    except (TypeError, ValueError):
        return None
    if r < 0:
        return None
    skew = finite(skew_s)
    if skew is None or skew <= min_skew_s:
        return None
    unc = finite(unc_s)
    if unc is None:
        return None
    if skew <= unc:
        return None
    return r


def observations_from_history(
    records: Sequence[Dict[str, Any]],
    run_id: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Observations from banked history records (``store.load_history``
    shape): one per row that carries the skew columns. ``run_id``
    restricts to one run's rows;
    None folds the whole bank (the longitudinal report)."""
    out: List[Dict[str, Any]] = []
    for record in records:
        if record.get("kind", "row") != "row":
            continue
        if run_id is not None and record.get("run_id") != run_id:
            continue
        row = record.get("row") or {}
        if "straggler_rank" not in row:
            continue
        out.append(
            {
                "rank": row.get("straggler_rank"),
                "skew_s": row.get("skew_enter_s"),
                "unc_s": row.get("clock_unc_s"),
                "source": "row",
                "run_id": record.get("run_id"),
                "label": str(row.get("implementation") or ""),
            }
        )
    return out


def observations_from_rows(
    rows: Sequence[Dict[str, Any]], run_id: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Observations from bare result rows (a current, not-yet-banked
    run — the ``detect_all`` surface)."""
    return observations_from_history(
        [{"kind": "row", "row": row, "run_id": run_id} for row in rows],
    )


def link_candidates(rank: int, world: Optional[int]) -> List[str]:
    """The hardware a persistently straggling rank indicts: its device
    and the ring-neighbour links it receives and sends on (the JAX
    package's ``link_label`` vocabulary, so its fault batteries and the
    port name a link alike). An observation cannot tell a slow device
    from a slow inbound link, so the verdict names all three."""
    out = [f"chip[{rank}]"]
    if world and world > 1:
        prev = (rank - 1) % world
        out.append(f"ici[{prev}->{rank}]")
        out.append(f"ici[{rank}->{(rank + 1) % world}]")
    return out


def verdict_from_observations(
    observations: Sequence[Dict[str, Any]],
    world: Optional[int] = None,
    min_observations: int = MIN_OBSERVATIONS,
    dominance: float = DOMINANCE,
    min_skew_s: float = MIN_SKEW_S,
) -> Dict[str, Any]:
    """Fold observations into the health verdict (module docstring)."""
    counts: Dict[int, int] = {}
    caused: Dict[int, float] = {}
    runs: Dict[int, set] = {}
    qualifying = 0
    for obs in observations:
        rank = qualifying_rank(
            obs.get("rank"), obs.get("skew_s"), obs.get("unc_s"), min_skew_s
        )
        if rank is None:
            continue
        qualifying += 1
        counts[rank] = counts.get(rank, 0) + 1
        caused[rank] = caused.get(rank, 0.0) + float(obs["skew_s"])
        runs.setdefault(rank, set()).add(obs.get("run_id"))
    doc: Dict[str, Any] = {
        "observations": len(observations),
        "qualifying": qualifying,
        "per_rank": {
            r: {
                "count": counts[r],
                "caused_s": caused[r],
                "runs": len(runs[r]),
            }
            for r in sorted(counts)
        },
    }
    if qualifying == 0:
        doc.update(
            status=HEALTHY, rank=-1, share=0.0, links=[],
            reason="no qualifying straggler observations",
        )
        return doc
    top = max(counts, key=lambda r: (counts[r], caused[r]))
    share = counts[top] / qualifying
    doc.update(rank=top, share=share)
    if counts[top] < min_observations:
        doc.update(
            status=TRANSIENT, links=[],
            reason=(
                f"rank {top} straggled {counts[top]}x — below the "
                f"{min_observations}-observation corroboration floor "
                f"(a single skewed row never indicts)"
            ),
        )
        return doc
    if share < dominance:
        doc.update(
            status=TRANSIENT, rank=-1, links=[],
            reason=(
                f"stragglers alternate across ranks (top rank {top} "
                f"caused only {share:.0%} of {qualifying} qualifying "
                f"observations, dominance floor {dominance:.0%}) — host "
                f"noise, not hardware"
            ),
        )
        return doc
    doc.update(
        status=PERSISTENT,
        links=link_candidates(top, world),
        reason=(
            f"rank {top} was the straggler in {counts[top]} of "
            f"{qualifying} qualifying observations ({share:.0%}) across "
            f"{len(runs[top])} run(s), causing {caused[top]:.3f}s of "
            f"arrival skew"
        ),
    )
    return doc


def exoneration_verdict(
    healthy_windows: Sequence[bool],
    min_observations: int = MIN_OBSERVATIONS,
    dominance: float = DOMINANCE,
) -> bool:
    """The indictment machinery run in reverse: may an
    indicted-and-drained serving shard be re-admitted? Each element is
    one post-indictment probation window's verdict (the serving
    cluster's probe-tick median inside both its dominance bar and the
    TPOT SLO). Exoneration demands the SAME corroboration an
    indictment does — at least ``MIN_OBSERVATIONS`` windows with a
    ``DOMINANCE`` share of them healthy — plus a healthy LATEST window
    (a shard that just relapsed must not ride its earlier good windows
    back in). Symmetric thresholds mean a component is never excluded
    on more evidence than would re-admit it."""
    windows = [bool(w) for w in healthy_windows]
    if len(windows) < min_observations:
        return False
    if not windows[-1]:
        return False
    return sum(windows) / len(windows) >= dominance
