"""The serving cluster's exoneration verdict: the part of the JAX
package's ``observatory/health.py`` (:51-59, :253-273) the cluster reads.

An indictment needs ``MIN_OBSERVATIONS`` qualifying observations with one
component causing at least ``DOMINANCE`` of them; exoneration demands the
same corroboration in reverse, so a component is never excluded on more
evidence than would re-admit it.
"""

from __future__ import annotations

from typing import Sequence

#: observations a verdict needs at the least
MIN_OBSERVATIONS = 3

#: share of the observations that must agree
DOMINANCE = 0.6


def exoneration_verdict(
    healthy_windows: Sequence[bool],
    min_observations: int = MIN_OBSERVATIONS,
    dominance: float = DOMINANCE,
) -> bool:
    """May an indicted and drained serving shard be re-admitted? Each
    element is one probation window's verdict (the probe ticks' median
    inside both the dominance bar and the TPOT SLO). Yes when there are at
    least ``min_observations`` windows, a ``dominance`` share of them
    healthy, and the latest one healthy (a shard that just relapsed does
    not ride its earlier good windows back in)."""
    windows = [bool(w) for w in healthy_windows]
    if len(windows) < min_observations:
        return False
    if not windows[-1]:
        return False
    return sum(windows) / len(windows) >= dominance
