"""Prefix-affinity request router: dp > 1 as one engine per dp shard.

The counterpart of the JAX package's ``serve/router.py``. The engine's
shared-prefix cache is per engine: a Zipf workload's hot prefix pays its
prefill once per shard that serves it, so the router's first preference
is affinity: a request carrying a prefix the cluster has routed before
goes back to the same shard (a hit there, a miss anywhere else). Affinity
yields to load: when the affine shard's outstanding work exceeds
``imbalance * (best + 1)`` the request falls through to the shard with
the least outstanding work (ties: the lowest index), which is also the
policy for requests without a prefix. Outstanding work is counted in
tokens still to generate (queued budgets + active remainders), not in
requests.

The comparisons are weighted by cost: every shard carries a ``weight``
(1.0 nominal; 2.0 = each of its tokens costs twice the reference tick),
and the router compares ``weight * outstanding``, so a degraded but live
shard draws proportionally less load instead of being excluded. The
cluster re-resolves weights whenever a shard's health verdict flips;
``drop_shard`` (exclusion) is kept for shards that also break the SLO.

The routable set is elastic: ``add_shard`` admits a promoted decode
shard mid-run, ``remove_shard`` retires a demoted one (its affinities
re-home as after a drop), ``readmit_shard`` reverses an exclusion after
probation. Indices are cluster-global, so a promoted prefill engine keeps
its identity across role flips; ``grow`` widens the index space.

Not ported: the JAX router's ``serve.route`` fault site.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class PrefixAffinityRouter:
    def __init__(
        self,
        n_shards: int,
        imbalance: float = 2.0,
        routable: Optional[Sequence[int]] = None,
    ) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if imbalance < 1.0:
            raise ValueError(f"imbalance must be >= 1.0, got {imbalance}")
        self.n_shards = int(n_shards)
        self.imbalance = float(imbalance)
        #: prefix population rank -> shard that first served it
        self.affinity: Dict[int, int] = {}
        #: shards the router may pick from (the decode pool; elastic)
        self.routable: set = (
            set(range(self.n_shards))
            if routable is None
            else {int(s) for s in routable}
        )
        self.excluded: set = set()
        #: per-shard cost weight (1.0 nominal; > 1 = degraded)
        self.weights: Dict[int, float] = {
            s: 1.0 for s in range(self.n_shards)
        }
        self.affinity_hits = 0
        self.routed = 0

    def grow(self, n_shards: int) -> None:
        """Widen the index space to ``n_shards`` without making the new
        indices routable (the cluster registers its prefill engines here,
        so a later promotion needs no re-indexing)."""
        if n_shards > self.n_shards:
            for s in range(self.n_shards, int(n_shards)):
                self.weights.setdefault(s, 1.0)
            self.n_shards = int(n_shards)

    def live_shards(self) -> List[int]:
        return sorted(s for s in self.routable if s not in self.excluded)

    def add_shard(self, shard: int) -> None:
        """Admit ``shard`` to the routable set (a prefill shard promoted
        into the decode pool mid-run)."""
        shard = int(shard)
        if shard >= self.n_shards:
            self.grow(shard + 1)
        self.routable.add(shard)
        self.weights.setdefault(shard, 1.0)

    def remove_shard(self, shard: int) -> None:
        """Retire ``shard`` from the routable set (a demotion back to the
        prefill pool); its affinities re-home on the survivors."""
        shard = int(shard)
        self.routable.discard(shard)
        self.affinity = {
            p: s for p, s in self.affinity.items() if s != shard
        }

    def drop_shard(self, shard: int) -> None:
        """Exclude ``shard`` and forget the affinities homed on it."""
        self.excluded.add(int(shard))
        self.affinity = {
            p: s for p, s in self.affinity.items() if s != shard
        }

    def readmit_shard(self, shard: int, weight: float = 1.0) -> None:
        """Reverse an exclusion after probation exonerates the shard: back
        in the candidate set at ``weight`` (>= 1.0)."""
        self.excluded.discard(int(shard))
        self.set_weight(shard, weight)

    def set_weight(self, shard: int, weight: float) -> None:
        """Pin ``shard``'s cost weight."""
        if weight < 1.0:
            raise ValueError(f"weight must be >= 1.0, got {weight}")
        self.weights[int(shard)] = float(weight)

    def _load(self, shard: int, outstanding: Sequence[float]) -> float:
        return self.weights.get(shard, 1.0) * float(outstanding[shard])

    def route(self, prefix_id: int, outstanding: Sequence[float]) -> int:
        """Pick a live shard for one request. ``outstanding[s]`` is shard
        ``s``'s tokens still to generate, indexed over every shard
        (entries of shards that are not live are ignored); loads are
        ``weights[s] * outstanding[s]``."""
        live = self.live_shards()
        if not live:
            raise RuntimeError("no live shards to route to")
        best = min(live, key=lambda s: (self._load(s, outstanding), s))
        choice = best
        if prefix_id >= 0:
            aff = self.affinity.get(prefix_id)
            if aff is not None and aff in live:
                # affinity wins unless the affine shard is drowning next
                # to the best (+1 keeps a zero-load best from making any
                # affine load "imbalanced")
                if self._load(aff, outstanding) <= self.imbalance * (
                    self._load(best, outstanding) + 1.0
                ):
                    choice = aff
                    self.affinity_hits += 1
            else:
                self.affinity[prefix_id] = choice
        self.routed += 1
        return choice
