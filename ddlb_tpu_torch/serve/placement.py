"""Where a serving cluster's engines run, and how every rank sees them all.

The JAX cluster has one controller: one process holds every engine, on
disjoint device groups, and takes every decision from their live state.
Here each rank is its own controller, so the cluster runs as several:

- **placement** (the JAX member's, ``ddlb_tpu/primitives/serving_load/
  cluster_base.py:126-173``): when the world divides by the engine count,
  engine ``e`` runs on ranks ``[e * tp, (e + 1) * tp)`` with ``tp = world /
  n_engines``, on a ``(1, tp)`` mesh over those ranks only (its dp is 1 as
  the engine sees it, so no collective of one engine pairs with another's
  ranks); otherwise every engine spans every rank at ``tp = world``. Every
  rank creates every engine's group, in one order, those it is not in too;
- **local work**: a rank steps only the engines it runs (``is_local``),
  and the first rank of each engine's group (``leads``) reports it;
- **one shared view**: ``share`` merges every rank's reports into the same
  dict on every rank (one ``Runtime.gather_objects``), and the cluster's
  decisions read only that, so every rank routes every request alike.

An engine that runs on other ranks is held here as an ``EngineStandIn``:
no weights, no cache, only what a submission must check. At world 1 every
engine is local and ``share`` is the identity.
"""

from __future__ import annotations

from typing import Optional

from ddlb_tpu_torch.models.serving import check_fits


class EngineStandIn:
    """An engine of the cluster that runs on other ranks, as this rank
    holds it: it takes the cluster's submissions (its figures live in the
    cluster's shared view) and raises where the engine's ``submit`` would,
    so that every rank fails a request that cannot fit alike."""

    def __init__(self, max_len: int, page_size: Optional[int] = None,
                 num_pages: int = 0, tp: int = 1) -> None:
        self.S_max, self.page_size, self.num_pages, self.tp = max_len, page_size, num_pages, tp
        self._pinned = 0
        self.reset()

    def reset(self) -> None:
        self._submitted = 0

    def set_shared_prefix(self, prefix) -> None:
        """The pages the engine's prefix pins (one full-page set a tp rank)."""
        if prefix is None or self.page_size is None:
            self._pinned = 0
        else:
            self._pinned = self.tp * (len(prefix) // self.page_size)

    def submit(self, request) -> int:
        check_fits(request, self.S_max, self.page_size, self.num_pages, self._pinned)
        self._submitted += 1
        return self._submitted - 1


def engine_groups(world: int, n_engines: int):
    """``(tp, groups)``: the ranks an engine and each engine's ranks, as
    the JAX member places its engines (see the module docstring)."""
    if world >= n_engines and world % n_engines == 0:
        tp = world // n_engines
        return tp, [tuple(range(e * tp, (e + 1) * tp)) for e in range(n_engines)]
    return world, [tuple(range(world))] * n_engines


class _Failed:
    """A rank's part of an exchange when its own work raised."""

    def __init__(self, exc: BaseException) -> None:
        self.what = f"{type(exc).__name__}: {exc}"


class EnginePlacement:
    """The ranks of each of ``n_engines`` engines (see the module
    docstring). Construct it on every rank at the same point: it creates
    the engines' process groups."""

    def __init__(self, runtime, n_engines: int) -> None:
        self.runtime, self.rank, self.world = runtime, runtime.rank, runtime.world_size
        self.tp, self.groups = engine_groups(self.world, n_engines)
        if self.tp > 1:
            runtime.subgroups(dict.fromkeys(self.groups))
        self._meshes = {}

    def is_local(self, e: int) -> bool:
        """This rank runs engine ``e``."""
        return self.rank in self.groups[e]

    def leads(self, e: int) -> bool:
        """This rank reports engine ``e`` (the first of its group)."""
        return self.groups[e][0] == self.rank

    def mesh(self, e: int):
        """Engine ``e``'s ``(1, tp)`` mesh over its group (this rank must
        run it); one per group."""
        group = self.groups[e]
        if group not in self._meshes:
            self._meshes[group] = self.runtime.mesh(1, self.tp, 1,
                                                    ranks=group if self.tp > 1 else None)
        return self._meshes[group]

    def share(self, mine: dict, failure: Optional[BaseException] = None) -> dict:
        """Every rank's ``mine`` (its entries, each under a key only one
        rank fills) merged, the same dict on every rank: one exchange. A
        rank whose own work raised passes the exception as ``failure``;
        then every rank raises, that one its own exception and the others a
        ``RuntimeError`` naming it, so that no rank goes on alone."""
        if self.world == 1:
            if failure is not None:
                raise failure
            return mine
        parts = self.runtime.gather_objects(_Failed(failure) if failure is not None else mine)
        if failure is not None:
            raise failure
        merged = {}
        for rank, part in enumerate(parts):
            if isinstance(part, _Failed):
                raise RuntimeError(f"serving cluster: rank {rank} failed: {part.what}")
            merged.update(part)
        return merged
