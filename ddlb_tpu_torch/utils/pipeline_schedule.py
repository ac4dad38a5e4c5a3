"""Pipeline schedule tables: GPipe, 1F1B and interleaved 1F1B.

A copy of the JAX package's ``utils/pipeline_schedule.py`` (its Python
simulator; the C library it dispatches to when loaded is not ported, and
the two are held equal there). A small host list scheduler simulates the
dependency graph of a pipelined training step once and emits dense int32
tables indexed ``[tick, device]``: which op a device runs (idle, forward,
backward), for which microbatch and local chunk, and which activation
stash slot and landing slot it touches. The executors
(``primitives/pp_pipeline/schedules.py``, ``models/pipeline.py``) read
their own row of the tables each tick; every rank reads the same tables,
so every rank decides its hops alike.

Ops take one tick each. ``fwd(i, s)`` needs ``fwd(i, s-1)`` done a tick
earlier (the activation hops to the next stage), ``bwd(i, s)`` needs
``bwd(i, s+1)`` a tick earlier and ``fwd(i, s)`` done on the device (its
stashed input). Stage ``s`` lives on device ``s % n_devices``: with
``virtual > 1`` device ``p`` owns the chunks ``p, p+d, p+2d, ...``
(Megatron's interleaved placement), so every hop is still to a neighbour.

- ``gpipe``: every forward before any backward (peak stash: every
  microbatch);
- ``1f1b``: backwards as soon as they are ready, forwards held to the
  classic warm-up depth: as many ticks as GPipe, a stash of O(depth);
- ``interleaved``: 1F1B over ``virtual`` chunks a device, whose fill and
  drain amortise over ``virtual`` times the work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

KIND_IDLE, KIND_FWD, KIND_BWD = 0, 1, 2
SCHEDULES = ("gpipe", "1f1b", "interleaved")
#: the tables an executor reads, each int32 ``[ticks, n_devices]``
TABLES = ("kind", "mb", "chunk", "act_slot", "in_slot", "fwd_land", "bwd_land")


@dataclass
class ScheduleTables:
    """Dense per-tick tables plus their accounting. A slot of ``-1``
    means that the tick touches no slot of that kind."""

    schedule: str
    n_devices: int
    n_stages: int              # the chain's depth: n_devices * virtual
    virtual: int
    microbatches: int
    ticks: int
    kind: np.ndarray           # KIND_* per (tick, device)
    mb: np.ndarray             # the op's microbatch, -1 when idle
    chunk: np.ndarray          # the op's local chunk, -1 when idle
    act_slot: np.ndarray       # forward: stash slot written; backward: read
    in_slot: np.ndarray        # landing slot consumed, -1 for none
    fwd_land: np.ndarray       # slot the activation that hopped in lands in
    bwd_land: np.ndarray       # slot the cotangent that hopped in lands in
    act_slots: int             # stash capacity
    land_slots: int            # landing capacity
    busy: np.ndarray           # busy ticks per device

    @property
    def bubble_fraction(self) -> float:
        """The idle share of the (tick, device) grid."""
        return 1.0 - float(self.busy.sum()) / (self.ticks * self.n_devices)

    @property
    def peak_stash(self) -> int:
        """The most activations any device holds at once."""
        return self.act_slots


def hops_due(landing: np.ndarray) -> np.ndarray:
    """Per tick, whether the tick's hop carries anything: something lands
    on some device at the next tick (``landing``: ``fwd_land`` or
    ``bwd_land``). Every rank reads the same answer from the tables."""
    lands = (landing >= 0).any(axis=1)
    return np.append(lands[1:], False)


class _FreeList:
    """Slot allocator that records its high-water mark."""

    def __init__(self) -> None:
        self.free: List[int] = []
        self.next = 0
        self.high = 0

    def take(self) -> int:
        if self.free:
            return self.free.pop()
        s = self.next
        self.next += 1
        self.high = max(self.high, self.next)
        return s

    def give(self, slot: int) -> None:
        self.free.append(slot)


def build_schedule(schedule: str, n_devices: int, microbatches: int,
                   virtual: int = 1) -> ScheduleTables:
    """Validate the arguments as the JAX package does, then simulate."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule '{schedule}'; one of {SCHEDULES}")
    if schedule == "1f1b" and virtual != 1:
        # 1F1B over several chunks is the interleaved schedule
        raise ValueError("1f1b is the virtual=1 schedule; use 'interleaved'")
    if schedule == "interleaved" and virtual < 2:
        raise ValueError("schedule='interleaved' needs virtual >= 2")
    return _build_schedule_py(schedule, n_devices, microbatches, virtual)


def _build_schedule_py(schedule: str, n_devices: int, microbatches: int,
                       virtual: int = 1) -> ScheduleTables:
    """The list scheduler (JAX :149-338), on validated arguments. gpipe
    takes any ``virtual``: the same placement under the flush policy, the
    equal-depth partner of ``interleaved``."""
    d, mb, v = n_devices, microbatches, virtual
    S = d * v

    def dev(s: int) -> int:
        return s % d

    def chunk(s: int) -> int:
        return s // d

    # completion tick of each op
    fwd_done: Dict[Tuple[int, int], int] = {}
    bwd_done: Dict[Tuple[int, int], int] = {}
    # per-device slot allocators and the live (microbatch, stage) -> slot maps
    acts = [_FreeList() for _ in range(d)]
    act_of: Dict[Tuple[int, int], int] = {}
    lands_f = [_FreeList() for _ in range(d)]
    lands_b = [_FreeList() for _ in range(d)]
    land_of_f: Dict[Tuple[int, int], int] = {}
    land_of_b: Dict[Tuple[int, int], int] = {}
    rows: List[Dict[str, List[int]]] = []
    # forwards in flight, for the 1F1B throttle
    outstanding = [0] * d

    def warmup_cap(p: int) -> int:
        # the classic 1F1B warm-up depth, plus one (steady state alternates
        # F and B, so the count in flight peaks one above it); interleaved
        # takes Megatron's form (Narayanan et al. 2021), whose (v-1)*d term
        # lets the deepest device reach the chunk-(v-1) forwards that start
        # the drain
        if schedule == "gpipe":
            return mb * v
        if v == 1:
            return d - p
        return (d - p - 1) * 2 + (v - 1) * d + 1

    # fixed per-device issue orders (Megatron's): the simulator decides
    # timing only. Forwards: groups of d microbatches round-robin through
    # the chunks; backwards: the same groups, chunks deepest first. A
    # greedy order can spend a device's budget on shallow forwards and
    # deadlock the drain (d=8, mb=32, v=2).
    fwd_order: List[List[Tuple[int, int]]] = []
    bwd_order: List[List[Tuple[int, int]]] = []
    for p in range(d):
        ops = [(i, c * d + p) for c in range(v) for i in range(mb)]
        fwd_order.append(sorted(ops, key=lambda x: (x[0] // d, chunk(x[1]), x[0] % d)))
        bwd_order.append(sorted(ops, key=lambda x: (x[0] // d, v - 1 - chunk(x[1]),
                                                    x[0] % d)))
    fptr = [0] * d
    bptr = [0] * d

    n_ops_total = 2 * mb * S
    done_ops = 0
    total_fwd = mb * S
    fwd_issued = 0
    t = 0
    max_ticks = 16 * (mb * v + d) + 64
    while done_ops < n_ops_total:
        if t >= max_ticks:  # pragma: no cover - a scheduler bug
            raise RuntimeError(
                f"schedule '{schedule}' failed to converge (d={d}, mb={mb}, v={v})"
            )
        col = {name: [KIND_IDLE if name == "kind" else -1] * d for name in TABLES}
        # 1) what was sent at the end of tick t-1 lands now
        for (i, s), tdone in list(fwd_done.items()):
            if tdone == t - 1 and s + 1 < S:
                p = dev(s + 1)
                slot = lands_f[p].take()
                land_of_f[(i, s + 1)] = slot
                col["fwd_land"][p] = slot
        for (i, s), tdone in list(bwd_done.items()):
            if tdone == t - 1 and s - 1 >= 0:
                p = dev(s - 1)
                slot = lands_b[p].take()
                land_of_b[(i, s - 1)] = slot
                col["bwd_land"][p] = slot

        # 2) each device runs the next ready op of its order, a backward
        # first (gpipe: only once every forward ran)
        for p in range(d):
            pick: Optional[Tuple[int, int, int]] = None  # (kind, i, s)
            bwd_ok = schedule != "gpipe" or fwd_issued == total_fwd
            if bwd_ok and bptr[p] < len(bwd_order[p]):
                i, s = bwd_order[p][bptr[p]]
                td_f = fwd_done.get((i, s))
                ready = td_f is not None and td_f < t
                if ready and s + 1 < S:
                    td = bwd_done.get((i, s + 1))
                    ready = td is not None and td < t
                if ready:
                    pick = (KIND_BWD, i, s)
                    bptr[p] += 1
            if (pick is None and outstanding[p] < warmup_cap(p)
                    and fptr[p] < len(fwd_order[p])):
                i, s = fwd_order[p][fptr[p]]
                ready = True
                if s > 0:
                    td = fwd_done.get((i, s - 1))
                    ready = td is not None and td < t
                if ready:
                    pick = (KIND_FWD, i, s)
                    fptr[p] += 1
            if pick is None:
                continue
            kind, i, s = pick
            col["kind"][p] = kind
            col["mb"][p] = i
            col["chunk"][p] = chunk(s)
            if kind == KIND_FWD:
                fwd_done[(i, s)] = t
                fwd_issued += 1
                outstanding[p] += 1
                slot = acts[p].take()
                act_of[(i, s)] = slot
                col["act_slot"][p] = slot
                if s > 0:
                    lslot = land_of_f.pop((i, s))
                    col["in_slot"][p] = lslot
                    lands_f[p].give(lslot)
            else:
                bwd_done[(i, s)] = t
                outstanding[p] -= 1
                slot = act_of.pop((i, s))
                col["act_slot"][p] = slot
                acts[p].give(slot)
                if s + 1 < S:
                    lslot = land_of_b.pop((i, s))
                    col["in_slot"][p] = lslot
                    lands_b[p].give(lslot)
            done_ops += 1
        rows.append(col)
        t += 1

    cols = {name: np.array([r[name] for r in rows], np.int32) for name in TABLES}
    return ScheduleTables(
        schedule=schedule,
        n_devices=d,
        n_stages=S,
        virtual=v,
        microbatches=mb,
        ticks=len(rows),
        act_slots=max(max(a.high for a in acts), 1),
        land_slots=max(max(f.high for f in lands_f), max(b.high for b in lands_b), 1),
        busy=(cols["kind"] != KIND_IDLE).sum(axis=0).astype(np.int64),
        **cols,
    )
