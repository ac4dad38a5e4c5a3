"""Continuous-batching serving engine: slot-level admission over the ragged
decode step.

The port of the JAX package's ``models/serving.py``. ``max_batch`` slots
share one KV cache (one per rank, over this rank's tp heads). A request is
admitted into a free slot by a prefill of ``tp`` copies of its prompt (so
the MoE block router's ``b % tp`` holds) into a small contiguous scratch
cache; the copy the router gives the slot's expert, ``e(slot) = slot //
(B / tp)``, is the one whose rows and logits are kept. Prompts are padded
to power-of-two buckets of at least 16 (bucketed prefill, read at the
prompt's last row; ``bucket_prefill=False`` prefills the exact length).
Every tick runs ONE ragged decode over all lanes: an active slot at its
own position, an idle slot parked at ``pos = max_len``, where its write
drops and its output is ignored. A slot frees at ``max_new`` tokens or
when it emits ``eos_id``.

The shared prefix (``set_shared_prefix``): a prompt prefix (a system
prompt) is prefilled once; an admission whose prompt starts with it seeds
its scratch with the prefix's rows and runs the verify chunk
(``decode.make_chunk_decode_fn``) over the suffix only, attending the
prefix through the cache (``prefix_hits``, ``prefill_tokens_saved``).

``cache_layout='paged'``: the big cache is a shared page pool with a
per-slot page table (``decode.init_paged_cache``): an admission takes
``ceil((prompt + max_new) / page_size)`` pages off a host free list (less
the prefix's full pages, which are shared, one page set per expert, since
a prefix row past layer 0 depends on the expert) and scatters the scratch
rows it owns into them; a completion unmaps its table row (the parked
lane reads zeros) and returns its pages. A replaced prefix's pages return
when the last slot that maps them finishes. The queue is FIFO: a head
request that does not fit defers (``admissions_deferred``).

``preempt`` folds a running request's generated tokens into its prompt,
parks its lane and requeues the remnant (back or front): it resumes the
same greedy chain, its K/V rows re-paid as prefill at re-admission
(``kv_evicted_tokens``). ``evict`` hands the remnant to the caller and
``drop_queue`` empties the queue: the mechanism a cluster drain needs.

The engine's mesh has dp = 1; every tp rank runs its own engine on the
same workload, and the schedule stays identical on every rank because the
logits after the tp collectives are.

Not ported: the fault-injection and telemetry sites (the port has no
``faults/`` or ``telemetry/`` yet).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ddlb_tpu_torch.models.decode import (
    init_cache,
    init_paged_cache,
    make_chunk_decode_fn,
    make_decode_fn,
    make_prefill_fn,
)
from ddlb_tpu_torch.models.transformer import TransformerConfig


@dataclass
class Request:
    """One generation request. ``max_new`` caps the generated tokens;
    ``eos_id`` (engine-level) can end it earlier."""

    prompt: np.ndarray          # [S0] int32
    max_new: int

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")


@dataclass
class Completion:
    """A finished request: prompt + generated tokens (the eos token
    included when one ended it), the slot it ran in."""

    request_index: int
    slot: int
    tokens: np.ndarray
    finished_by: str            # "max_new" | "eos"
    admitted_at_step: int
    finished_at_step: int


@dataclass
class EngineStats:
    """Counters of one drain: scheduling health, the prefix cache's
    effect, load shedding and page-pool pressure."""

    steps: int = 0              # ragged decode ticks
    generated: int = 0          # tokens emitted (incl. each admission's first)
    admissions: int = 0
    lane_ticks_active: int = 0
    lane_ticks_total: int = 0
    prefix_hits: int = 0        # admissions served from the shared prefix
    prefill_tokens_saved: int = 0
    preemptions: int = 0        # requests preempted mid-generation
    kv_evicted_tokens: int = 0  # the cache rows those preemptions abandoned
    pages_capacity: int = 0
    pages_in_use: int = 0       # incl. the shared prefix's pages
    peak_pages_in_use: int = 0
    admissions_deferred: int = 0

    @property
    def occupancy(self) -> float:
        """Share of decode-lane capacity that did useful work."""
        if self.lane_ticks_total == 0:
            return 0.0
        return self.lane_ticks_active / self.lane_ticks_total


def check_fits(request: Request, max_len: int, page_size: Optional[int] = None,
               num_pages: int = 0, pinned_pages: int = 0) -> None:
    """Raise ``ValueError`` when ``request`` could never run on an engine
    of ``max_len`` positions; paged (``page_size`` given), against its
    worst case (no prefix credit, since the prefix can change while it
    waits) in a pool of ``num_pages`` of which the shared prefix pins
    ``pinned_pages``. ``submit``'s check, which a serving cluster also makes
    for an engine that runs on other ranks."""
    S0 = request.prompt.size
    if S0 + request.max_new > max_len:
        raise ValueError(
            f"prompt {S0} + max_new {request.max_new} exceeds "
            f"max_len {max_len}"
        )
    if page_size is not None:
        worst = -(-(S0 + request.max_new) // page_size)
        usable = num_pages - pinned_pages
        if worst > usable:
            raise ValueError(
                f"request needs up to {worst} pages but the pool has "
                f"{usable} usable ({num_pages} total, "
                f"{pinned_pages} pinned by the prefix)"
            )


class ContinuousBatchingEngine:
    """Greedy continuous-batching engine over one ``(1, tp)`` mesh.

    ``submit()`` requests, then ``run()`` to drain; or ``admit_ready()`` +
    ``step()`` by hand. ``params`` are this rank's (``shard_params``); the
    caches live on their device.
    """

    def __init__(self, mesh, cfg: TransformerConfig, params, max_batch: int,
                 max_len: int, eos_id: Optional[int] = None,
                 num_pages: Optional[int] = None, bucket_prefill: bool = True):
        if mesh.dp != 1:
            raise ValueError(
                "engine mesh must have dp=1 (run one engine per dp shard; "
                "the in-engine batch axis is the slot axis)"
            )
        self.tp = mesh.tp
        if max_batch % self.tp != 0:
            raise ValueError(
                f"max_batch={max_batch} not divisible by tp={self.tp} "
                f"(the MoE block router)"
            )
        self.mesh, self.cfg, self.params = mesh, cfg, params
        self.device = params["embed"].device
        self.B, self.S_max = max_batch, max_len
        self.eos_id = eos_id
        self.paged = cfg.cache_layout == "paged"
        # prefills and chunks run on small contiguous scratch caches
        self._scratch_cfg = dataclasses.replace(cfg, cache_layout="contiguous")
        if self.paged:
            ps = cfg.page_size
            if max_len % ps:
                raise ValueError(f"max_len={max_len} not divisible by page_size={ps}")
            self.page_size = ps
            self.max_pages = max_len // ps
            self.num_pages = (
                num_pages if num_pages is not None else max_batch * self.max_pages
            )
            if self.num_pages < 1:
                raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        elif num_pages is not None:
            raise ValueError("num_pages only applies to cache_layout='paged'")
        self._bucket_prefill = bucket_prefill
        self._decode = make_decode_fn(mesh, cfg, ragged=True)
        self._prefill = make_prefill_fn(mesh, self._scratch_cfg,
                                        dynamic_last=bucket_prefill)
        self._chunk = make_chunk_decode_fn(mesh, self._scratch_cfg)
        self._prefix_tokens: Optional[np.ndarray] = None
        self._prefix_scratch = None
        self._prefix_pages: List[int] = []
        self.reset()

    def reset(self) -> None:
        """A fresh cache, every lane parked, queues and stats cleared. A
        shared prefix survives (it derives from the parameters); paged,
        its pages are pinned again in the fresh pool."""
        if self.paged:
            self.cache = init_paged_cache(
                self.cfg, self.B, self.S_max, self.num_pages, mesh=self.mesh,
                device=self.device,
            )
            self._free_pages = list(range(self.num_pages))
            self._slot_pages: List[List[int]] = [[] for _ in range(self.B)]
            self._table_np = np.full(
                (self.B, self.max_pages), self.num_pages, np.int32
            )
            self._prefix_pages = []
            self._prefix_pages_by_e: List[List[int]] = [[] for _ in range(self.tp)]
            self._prefix_slots: set = set()
            self._retired_prefix: List[tuple] = []
        else:
            self.cache = init_cache(
                self.cfg, self.B, self.S_max, mesh=self.mesh, device=self.device
            )
        self.pos = np.full(self.B, self.S_max, np.int32)
        self.cur_tok = np.zeros(self.B, np.int32)
        self._slot_req = [None] * self.B
        self._slot_new = [[] for _ in range(self.B)]
        self._slot_admitted = [0] * self.B
        self._queue = deque()
        self._requests = []
        self.completions = []
        self.stats = EngineStats()
        if self.paged:
            self.stats.pages_capacity = self.num_pages
            if self._prefix_tokens is not None:
                self._seed_prefix_pages()

    # -- scheduling ------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; returns its index. A request that could never
        fit fails here, not mid-drain (``check_fits``)."""
        if self.paged:
            check_fits(request, self.S_max, self.page_size, self.num_pages,
                       len(self._prefix_pages))
        else:
            check_fits(request, self.S_max)
        idx = len(self._requests)
        self._requests.append(request)
        self._queue.append(idx)
        return idx

    # -- paged-pool bookkeeping (host side) ---------------------------------------

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        if len(self._free_pages) < n:
            return None
        pages = [self._free_pages.pop() for _ in range(n)]
        self._gauge_pages()
        return pages

    def _release_pages(self, pages: List[int]) -> None:
        self._free_pages.extend(pages)
        self._gauge_pages()

    def _gauge_pages(self) -> None:
        in_use = self.num_pages - len(self._free_pages)
        self.stats.pages_in_use = in_use
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use, in_use)

    def _push_table(self) -> None:
        self.cache["table"] = torch.from_numpy(self._table_np.copy()).to(self.device)

    def _prefix_full_pages(self) -> int:
        """Full pages the shared prefix covers (the shared part; a partial
        last page is copied per admission)."""
        if self._prefix_tokens is None:
            return 0
        return self._prefix_tokens.size // self.page_size

    def _retire_prefix_pages(self) -> None:
        """Stop treating the current page set as the prefix's and return
        its pages, deferred while an active slot still maps them (an
        immediate release would let a later admission overwrite rows an
        in-flight sequence attends)."""
        if self._prefix_pages:
            if self._prefix_slots:
                self._retired_prefix.append((self._prefix_pages, set(self._prefix_slots)))
            else:
                self._release_pages(self._prefix_pages)
            self._prefix_pages = []
        self._prefix_pages_by_e = [[] for _ in range(self.tp)]
        self._prefix_slots = set()

    def _drain_retired_prefix(self, slot: int) -> None:
        """Slot ``slot`` left: drop it from every retired prefix group and
        release a group no active slot maps any more."""
        kept = []
        for pages, slots in self._retired_prefix:
            slots.discard(slot)
            if slots:
                kept.append((pages, slots))
            else:
                self._release_pages(pages)
        self._retired_prefix = kept

    def _seed_prefix_pages(self) -> None:
        """Pin the prefix's full pages into the pool, one page set per
        expert (a prefix row past layer 0 depends on the slot's expert)."""
        self._retire_prefix_pages()
        p_full = self._prefix_full_pages()
        if p_full == 0:
            return
        ps, p_len = self.page_size, self._prefix_tokens.size
        # the capacity check before any allocation: a partial failure would
        # pin pages no prefix owns
        if self.tp * p_full > len(self._free_pages):
            raise ValueError(
                f"page pool too small for the shared prefix: need "
                f"{p_full} pages x tp={self.tp}, have "
                f"{len(self._free_pages)} free of {self.num_pages}"
            )
        for e in range(self.tp):
            pages = self._alloc_pages(p_full)
            # the full-page rows to the pages; the partial tail (copied per
            # admission) to the sentinel, dropped
            pages_vec = np.full(p_len, self.num_pages, np.int32)
            pages_vec[:p_full * ps] = np.repeat(pages, ps)
            rows_vec = np.arange(p_len, dtype=np.int32) % ps
            self._scatter_into_pool(self._prefix_scratch, pages_vec, rows_vec, e)
            self._prefix_pages_by_e[e] = pages
            self._prefix_pages.extend(pages)

    def set_shared_prefix(self, prefix) -> None:
        """Prefill a shared prompt prefix once; every admission whose
        prompt starts with it (and goes on past it) reuses its rows and
        prefills only the suffix, by a verify chunk at ``start = P`` that
        attends the prefix through the cache. The prefix's rows are a full
        prefill's by construction; the suffix's logits agree to float
        tolerance. ``None`` clears the prefix. A set prefix survives
        ``reset()``."""
        if prefix is None:
            self._prefix_tokens = None
            self._prefix_scratch = None
            if self.paged:
                self._retire_prefix_pages()
            return
        prefix = np.asarray(prefix, np.int32)
        if prefix.ndim != 1 or prefix.size == 0:
            raise ValueError("prefix must be a non-empty 1-D token array")
        rep = torch.from_numpy(np.broadcast_to(prefix, (self.tp, prefix.size)).copy())
        scratch = init_cache(self._scratch_cfg, self.tp, prefix.size, mesh=self.mesh,
                             device=self.device)
        # exact length: the seeding keys on the exact row count
        args = (prefix.size - 1,) if self._bucket_prefill else ()
        _, scratch = self._prefill(self.params, scratch, rep.to(self.device), *args)
        self._prefix_tokens = prefix
        self._prefix_scratch = scratch
        if self.paged:
            try:
                self._seed_prefix_pages()
            except Exception:
                # no half-set prefix: a match with no mapped pages would
                # break later admissions
                self._prefix_tokens = None
                self._prefix_scratch = None
                raise

    def _expert_of(self, slot: int) -> int:
        # the block router's slot-stable assignment on a dp = 1 shard
        return slot // (self.B // self.tp)

    def _prefix_match_len(self, req: Request) -> int:
        """The shared prefix's length if this prompt starts with it and
        goes on past it, else 0."""
        if self._prefix_tokens is None:
            return 0
        p_len = self._prefix_tokens.size
        if req.prompt.size > p_len and np.array_equal(req.prompt[:p_len],
                                                      self._prefix_tokens):
            return p_len
        return 0

    def _pages_needed(self, req: Request) -> int:
        """Fresh pages an admission takes: prompt + every generated token,
        less the prefix's shared full pages on a match."""
        total = -(-(req.prompt.size + req.max_new) // self.page_size)
        shared = self._prefix_full_pages() if self._prefix_match_len(req) else 0
        return total - shared

    def admit_ready(self) -> int:
        """Admit queued requests into free slots (FIFO; a paged head
        request that does not fit defers); returns the count admitted."""
        n = 0
        for slot in range(self.B):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            if self.paged:
                head = self._requests[self._queue[0]]
                need = self._pages_needed(head)
                # a prefix set after the request was submitted can pin the
                # pages it needs for good: deferring would spin run()
                # forever, so fail at the one capacity decision point
                ever = self.num_pages - len(self._prefix_pages)
                if need > ever:
                    raise RuntimeError(
                        f"queued request {self._queue[0]} needs {need} "
                        f"pages but only {ever} can ever free "
                        f"({self.num_pages} total, {len(self._prefix_pages)} "
                        f"pinned by a prefix set after it was submitted)"
                    )
                if need > len(self._free_pages):
                    self.stats.admissions_deferred += 1
                    break
            self._admit(slot, self._queue.popleft())
            n += 1
        return n

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two >= n, floored at 16."""
        b = 16
        while b < n:
            b *= 2
        return b

    @property
    def queue_depth(self) -> int:
        """Requests queued and not yet admitted."""
        return len(self._queue)

    def active_slots(self) -> List[int]:
        """Slots running a request."""
        return [s for s in range(self.B) if self._slot_req[s] is not None]

    def slot_request(self, slot: int) -> Optional[int]:
        """The request index slot ``slot`` runs, or None (idle)."""
        return self._slot_req[slot]

    def queue_head(self) -> Optional[int]:
        """The request index at the head of the queue, or None."""
        return self._queue[0] if self._queue else None

    def outstanding_tokens(self) -> int:
        """Tokens still to generate across the queue and the active slots
        (a queue of long generations is more load than one of short
        ones, which ``queue_depth`` cannot see)."""
        queued = sum(self._requests[i].max_new for i in self._queue)
        return queued + sum(self.remaining_budget(s) for s in self.active_slots())

    def remaining_budget(self, slot: int) -> int:
        """Tokens slot ``slot``'s request may still generate (0 if idle)."""
        req_idx = self._slot_req[slot]
        if req_idx is None:
            return 0
        return self._requests[req_idx].max_new - len(self._slot_new[slot])

    def _admit(self, slot: int, req_idx: int) -> None:
        req = self._requests[req_idx]
        S0 = req.prompt.size
        e = self._expert_of(slot)
        P_len = self._prefix_match_len(req)
        # bucket-pad tails hold token 0: their rows are causally downstream
        # of every real row; the copy drops them (paged) or parks them past
        # pos, where the ragged decode overwrites a row before reading it
        if P_len:
            t_real = S0 - P_len
            t_pad = (min(self._bucket(t_real), self.S_max - P_len)
                     if self._bucket_prefill else t_real)
            scratch = init_cache(self._scratch_cfg, self.tp, P_len + t_pad,
                                 mesh=self.mesh, device=self.device)
            for name, rows in self._prefix_scratch.items():
                scratch[name][:, :, :P_len] = rows
            suffix = np.zeros((self.tp, t_pad), np.int32)
            suffix[:, :t_real] = req.prompt[P_len:]
            logits, scratch = self._chunk(
                self.params, scratch, torch.from_numpy(suffix).to(self.device), P_len
            )
            logits = logits[:, t_real - 1]
            self.stats.prefix_hits += 1
            self.stats.prefill_tokens_saved += P_len
        else:
            s_pad = min(self._bucket(S0), self.S_max) if self._bucket_prefill else S0
            scratch = init_cache(self._scratch_cfg, self.tp, s_pad, mesh=self.mesh,
                                 device=self.device)
            prompt_np = np.zeros((self.tp, s_pad), np.int32)
            prompt_np[:, :S0] = req.prompt
            args = (S0 - 1,) if self._bucket_prefill else ()
            logits, scratch = self._prefill(
                self.params, scratch, torch.from_numpy(prompt_np).to(self.device), *args
            )
        if self.paged:
            self._map_slot_pages(slot, req, e, P_len, scratch)
        else:
            s_len = scratch["k"].shape[2]
            for name, big in self.cache.items():
                big[:, slot, :s_len] = scratch[name][:, e]
        first = int(torch.argmax(logits[e]))
        self.pos[slot] = S0
        self.cur_tok[slot] = first
        self._slot_req[slot] = req_idx
        self._slot_new[slot] = [first]
        self._slot_admitted[slot] = self.stats.steps
        self.stats.admissions += 1
        self.stats.generated += 1
        # max_new = 1, or an eos first token, finishes at admission
        self._maybe_finish(slot)

    def _map_slot_pages(self, slot, req, e, P_len, scratch) -> None:
        """The slot's table row (the prefix's shared pages of its expert
        for the full-prefix span, fresh pages for the rest), pushed, and
        the scratch rows the slot owns scattered into its pages (the shared
        span and the pad tail drop)."""
        S0 = req.prompt.size
        ps = self.page_size
        p_full = self._prefix_full_pages() if P_len else 0
        # one capacity rule: admit_ready gated on the same count
        n_fresh = self._pages_needed(req)
        fresh = self._alloc_pages(n_fresh)
        if fresh is None:
            raise RuntimeError(
                f"page pool exhausted admitting slot {slot}: need {n_fresh}, "
                f"free {len(self._free_pages)}"
            )
        row = np.full(self.max_pages, self.num_pages, np.int32)
        if p_full:
            row[:p_full] = self._prefix_pages_by_e[e]
            self._prefix_slots.add(slot)
        row[p_full:p_full + n_fresh] = fresh
        self._table_np[slot] = row
        self._slot_pages[slot] = fresh
        self._push_table()
        s_len = scratch["k"].shape[2]
        pages_vec = np.full(s_len, self.num_pages, np.int32)
        rows_vec = np.arange(s_len, dtype=np.int32) % ps
        owned = np.arange(p_full * ps, S0)
        pages_vec[owned] = row[owned // ps]
        self._scatter_into_pool(scratch, pages_vec, rows_vec, e)

    def _scatter_into_pool(self, scratch, pages_vec, rows_vec, e) -> None:
        """Scratch copy ``e``'s row i to pool ``(pages_vec[i],
        rows_vec[i])``; rows on the sentinel page drop."""
        keep = np.flatnonzero(pages_vec < self.num_pages)
        pages = torch.from_numpy(pages_vec[keep].astype(np.int64)).to(self.device)
        rows = torch.from_numpy(rows_vec[keep].astype(np.int64)).to(self.device)
        src = torch.from_numpy(keep).to(self.device)
        for name, small in scratch.items():
            self.cache[name][:, pages, rows] = small[:, e, src]

    def _park(self, slot: int) -> None:
        """Free the lane: parked past the cache (writes drop), and paged,
        unmapped before its pages are reused (the parked lane reads
        zeros, not a later tenant's rows) and its pages returned."""
        self._slot_req[slot] = None
        self._slot_new[slot] = []
        self.pos[slot] = self.S_max
        self.cur_tok[slot] = 0
        if self.paged:
            self._table_np[slot] = self.num_pages
            self._push_table()
            self._release_pages(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._prefix_slots.discard(slot)
            self._drain_retired_prefix(slot)

    def _maybe_finish(self, slot: int) -> None:
        req_idx = self._slot_req[slot]
        req = self._requests[req_idx]
        new = self._slot_new[slot]
        by = None
        if self.eos_id is not None and new and new[-1] == self.eos_id:
            by = "eos"
        elif len(new) >= req.max_new:
            by = "max_new"
        if by is None:
            return
        self.completions.append(Completion(
            request_index=req_idx, slot=slot,
            tokens=np.concatenate([req.prompt, np.asarray(new, np.int32)]),
            finished_by=by, admitted_at_step=self._slot_admitted[slot],
            finished_at_step=self.stats.steps,
        ))
        self._park(slot)

    def preempt(self, slot: int, requeue: str = "back") -> int:
        """Preempt slot ``slot`` mid-generation: requeue the request with
        the tokens generated so far folded into its prompt and its budget
        reduced to match, park the lane, and (paged) return its pages.
        Returns the requeued request's index. ``requeue="back"`` gives the
        freed slot to whoever was waiting (head-of-line relief);
        ``"front"`` lets the preempted request reclaim the next slot. No
        token is generated twice: the remnant continues the same greedy
        chain; its K/V rows are re-paid as prefill at re-admission
        (``stats.kv_evicted_tokens``)."""
        if requeue not in ("back", "front"):
            raise ValueError(f"requeue must be 'back' or 'front', got {requeue!r}")
        _, remnant = self.evict(slot)
        new_idx = len(self._requests)
        self._requests.append(remnant)
        if requeue == "front":
            self._queue.appendleft(new_idx)
        else:
            self._queue.append(new_idx)
        return new_idx

    def evict(self, slot: int) -> Tuple[int, Request]:
        """``preempt`` without the requeue: fold the generated tokens into
        the prompt, park the lane, (paged) release its pages, and return
        ``(request_index, remnant)`` to the caller (a cluster's drain moves
        the remnant to another engine)."""
        req_idx = self._slot_req[slot]
        if req_idx is None:
            raise ValueError(f"slot {slot} is idle; nothing to preempt")
        req = self._requests[req_idx]
        new = self._slot_new[slot]
        remaining = req.max_new - len(new)
        assert remaining >= 1  # else _maybe_finish would have retired it
        prompt = np.concatenate([req.prompt, np.asarray(new, np.int32)])
        self.stats.preemptions += 1
        self.stats.kv_evicted_tokens += int(self.pos[slot])
        self._park(slot)
        return req_idx, Request(prompt, max_new=remaining)

    def drop_queue(self) -> List[Tuple[int, Request]]:
        """Empty the queue, returning its ``(request_index, Request)``
        pairs in FIFO order."""
        out = [(idx, self._requests[idx]) for idx in self._queue]
        self._queue.clear()
        return out

    # -- the tick ------------------------------------------------------------

    def step(self) -> int:
        """One ragged decode over all lanes; returns the active-lane count."""
        active = self.active_slots()
        if not active:
            return 0
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.from_numpy(self.cur_tok.copy()).to(self.device),
            torch.from_numpy(self.pos.copy()).to(self.device),
        )
        # the copy to the host waits for the tick's kernels, so a host clock
        # around step() times the tick (serve/cluster.py's watch relies on it)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.stats.steps += 1
        self.stats.lane_ticks_total += self.B
        self.stats.lane_ticks_active += len(active)
        self.stats.generated += len(active)
        for s in active:
            self.pos[s] += 1
            self.cur_tok[s] = nxt[s]
            self._slot_new[s].append(int(nxt[s]))
            self._maybe_finish(s)
        return len(active)

    def run(self) -> List[Completion]:
        """Admit and step until the queue and every slot drain."""
        while True:
            self.admit_ready()
            if self.step() == 0 and not self._queue:
                return self.completions
