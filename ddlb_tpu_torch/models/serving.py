"""Continuous-batching serving engine: slot-level admission over the ragged
decode step.

The port of the JAX package's ``models/serving.py``, as far as
``phase=serve`` drives it. ``max_batch`` slots share one KV cache (one
per rank, over this rank's tp heads). A request is admitted into a free
slot by a prefill of ``tp`` copies of its prompt (so the MoE block
router's ``b % tp`` holds) into a small contiguous scratch cache; the
copy the router gives the slot's expert, ``e(slot) = slot // (B / tp)``,
is the one whose rows and logits are kept. Prompts are padded to
power-of-two buckets of at least 16 (bucketed prefill, read at the
prompt's last row). Every tick runs ONE ragged decode over all lanes: an
active slot at its own position, an idle slot parked at ``pos =
max_len``, where its write drops and its output is ignored. A slot frees
at ``max_new`` tokens.

``cache_layout='paged'``: the big cache is a shared page pool with a
per-slot page table (``decode.init_paged_cache``): an admission takes
``ceil((prompt + max_new) / page_size)`` pages off a host free list and
scatters its scratch rows into them; a completion unmaps its table row
(the parked lane reads zeros) and returns its pages. The queue is FIFO:
a head request that does not fit defers (``admissions_deferred``).

The engine's mesh has dp = 1; every tp rank runs its own engine on the
same workload, and the schedule stays identical on every rank because
the logits after the tp collectives are.

Not ported: the shared prefix (``set_shared_prefix``, its pages and the
chunked suffix prefill), ``preempt``, ``evict``, ``drop_queue``, the
``eos_id`` stop and unbucketed prefill (no caller sets them), and the
fault-injection and telemetry sites.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ddlb_tpu_torch.models.decode import (
    init_cache,
    init_paged_cache,
    make_decode_fn,
    make_prefill_fn,
)
from ddlb_tpu_torch.models.transformer import TransformerConfig


@dataclass
class Request:
    """One generation request; ``max_new`` caps the generated tokens."""

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
    """A finished request: prompt + generated tokens, the slot it ran in."""

    request_index: int
    slot: int
    tokens: np.ndarray
    finished_by: str            # "max_new" (the only stop ported)
    admitted_at_step: int
    finished_at_step: int


@dataclass
class EngineStats:
    """Counters of one drain: scheduling health and page-pool pressure."""

    steps: int = 0              # ragged decode ticks
    generated: int = 0          # tokens emitted (incl. each admission's first)
    admissions: int = 0
    lane_ticks_active: int = 0
    lane_ticks_total: int = 0
    prefix_hits: int = 0        # stays 0: the shared prefix is not ported
    pages_capacity: int = 0
    pages_in_use: int = 0
    peak_pages_in_use: int = 0
    admissions_deferred: int = 0

    @property
    def occupancy(self) -> float:
        """Share of decode-lane capacity that did useful work."""
        if self.lane_ticks_total == 0:
            return 0.0
        return self.lane_ticks_active / self.lane_ticks_total


class ContinuousBatchingEngine:
    """Greedy continuous-batching engine over one ``(1, tp)`` mesh.

    ``submit()`` requests, then ``run()`` to drain; or ``admit_ready()`` +
    ``step()`` by hand. ``params`` are this rank's (``shard_params``); the
    caches live on their device.
    """

    def __init__(self, mesh, cfg: TransformerConfig, params, max_batch: int,
                 max_len: int, num_pages: Optional[int] = None):
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
        self.paged = cfg.cache_layout == "paged"
        # prefills run on small contiguous scratch caches, paged or not
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
        self._decode = make_decode_fn(mesh, cfg, ragged=True)
        self._prefill = make_prefill_fn(mesh, self._scratch_cfg, dynamic_last=True)
        self.reset()

    def reset(self) -> None:
        """A fresh cache, every lane parked, queues and stats cleared."""
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

    # -- scheduling ------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Queue a request; returns its index. A request that could never
        fit fails here, not mid-drain."""
        S0 = request.prompt.size
        if S0 + request.max_new > self.S_max:
            raise ValueError(
                f"prompt {S0} + max_new {request.max_new} exceeds "
                f"max_len {self.S_max}"
            )
        if self.paged and self._pages_needed(request) > self.num_pages:
            raise ValueError(
                f"request needs up to {self._pages_needed(request)} pages but "
                f"the pool has {self.num_pages}"
            )
        idx = len(self._requests)
        self._requests.append(request)
        self._queue.append(idx)
        return idx

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

    def _pages_needed(self, req: Request) -> int:
        """Pages for prompt + every generated token, taken at admission."""
        return -(-(req.prompt.size + req.max_new) // self.page_size)

    def admit_ready(self) -> int:
        """Admit queued requests into free slots (FIFO; a paged head
        request that does not fit defers); returns the count admitted."""
        n = 0
        for slot in range(self.B):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            if self.paged:
                head = self._requests[self._queue[0]]
                if self._pages_needed(head) > len(self._free_pages):
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

    def _expert_of(self, slot: int) -> int:
        # the block router's slot-stable assignment on a dp = 1 shard
        return slot // (self.B // self.tp)

    def _admit(self, slot: int, req_idx: int) -> None:
        req = self._requests[req_idx]
        S0 = req.prompt.size
        e = self._expert_of(slot)
        s_pad = min(self._bucket(S0), self.S_max)
        scratch = init_cache(
            self._scratch_cfg, self.tp, s_pad, mesh=self.mesh, device=self.device
        )
        prompt_np = np.zeros((self.tp, s_pad), np.int32)
        prompt_np[:, :S0] = req.prompt
        prompt = torch.from_numpy(prompt_np).to(self.device)
        logits, scratch = self._prefill(self.params, scratch, prompt, S0 - 1)
        if self.paged:
            self._map_slot_pages(slot, req, e, scratch)
        else:
            # rows [0, s_pad) of copy e into the slot; the pad tail lies
            # past pos and is overwritten by the decode before any read
            for name, big in self.cache.items():
                big[:, slot, :s_pad] = scratch[name][:, e]
        first = int(torch.argmax(logits[e]))
        self.pos[slot] = S0
        self.cur_tok[slot] = first
        self._slot_req[slot] = req_idx
        self._slot_new[slot] = [first]
        self._slot_admitted[slot] = self.stats.steps
        self.stats.admissions += 1
        self.stats.generated += 1
        self._maybe_finish(slot)

    def _map_slot_pages(self, slot, req, e, scratch) -> None:
        """Give the slot fresh pages, push its table row, and scatter the
        scratch rows it owns into them (the pad tail drops)."""
        S0 = req.prompt.size
        n = self._pages_needed(req)
        fresh = self._alloc_pages(n)
        if fresh is None:
            raise RuntimeError(
                f"page pool exhausted admitting slot {slot}: need {n}, "
                f"free {len(self._free_pages)}"
            )
        row = np.full(self.max_pages, self.num_pages, np.int32)
        row[:n] = fresh
        self._table_np[slot] = row
        self._slot_pages[slot] = fresh
        self._push_table()
        owned = np.arange(S0)
        pages = torch.from_numpy(row[owned // self.page_size].astype(np.int64)).to(self.device)
        rows = torch.from_numpy(owned % self.page_size).to(self.device)
        for name, small in scratch.items():
            self.cache[name][:, pages, rows] = small[:, e, :S0]

    def _maybe_finish(self, slot: int) -> None:
        req_idx = self._slot_req[slot]
        req = self._requests[req_idx]
        new = self._slot_new[slot]
        if len(new) < req.max_new:
            return
        self.completions.append(Completion(
            request_index=req_idx, slot=slot,
            tokens=np.concatenate([req.prompt, np.asarray(new, np.int32)]),
            finished_by="max_new", admitted_at_step=self._slot_admitted[slot],
            finished_at_step=self.stats.steps,
        ))
        self._slot_req[slot] = None
        self._slot_new[slot] = []
        self.pos[slot] = self.S_max          # park: writes drop, lane idles
        self.cur_tok[slot] = 0
        if self.paged:
            # unmap before the pages are reused: the parked lane reads zeros
            self._table_np[slot] = self.num_pages
            self._push_table()
            self._release_pages(self._slot_pages[slot])
            self._slot_pages[slot] = []

    # -- the tick ------------------------------------------------------------

    def step(self) -> int:
        """One ragged decode over all lanes; returns the active-lane count."""
        active = [s for s in range(self.B) if self._slot_req[s] is not None]
        if not active:
            return 0
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.from_numpy(self.cur_tok.copy()).to(self.device),
            torch.from_numpy(self.pos.copy()).to(self.device),
        )
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
