"""The serving cluster: N engines behind one submit/pump facade.

The counterpart of the JAX package's ``serve/cluster.py``. One
``ContinuousBatchingEngine`` is a dp = 1 world by design (its batch axis
is the slot axis). The cluster composes engines two ways, behind one API:

- **routed** (``prefill_engines=()``): one engine per dp shard; the
  ``PrefixAffinityRouter`` picks a shard per request (shared-prefix
  affinity first, the least outstanding work weighted by cost otherwise);
- **disaggregated** (``prefill_engines`` non-empty): prompts go to the
  prefill pool as ``max_new=1`` requests (the engine completes
  ``max_new=1`` at admission, so a prefill engine is a pure prefill
  server whose completions surface one pump later) and the remnant
  continues in the decode pool through an explicit ``KVBundle`` handoff
  (the bundle prompt is exactly the ``preempt()`` fold, so no token is
  generated twice; the transfer is priced, not performed).

An optional ``TokenBucket`` sheds load at the door (``submit`` returns
``admitted=False``; the ledger counts rejections, it never loses them),
and an optional SLO-aware watch indicts a decode shard whose median tick
both dominates its peers and breaks the TPOT SLO on its own: the indicted
shard drains its work to the survivors over the same handoff path
(``drain_shard``), so every admitted request completes.

**Elasticity.** With ``elastic=True`` the pools resize themselves
mid-run: when the decode pool is the bottleneck (per-shard decode backlog
at ``resize_backlog`` while the prefill pool has headroom) a prefill shard
is promoted into the decode pool (drain to the survivors, role flip,
prewarm again, no request lost); when the prefill queue backs up instead,
a promoted shard is demoted back. Every transition is counted
(``serve_resizes``), journaled (``serve_pool_history``) and priced (its
drain's handoffs ride the priced bundle path; the prewarm's wall clock
lands inside the measured drain).

**Exoneration.** With ``probation_ticks > 0`` an indicted shard keeps
being probed (a synthetic request a probation window, its decode ticks
timed as the watch times live ones) and is re-admitted once
``observatory.health.exoneration_verdict`` clears it; it re-enters at a
cost weight until the watch sees it fully healthy.

Time is explicit: every mutating call takes ``now_s`` from the caller's
drain clock, so the drive loop and tests replay exact schedules. The
cluster itself never sleeps.

**Several controllers** (``placement``, ``serve/placement.py``). At world
> 1 every rank runs this cluster, each engine on its own group of ranks.
A pump splits in two. The *local work* is done only by the ranks that run
an engine: admission, head-of-line relief, the step and its timing, the
new completions. Then each engine's lead rank contributes one report (the
requests it admitted, the active count, the tick time, the completions,
and the engine's ``EngineView``: outstanding tokens, queue depth,
counters), and one exchange gives every rank every report. The
*decisions* read only that shared view, on every rank, the owner's too:
stamps and ledger, handoffs and routing (``_outstanding``), the watch,
probation and the pools' breathing. A submission moves the view as it
moves the engine's own figures, so the router reads the same loads
between submissions on every rank. Work that a decision hands an engine
(a shard's drain, a promotion's evictions and prewarm, probe ticks) runs
on its ranks, and its result reaches every rank by one more exchange. The
pump's ``now_s`` is rank 0's, which travels in the exchange. A completion travels as the tokens past the prompt its request
was last submitted with, which every rank holds. With every engine on
this rank (world 1) each exchange is the identity.

Not ported: the JAX cluster's fault-injection (``faults.inject``,
``engine.fault_context``) and telemetry (``telemetry.instant``) sites.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ddlb_tpu_torch.models.serving import EngineStats, Request
from ddlb_tpu_torch.observatory.health import exoneration_verdict
from ddlb_tpu_torch.serve.handoff import KVBundle
from ddlb_tpu_torch.serve.router import PrefixAffinityRouter

#: per-shard tick-time window the watch keeps (enough for a stable
#: median, bounded so a long drain cannot grow it without end)
_TICK_WINDOW = 64


@dataclass
class ClusterCompletion:
    """A finished request, in cluster terms: ``request_id`` is the
    cluster-global id ``submit`` returned (stable across pools and
    handoffs), ``shard`` the decode shard that finished it, and
    ``first_s``/``finished_s`` the drain-clock stamps the SLO tracker
    consumes (``first_s`` is taken at the pump that admitted the request:
    the real TTFT, not the completion time)."""

    request_id: int
    tokens: np.ndarray
    finished_by: str
    shard: int
    first_s: float
    finished_s: float
    handoffs: int


@dataclass
class EngineView:
    """What every rank knows of one engine, the figures the cluster's
    decisions read: refreshed from the engine's lead rank at each exchange
    and moved by each submission as the engine's own figures move."""

    outstanding: int = 0        # tokens still to generate, queue and slots
    queue_depth: int = 0
    stats: EngineStats = field(default_factory=EngineStats)

    @classmethod
    def of(cls, engine) -> "EngineView":
        return cls(engine.outstanding_tokens(), engine.queue_depth,
                   dataclasses.replace(engine.stats))


@dataclass
class _Report:
    """One engine's share of a pump, from its lead rank: its view after
    the step, its active lanes, the requests of its active slots when it
    admitted any (their first token is out), the tick's host seconds (an
    active decode tick) and the new completions as ``(gid, tokens past the
    submitted prompt, finished_by)``."""

    view: EngineView
    active: int
    admitted: List[int]
    tick_s: Optional[float]
    done: List[Tuple[int, np.ndarray, str]]


@dataclass
class _ReqState:
    """The host-side ledger entry of one submitted request."""

    gid: int
    prompt_size: int
    max_new: int
    prefix_id: int
    first_s: Optional[float] = None
    handoffs: int = 0
    drained: bool = False


class _Shard:
    """One engine plus the cluster's bookkeeping for it. ``index`` is
    cluster-global and never changes; ``pool`` flips on an elastic
    transition and returns to ``home_pool`` on reset. ``engine`` is the
    engine where this rank runs it (``local``) and its stand-in elsewhere;
    ``alias``, ``done_seen`` and the head-of-line state are kept where it
    runs, the rest on every rank alike."""

    def __init__(self, engine, index: int, pool: str, local: bool = True,
                 lead: bool = True):
        self.engine = engine
        self.index = index          # cluster-global shard index
        self.local = local          # this rank runs the engine
        self.lead = lead            # this rank reports it
        self.view = EngineView()
        self.pool = pool            # "prefill" | "decode" (mutable)
        self.home_pool = pool       # construction-time role
        self.alias: Dict[int, int] = {}   # engine request index -> gid
        self.excluded = False
        self.done_seen = 0          # engine completions consumed
        self.tick_s: List[float] = []     # active-tick host seconds
        self.hol_ticks = 0
        self.last_head: Optional[int] = None
        self.degraded = False       # watch verdict: cost-weighted
        self.probation = False      # excluded but under probe
        self.probe_s: List[float] = []    # current probe window ticks
        self.probe_obs: List[bool] = []   # per-window health verdicts

    def flip(self, pool: str) -> None:
        """Role flip: a fresh tick window and HOL state (the watch must not
        judge a decode shard on its prefill history)."""
        self.pool = pool
        self.tick_s = []
        self.hol_ticks = 0
        self.last_head = None

    def reset(self) -> None:
        self.engine.reset()
        self.alias = {}
        self.excluded = False
        self.done_seen = 0
        self.tick_s = []
        self.hol_ticks = 0
        self.last_head = None
        self.pool = self.home_pool
        self.degraded = False
        self.probation = False
        self.probe_s = []
        self.probe_obs = []


class ServingCluster:
    """See the module docstring. ``decode_engines`` are the routed or
    decode pool (router indices = positions in this list);
    ``prefill_engines`` non-empty selects disaggregated mode.

    ``bundle_bytes(kv_tokens)`` and ``handoff_seconds(payload_bytes)``
    price the KV handoff (``perfmodel.cost.kv_bundle_bytes`` /
    ``kv_handoff_seconds`` in a member; tests pass stubs). ``admission``
    is an optional ``TokenBucket``. ``watch_ticks > 0`` arms the
    indictment watch (it fires only with a finite ``slo_tpot_ms``).

    Elasticity: ``elastic`` arms pool resizing (disaggregated mode only),
    ``resize_backlog`` is the per-shard queued-request pressure that marks
    a pool as the bottleneck, ``resize_cooldown`` the pumps between
    transitions, and ``prewarm(engine)`` an optional hook run on a
    promoted engine before real traffic lands on it. ``probation_ticks >
    0`` arms exoneration (probe window size, in decode ticks);
    ``probe_interval`` is the probe cadence in pumps (probe ticks run
    synchronously in the pump, so probing a hung shard every pump would
    stall the whole cluster). ``tick_floor_s`` is the census's per-tick
    cost estimate, the floor the watch's cost weights are resolved
    against (0 = the live best shard's median alone).

    ``placement`` (``serve.placement.EnginePlacement``) says which ranks
    run each engine, by global index (the decode engines first); the
    engines this rank does not run are passed as stand-ins. None: every
    engine runs here."""

    def __init__(
        self,
        decode_engines: Sequence,
        prefill_engines: Sequence = (),
        *,
        router: Optional[PrefixAffinityRouter] = None,
        admission=None,
        bundle_bytes: Optional[Callable[[int], float]] = None,
        handoff_seconds: Optional[Callable[[float], float]] = None,
        preempt_hol_ticks: int = 0,
        watch_ticks: int = 0,
        watch_dominance: float = 2.0,
        slo_tpot_ms: float = float("inf"),
        elastic: bool = False,
        resize_backlog: int = 8,
        resize_cooldown: int = 64,
        probation_ticks: int = 0,
        probe_interval: int = 1,
        tick_floor_s: float = 0.0,
        prewarm: Optional[Callable] = None,
        placement=None,
    ):
        if not decode_engines:
            raise ValueError("need at least one decode engine")
        self._placement = placement
        #: this rank's pump clock is the one every rank stamps with
        self._keeps_time = placement is None or placement.rank == 0

        def shard(engine, index: int, pool: str) -> _Shard:
            if placement is None:
                return _Shard(engine, index, pool)
            return _Shard(engine, index, pool, placement.is_local(index),
                          placement.leads(index))

        self.shards = [shard(e, i, "decode") for i, e in enumerate(decode_engines)]
        n_dec = len(self.shards)
        self.prefill = [
            shard(e, n_dec + i, "prefill") for i, e in enumerate(prefill_engines)
        ]
        self.disagg = bool(self.prefill)
        #: every shard, by its cluster-global index (the router's index
        #: space; pool membership is the mutable part)
        self._all: List[_Shard] = self.shards + self.prefill
        self.router = router or PrefixAffinityRouter(n_dec)
        if self.router.n_shards != n_dec:
            raise ValueError(
                f"router covers {self.router.n_shards} shards but the "
                f"decode pool has {n_dec}"
            )
        # prefill shards are registered (not routable) so a promotion
        # needs no re-indexing: global indices are router indices
        self.router.grow(len(self._all))
        self.admission = admission
        self._bundle_bytes = bundle_bytes or (lambda kv_tokens: 0.0)
        self._handoff_seconds = handoff_seconds or (lambda b: 0.0)
        self.preempt_hol_ticks = int(preempt_hol_ticks)
        self.watch_ticks = int(watch_ticks)
        self.watch_dominance = float(watch_dominance)
        self.slo_tpot_ms = float(slo_tpot_ms)
        self.elastic = bool(elastic)
        self.resize_backlog = int(resize_backlog)
        self.resize_cooldown = int(resize_cooldown)
        self.probation_ticks = int(probation_ticks)
        self.probe_interval = max(1, int(probe_interval))
        self.tick_floor_s = float(tick_floor_s)
        self._prewarm = prewarm
        self._clear_run_state()
        self._refresh_views()

    # -- the shared view ---------------------------------------------------

    def _share(self, mine: dict, failure: Optional[BaseException] = None) -> dict:
        """Every rank's entries merged, the same dict on every rank (one
        exchange, ``EnginePlacement.share``); ``mine`` itself with every
        engine here."""
        if self._placement is None:
            if failure is not None:
                raise failure
            return mine
        return self._placement.share(mine, failure)

    def _refresh_views(self) -> None:
        """Every shard's view from its lead rank: at construction and after
        a reset, before any pump has reported."""
        mine = {sh.index: EngineView.of(sh.engine) for sh in self._all if sh.lead}
        for index, view in self._share(mine).items():
            self._all[index].view = view

    def _on_owners(self, shards: List[_Shard], work: Callable) -> dict:
        """``work(shard)`` run on the ranks that run each shard's engine,
        each lead's result on every rank by shard index (one exchange); a
        failure on any rank raises on every rank."""
        mine, failure = {}, None
        try:
            for sh in shards:
                if sh.local:
                    result = work(sh)
                    if sh.lead:
                        mine[sh.index] = result
        except Exception as exc:  # raised again on every rank by _share
            failure = exc
        return self._share(mine, failure)

    def _past_prompt(self, gid: int, tokens: np.ndarray) -> np.ndarray:
        """What of ``tokens`` (a request's, which start with the prompt it
        was last submitted with) travels: the rest."""
        return tokens[self._sent[gid].size:]

    def _tokens(self, gid: int, rest: np.ndarray) -> np.ndarray:
        """A request's tokens from what travelled: its submitted prompt,
        then ``rest``."""
        return np.concatenate([self._sent[gid], rest])

    def local_engines(self) -> list:
        """The engines this rank runs, by global index."""
        return [sh.engine for sh in self._all if sh.local]

    # -- lifecycle ---------------------------------------------------------

    def _clear_run_state(self) -> None:
        self._reqs: List[_ReqState] = []
        #: gid -> the prompt it was last submitted with
        self._sent: Dict[int, np.ndarray] = {}
        self.completions: List[ClusterCompletion] = []
        self.rejections: List[int] = []
        self.pool_history: List[str] = []
        self._probe_prompt: Optional[np.ndarray] = None
        self._pump_count = 0
        self._last_resize = -(10 ** 9)
        self.counters: Dict[str, float] = {
            "rejected": 0,
            "handoffs": 0,
            "handoff_bytes": 0.0,
            "handoff_s": 0.0,
            "drained": 0,
            "shards_excluded": 0,
            "resizes": 0,
            "readmitted": 0,
        }

    def reset(self) -> None:
        """A fresh drain on the same engines: every engine resets (shared
        prefixes survive, per the engine's contract), every shard returns
        to its home pool, the router forgets affinities, exclusions and
        cost weights, the admission bucket refills, the ledger clears."""
        for sh in self._all:
            sh.reset()
        self.shards = [sh for sh in self._all if sh.pool == "decode"]
        self.prefill = [sh for sh in self._all if sh.pool == "prefill"]
        self.router = PrefixAffinityRouter(
            len(self._all),
            self.router.imbalance,
            routable=[sh.index for sh in self.shards],
        )
        if self.admission is not None:
            self.admission._level = self.admission.burst_tokens
            self.admission._last_s = 0.0
            self.admission.admitted = 0
            self.admission.rejected = 0
        self._clear_run_state()
        self._refresh_views()

    # -- gauges ------------------------------------------------------------

    def _live(self, pool: List[_Shard]) -> List[_Shard]:
        return [sh for sh in pool if not sh.excluded]

    def queue_depths(self) -> List[int]:
        """Per-decode-shard queued requests (-1 marks an excluded shard).
        An elastic run changes the list's length mid-drain."""
        return [
            -1 if sh.excluded else sh.view.queue_depth
            for sh in self.shards
        ]

    @property
    def queue_depth(self) -> int:
        """Queued requests across every live engine of both pools: the
        saturation gauge the drive loop samples each pump."""
        return sum(
            sh.view.queue_depth
            for sh in self._live(self.prefill) + self._live(self.shards)
        )

    @property
    def accounted(self) -> int:
        """Requests with a final outcome: completed + rejected. The drive
        loop ends when this reaches the trace's length."""
        return len(self.completions) + len(self.rejections)

    def engine_stats(self) -> EngineStats:
        """The engines' counters summed over the cluster (prefill engines
        add admissions and prefix hits but no lane ticks: they never
        decode, so occupancy stays a decode-pool figure)."""
        total = EngineStats()
        for sh in self._all:
            s = sh.view.stats
            total.steps += s.steps
            total.generated += s.generated
            total.admissions += s.admissions
            total.lane_ticks_active += s.lane_ticks_active
            total.lane_ticks_total += s.lane_ticks_total
            total.prefix_hits += s.prefix_hits
            total.prefill_tokens_saved += s.prefill_tokens_saved
            total.preemptions += s.preemptions
            total.kv_evicted_tokens += s.kv_evicted_tokens
            total.pages_capacity += s.pages_capacity
            total.pages_in_use += s.pages_in_use
            total.peak_pages_in_use += s.peak_pages_in_use
            total.admissions_deferred += s.admissions_deferred
        return total

    # -- submission --------------------------------------------------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new: int,
        prefix_id: int = -1,
        now_s: float = 0.0,
    ) -> Tuple[int, bool]:
        """One request at the front door. Returns ``(gid, admitted)``; a
        shed request gets a gid too (the ledger counts rejections) but
        touches no engine."""
        prompt = np.asarray(prompt, np.int32)
        if self._probe_prompt is None:
            # probation probes replay a real admitted prompt (the cluster
            # cannot invent tokens valid for the vocabulary)
            self._probe_prompt = prompt.copy()
        gid = len(self._reqs)
        self._reqs.append(
            _ReqState(
                gid=gid,
                prompt_size=int(prompt.size),
                max_new=int(max_new),
                prefix_id=int(prefix_id),
            )
        )
        if self.admission is not None and not self.admission.try_take(
            float(max_new), now_s
        ):
            self.rejections.append(gid)
            self.counters["rejected"] += 1
            return gid, False
        if self.disagg and self._live(self.prefill):
            # prefill pool: the live prefill engine with the least
            # outstanding work gets a max_new=1 request (pure prefill)
            self._submit_prefill(gid, Request(prompt, max_new=1))
        else:
            # routed, or an elastic cluster whose prefill pool is all
            # promoted for the moment: the decode pool prefills inline
            self._dispatch(gid, Request(prompt, max_new=max_new))
        return gid, True

    def _submit_to(self, sh: _Shard, gid: int, req: Request) -> None:
        """Queue ``req`` for ``gid`` on ``sh``, on every rank: the engine
        (or its stand-in, which checks the same fit) takes it, and the view
        moves as the engine's outstanding tokens and queue do."""
        idx = sh.engine.submit(req)
        sh.alias[idx] = gid
        self._sent[gid] = req.prompt
        sh.view.outstanding += req.max_new
        sh.view.queue_depth += 1

    def _submit_prefill(self, gid: int, req: Request) -> None:
        live = self._live(self.prefill)
        if not live:
            raise RuntimeError("no live prefill shards")
        self._submit_prefill_to(live, gid, req)

    def _dispatch(self, gid: int, req: Request) -> None:
        """Route a fresh (no KV) request into the decode pool."""
        st = self._reqs[gid]
        out = self._outstanding()
        s = self.router.route(st.prefix_id, out)
        self._submit_to(self._all[s], gid, req)

    def _outstanding(self) -> List[float]:
        """Tokens still to generate per shard, by global shard index."""
        return [float(sh.view.outstanding) for sh in self._all]

    # -- the pump ----------------------------------------------------------

    def pump(self, now_s: float) -> int:
        """One cluster tick: admit on every live engine, stamp first
        tokens, relieve head-of-line blocking, step every live engine
        (timing decode ticks for the watch), collect completions (prefill
        completions become handoffs), let the watch act, advance
        probations, then let the pools breathe. Returns the active-lane
        count (0 with empty queues = idle). The engines' work is this
        rank's local work; one exchange then gives every rank the reports
        (and the keeper's ``now_s``) that every decision reads."""
        self._pump_count += 1
        live_pre = self._live(self.prefill)
        live_dec = self._live(self.shards)
        mine, failure = {}, None
        try:
            self._local_pump(live_pre, live_dec, mine)
        except Exception as exc:  # raised again on every rank by _share
            failure = exc
        if self._keeps_time:
            mine["now_s"] = now_s
        reports = self._share(mine, failure)
        now_s = reports["now_s"]
        total_active = 0
        for sh in live_pre + live_dec:
            rep = reports[sh.index]
            sh.view = rep.view
            total_active += rep.active
        # routed decode admissions stamp TTFT (the admission's prefill
        # computed the request's first token); the watch's tick window
        for sh in live_dec:
            rep = reports[sh.index]
            for gid in rep.admitted:
                self._stamp_first(gid, now_s)
            if rep.tick_s is not None:
                sh.tick_s.append(rep.tick_s)
                del sh.tick_s[:-_TICK_WINDOW]
        # completions (prefill first, so a bundle can reach a decode queue
        # in the pump that produced it)
        for sh in live_pre:
            for gid, rest, finished_by in reports[sh.index].done:
                st = self._reqs[gid]
                tokens = self._tokens(gid, rest)
                self._stamp_first(gid, now_s)
                generated = int(tokens.size) - st.prompt_size
                remaining = st.max_new - generated
                if remaining <= 0:
                    # a max_new=1 request: the prefill was the whole job
                    self._finalize(gid, tokens, finished_by, sh.index, now_s)
                else:
                    self._handoff(
                        KVBundle(
                            request_id=gid,
                            tokens=tokens,
                            generated=generated,
                            remaining=remaining,
                            prefix_id=st.prefix_id,
                            kv_tokens=int(tokens.size),
                            payload_bytes=float(self._bundle_bytes(int(tokens.size))),
                            produced_s=now_s,
                        ),
                        now_s,
                    )
        for sh in live_dec:
            for gid, rest, finished_by in reports[sh.index].done:
                self._stamp_first(gid, now_s)
                self._finalize(gid, self._tokens(gid, rest), finished_by, sh.index, now_s)
        # the indictment watch (and cost-weight re-resolution)
        self._watch(now_s)
        # probation: probe excluded shards toward exoneration
        total_active += self._probe(now_s)
        # elastic pool resizing
        self._breathe(now_s)
        return total_active

    def _local_pump(self, live_pre: List[_Shard], live_dec: List[_Shard],
                    reports: dict) -> None:
        """This rank's part of a pump on the live engines it runs:
        admissions, head-of-line relief, the step (decode ticks timed), the
        new completions; then a ``_Report`` into ``reports`` for each
        engine it leads."""
        pre = [sh for sh in live_pre if sh.local]
        dec = [sh for sh in live_dec if sh.local]
        admitted: Dict[int, List[int]] = {}
        for sh in pre:
            sh.engine.admit_ready()
        for sh in dec:
            n = sh.engine.admit_ready()
            admitted[sh.index] = [
                sh.alias[sh.engine.slot_request(slot)]
                for slot in sh.engine.active_slots()
            ] if n else []
            # head-of-line relief, per shard: a head stuck while nothing
            # was admitted accrues ticks; relief preempts the active slot
            # with the most budget left
            if self.preempt_hol_ticks > 0:
                head = sh.engine.queue_head()
                if head is None or n:
                    sh.hol_ticks = 0
                elif head == sh.last_head:
                    sh.hol_ticks += 1
                else:
                    sh.hol_ticks = 1
                sh.last_head = head
                if sh.hol_ticks >= self.preempt_hol_ticks:
                    self._relieve_head(sh)
                    sh.hol_ticks = 0
        # step every live engine, timing decode ticks for the watch. The
        # host clock around step() covers the tick's work on the card only
        # because step() copies the next tokens to the host (models/
        # serving.py), which waits for the tick's kernels: the watch's
        # medians depend on that copy staying inside step()
        active: Dict[int, int] = {}
        ticks: Dict[int, float] = {}
        for sh in pre:
            active[sh.index] = sh.engine.step()
        for sh in dec:
            t0 = time.perf_counter()
            active[sh.index] = sh.engine.step()
            if active[sh.index]:
                ticks[sh.index] = time.perf_counter() - t0
        for sh in pre + dec:
            done = []
            for c in sh.engine.completions[sh.done_seen:]:
                gid = sh.alias[c.request_index]
                done.append((gid, self._past_prompt(gid, c.tokens), c.finished_by))
            sh.done_seen = len(sh.engine.completions)
            if sh.lead:
                reports[sh.index] = _Report(
                    EngineView.of(sh.engine), active[sh.index],
                    admitted.get(sh.index, []), ticks.get(sh.index), done,
                )

    def _stamp_first(self, gid: int, now_s: float) -> None:
        st = self._reqs[gid]
        if st.first_s is None:
            st.first_s = now_s

    def _finalize(self, gid: int, tokens: np.ndarray, finished_by: str,
                  shard: int, now_s: float) -> None:
        st = self._reqs[gid]
        self.completions.append(
            ClusterCompletion(
                request_id=gid,
                tokens=tokens,
                finished_by=finished_by,
                shard=shard,
                first_s=st.first_s if st.first_s is not None else now_s,
                finished_s=now_s,
                handoffs=st.handoffs,
            )
        )

    def _relieve_head(self, sh: _Shard) -> None:
        """Preempt the active slot with the most budget left so the stuck
        head can admit (the remnant requeues on the same engine: a
        ``preempt``, not a handoff)."""
        slots = sh.engine.active_slots()
        if not slots:
            return
        victim = max(slots, key=lambda s: sh.engine.remaining_budget(s))
        if sh.engine.remaining_budget(victim) <= 1:
            return  # nothing worth evicting
        old_idx = sh.engine.slot_request(victim)
        new_idx = sh.engine.preempt(victim, requeue="back")
        sh.alias[new_idx] = sh.alias[old_idx]

    # -- the handoff -------------------------------------------------------

    def _handoff(self, bundle: KVBundle, now_s: float) -> None:
        """Move one in-flight request into the decode pool: price the
        bundle, route by its surviving affinity, and resume it as
        ``Request(bundle.tokens, max_new=remaining)``: exactly the
        ``preempt()`` fold, so the consumer re-prefills to an identical
        greedy chain."""
        st = self._reqs[bundle.request_id]
        out = self._outstanding()
        target = self.router.route(bundle.prefix_id, out)
        priced = float(self._handoff_seconds(bundle.payload_bytes))
        self.counters["handoffs"] += 1
        self.counters["handoff_bytes"] += bundle.payload_bytes
        self.counters["handoff_s"] += priced
        st.handoffs += 1
        self._submit_to(
            self._all[target], bundle.request_id,
            Request(bundle.tokens, max_new=bundle.remaining),
        )

    # -- degradation -------------------------------------------------------

    def _cost_ref_s(self, best_median: float) -> float:
        """The reference a shard's tick median is judged against: the
        census's per-tick estimate when the caller gave one, floored by
        the live best shard's median (the estimate is a lower bound; the
        healthiest peer is reality)."""
        return max(float(best_median), self.tick_floor_s)

    def _watch(self, now_s: float) -> None:
        """SLO-aware straggler verdicts over the decode shards, two tiers:

        - **cost-weighted** (degraded but live): a shard whose median tick
          dominates the reference by ``watch_dominance`` but stays inside
          the TPOT SLO keeps serving at a raised router weight
          (``median / reference``); the weight re-resolves whenever this
          verdict flips;
        - **indicted**: dominance and an SLO breach of its own: the shard
          drains to the survivors (``drain_shard``) and, with probation
          armed, starts earning exoneration."""
        if self.watch_ticks <= 0:
            return
        live = self._live(self.shards)
        if len(live) < 2:
            return  # never drain the last shard
        if any(len(sh.tick_s) < self.watch_ticks for sh in live):
            return
        meds = {sh.index: statistics.median(sh.tick_s) for sh in live}
        worst = max(live, key=lambda sh: meds[sh.index])
        best = min(live, key=lambda sh: meds[sh.index])
        w, b = meds[worst.index], meds[best.index]
        ref = self._cost_ref_s(b)
        # tier 1: re-resolve cost weights on verdict flips
        for sh in live:
            m = meds[sh.index]
            degraded = m > self.watch_dominance * ref
            if degraded != sh.degraded:
                sh.degraded = degraded
                weight = max(1.0, m / ref) if degraded else 1.0
                self.router.set_weight(sh.index, weight)
        # tier 2: indict only when the SLO itself is broken
        if w <= self.watch_dominance * b:
            return
        if w * 1000.0 <= self.slo_tpot_ms:
            return
        self.drain_shard(worst.index, now_s)

    def drain_shard(self, shard: int, now_s: float) -> None:
        """Exclude decode shard ``shard`` (cluster-global index) and move
        its work to the survivors: active slots evict into ``KVBundle``s
        (the drain is a handoff: priced, counted, the greedy chain kept),
        queued requests re-route as fresh submissions (no KV exists yet).
        The engine stays (its stats still add up); with probation armed it
        keeps serving probes toward exoneration. Needs at least one
        surviving decode shard. At world > 1 every rank calls it at the
        same point."""
        sh = self._all[shard]
        if sh.excluded:
            return
        if sh.pool != "decode":
            raise ValueError(f"shard {shard} is not in the decode pool")
        survivors = [
            s for s in self._live(self.shards) if s.index != shard
        ]
        if not survivors:
            raise RuntimeError(
                "cannot drain the last live decode shard"
            )
        sh.excluded = True
        self.counters["shards_excluded"] += 1
        # router first: the re-routes below must not land on this shard
        self.router.drop_shard(shard)
        self._migrate_decode_work(sh, now_s)
        if self.probation_ticks > 0 and self._probe_prompt is not None:
            sh.probation = True
            sh.probe_s = []
            sh.probe_obs = []

    def _take_out(self, sh: _Shard, prewarm: bool = False):
        """Everything off ``sh``'s engine, where it runs: its active slots
        evicted and its queue dropped, each request as ``(gid, tokens past
        its submitted prompt, budget left)``; with ``prewarm`` the
        promotion's prewarm hook after. Returns (evicted, queued, the
        engine's view)."""
        engine = sh.engine
        evicted = []
        for slot in list(engine.active_slots()):
            idx, remnant = engine.evict(slot)
            gid = sh.alias[idx]
            evicted.append((gid, self._past_prompt(gid, remnant.prompt), remnant.max_new))
        queued = []
        for idx, req in engine.drop_queue():
            gid = sh.alias[idx]
            queued.append((gid, self._past_prompt(gid, req.prompt), req.max_new))
        if prewarm:
            if self._prewarm is not None:
                self._prewarm(engine)
            # the prewarm's own completions are not cluster traffic
            sh.done_seen = len(engine.completions)
        return evicted, queued, EngineView.of(engine)

    def _migrate_decode_work(self, sh: _Shard, now_s: float) -> None:
        """Move everything off a decode shard: active slots evict into
        priced handoffs, the queue re-dispatches (shared by indictment
        drains and elastic demotions)."""
        evicted, queued, sh.view = self._on_owners([sh], self._take_out)[sh.index]
        for gid, rest, remaining in evicted:
            st = self._reqs[gid]
            tokens = self._tokens(gid, rest)
            st.drained = True
            self.counters["drained"] += 1
            self._handoff(
                KVBundle(
                    request_id=gid,
                    tokens=tokens,
                    generated=int(tokens.size) - st.prompt_size,
                    remaining=remaining,
                    prefix_id=st.prefix_id,
                    kv_tokens=int(tokens.size),
                    payload_bytes=float(self._bundle_bytes(int(tokens.size))),
                    produced_s=now_s,
                ),
                now_s,
            )
        for gid, rest, max_new in queued:
            self._reqs[gid].drained = True
            self.counters["drained"] += 1
            self._dispatch(gid, Request(self._tokens(gid, rest), max_new=max_new))

    # -- probation / exoneration -------------------------------------------

    def _probe(self, now_s: float) -> int:
        """Step every excluded shard under probation on a synthetic probe
        request, timing its decode ticks as the watch times live ones.
        Each completed probe closes one probation window, judged by the
        indictment test in reverse (median inside both the dominance bar
        and the TPOT SLO); ``exoneration_verdict`` decides re-admission
        over the windows. Probe completions never reach the ledger. The
        probe ticks run where the shard's engine runs; their times reach
        every rank by one exchange."""
        probing = [
            sh for sh in self.shards if sh.excluded and sh.probation
        ]
        if not probing:
            return 0
        if self._pump_count % self.probe_interval != 0:
            # probes run synchronously in the pump: a probe tick on a hung
            # shard stalls every live lane, so probation keeps a cadence
            return 0
        live_meds = [
            statistics.median(sh.tick_s)
            for sh in self._live(self.shards)
            if len(sh.tick_s) >= self.watch_ticks
        ]
        ref = self._cost_ref_s(min(live_meds) if live_meds else 0.0)
        probed = self._on_owners(probing, self._probe_tick)
        active_total = 0
        for sh in probing:
            active, tick_s, closed, sh.view = probed[sh.index]
            if tick_s is not None:
                sh.probe_s.append(tick_s)
            active_total += active
            if closed:
                # one probe window closed: its verdict, maybe exoneration
                window = sh.probe_s
                sh.probe_s = []
                if not window:
                    continue
                med = statistics.median(window)
                healthy = (
                    med <= self.watch_dominance * ref if ref > 0.0 else True
                ) and med * 1000.0 <= self.slo_tpot_ms
                sh.probe_obs.append(healthy)
                if exoneration_verdict(sh.probe_obs):
                    self._exonerate(sh, med, ref, now_s)
        return active_total

    def _probe_tick(self, sh: _Shard):
        """One probe tick on ``sh``'s engine, where it runs: (active lanes,
        the tick's host seconds or None, whether a probe completed, the
        engine's view)."""
        eng = sh.engine
        if not eng.active_slots() and eng.queue_depth == 0:
            eng.submit(
                Request(
                    self._probe_prompt,
                    max_new=max(1, self.probation_ticks),
                )
            )
        eng.admit_ready()
        t0 = time.perf_counter()
        active = eng.step()
        tick_s = time.perf_counter() - t0 if active else None
        closed = len(eng.completions) > sh.done_seen
        sh.done_seen = len(eng.completions)
        return active, tick_s, closed, EngineView.of(eng)

    def _exonerate(
        self, sh: _Shard, median_s: float, ref_s: float, now_s: float
    ) -> None:
        """Re-admit an excluded shard that survived probation, at a cost
        weight resolved from its probe medians."""
        sh.excluded = False
        sh.probation = False
        sh.probe_s = []
        sh.probe_obs = []
        sh.tick_s = []
        weight = max(1.0, median_s / ref_s) if ref_s > 0.0 else 1.0
        sh.degraded = weight > 1.0
        self.router.readmit_shard(sh.index, weight)
        self.counters["readmitted"] += 1
        self.pool_history.append(
            f"exonerate:{sh.index}@{self._pump_count}"
        )

    # -- elasticity --------------------------------------------------------

    def _breathe(self, now_s: float) -> None:
        """The pool-resize controller: compare the per-shard backlog of
        the two pools (decode backlog inflates time between tokens,
        prefill backlog inflates TTFT) and move one shard a cooldown
        window toward the bottleneck."""
        if not self.elastic or not self.disagg:
            return
        if self._pump_count - self._last_resize < self.resize_cooldown:
            return
        live_pre = self._live(self.prefill)
        live_dec = self._live(self.shards)
        if not live_dec:
            return
        dec_backlog = sum(sh.view.queue_depth for sh in live_dec) / len(
            live_dec
        )
        pre_backlog = (
            sum(sh.view.queue_depth for sh in live_pre) / len(live_pre)
            if live_pre
            else 0.0
        )
        if (
            dec_backlog >= self.resize_backlog
            and pre_backlog < self.resize_backlog
            and len(live_pre) >= 2
        ):
            self._promote(live_pre)
        elif (
            pre_backlog >= self.resize_backlog
            and dec_backlog < self.resize_backlog
            and len(live_dec) >= 2
        ):
            self._demote(live_dec, now_s)

    def _resize_event(self, action: str, sh: _Shard) -> None:
        self.counters["resizes"] += 1
        self._last_resize = self._pump_count
        self.pool_history.append(
            f"{action}:{sh.index}@{self._pump_count}"
        )

    def _promote(self, live_pre: List[_Shard]) -> None:
        """Prefill shard -> decode pool, as drain to the survivors, role
        flip, prewarm, no request lost: its prefill work moves to the
        surviving prefill shards first (``max_new=1`` remnants carry no
        decode KV worth pricing: they re-enter as fresh prefill
        submissions), then the engine's decode step is prewarmed (the
        hook's wall clock lands inside the measured drain), then the
        router admits the shard at nominal weight."""
        sh = min(live_pre, key=lambda s: (s.view.outstanding, s.index))
        survivors = [s for s in live_pre if s.index != sh.index]
        evicted, queued, sh.view = self._on_owners(
            [sh], lambda s: self._take_out(s, prewarm=True)
        )[sh.index]
        for gid, rest, budget in evicted + queued:
            self._reqs[gid].drained = True
            self.counters["drained"] += 1
            self._submit_prefill_to(
                survivors, gid, Request(self._tokens(gid, rest), max_new=budget)
            )
        self.prefill.remove(sh)
        sh.flip("decode")
        self.shards.append(sh)
        self.shards.sort(key=lambda s: s.index)
        self.router.add_shard(sh.index)
        self._resize_event("promote", sh)

    def _submit_prefill_to(
        self, survivors: List[_Shard], gid: int, req: Request
    ) -> None:
        sh = min(survivors, key=lambda s: (s.view.outstanding, s.index))
        self._submit_to(sh, gid, req)

    def _demote(self, live_dec: List[_Shard], now_s: float) -> None:
        """Promoted shard -> back to the prefill pool (only shards whose
        home pool is prefill demote: the constructed decode pool never
        shrinks). Its decode work drains to the surviving decode shards
        over the priced handoff path, then it resumes prefill duty."""
        returnable = [
            s
            for s in live_dec
            if s.home_pool == "prefill" and not s.excluded
        ]
        if not returnable or len(live_dec) < 2:
            return
        sh = min(returnable, key=lambda s: (s.view.outstanding, s.index))
        # router first: the drain's handoffs must not land back on it
        self.router.remove_shard(sh.index)
        self.shards.remove(sh)
        self._migrate_decode_work(sh, now_s)
        sh.flip("prefill")
        self.prefill.append(sh)
        self.prefill.sort(key=lambda s: s.index)
        self._resize_event("demote", sh)
