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

Not ported: the JAX cluster's fault-injection (``faults.inject``,
``engine.fault_context``) and telemetry (``telemetry.instant``) sites.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
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
    transition and returns to ``home_pool`` on reset."""

    def __init__(self, engine, index: int, pool: str):
        self.engine = engine
        self.index = index          # cluster-global shard index
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
    against (0 = the live best shard's median alone)."""

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
    ):
        if not decode_engines:
            raise ValueError("need at least one decode engine")
        self.shards = [
            _Shard(e, i, "decode") for i, e in enumerate(decode_engines)
        ]
        n_dec = len(self.shards)
        self.prefill = [
            _Shard(e, n_dec + i, "prefill")
            for i, e in enumerate(prefill_engines)
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

    # -- lifecycle ---------------------------------------------------------

    def _clear_run_state(self) -> None:
        self._reqs: List[_ReqState] = []
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

    # -- gauges ------------------------------------------------------------

    def _live(self, pool: List[_Shard]) -> List[_Shard]:
        return [sh for sh in pool if not sh.excluded]

    def queue_depths(self) -> List[int]:
        """Per-decode-shard queued requests (-1 marks an excluded shard).
        An elastic run changes the list's length mid-drain."""
        return [
            -1 if sh.excluded else sh.engine.queue_depth
            for sh in self.shards
        ]

    @property
    def queue_depth(self) -> int:
        """Queued requests across every live engine of both pools: the
        saturation gauge the drive loop samples each pump."""
        return sum(
            sh.engine.queue_depth
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
            s = sh.engine.stats
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

    def _submit_prefill(self, gid: int, req: Request) -> None:
        live = self._live(self.prefill)
        if not live:
            raise RuntimeError("no live prefill shards")
        sh = min(
            live, key=lambda s: (s.engine.outstanding_tokens(), s.index)
        )
        idx = sh.engine.submit(req)
        sh.alias[idx] = gid

    def _dispatch(self, gid: int, req: Request) -> None:
        """Route a fresh (no KV) request into the decode pool."""
        st = self._reqs[gid]
        out = self._outstanding()
        s = self.router.route(st.prefix_id, out)
        sh = self._all[s]
        idx = sh.engine.submit(req)
        sh.alias[idx] = gid

    def _outstanding(self) -> List[float]:
        """Tokens still to generate per shard, by global shard index."""
        return [
            float(sh.engine.outstanding_tokens()) for sh in self._all
        ]

    # -- the pump ----------------------------------------------------------

    def pump(self, now_s: float) -> int:
        """One cluster tick: admit on every live engine, stamp first
        tokens, relieve head-of-line blocking, step every live engine
        (timing decode ticks for the watch), collect completions (prefill
        completions become handoffs), let the watch act, advance
        probations, then let the pools breathe. Returns the active-lane
        count (0 with empty queues = idle)."""
        self._pump_count += 1
        live_pre = self._live(self.prefill)
        live_dec = self._live(self.shards)
        # 1. admissions; routed decode admissions stamp TTFT here (the
        # admission's prefill computed the request's first token)
        for sh in live_pre:
            sh.engine.admit_ready()
        for sh in live_dec:
            admitted = sh.engine.admit_ready()
            if admitted:
                for slot in sh.engine.active_slots():
                    gid = sh.alias[sh.engine.slot_request(slot)]
                    self._stamp_first(gid, now_s)
            # head-of-line relief, per shard: a head stuck while nothing
            # was admitted accrues ticks; relief preempts the active slot
            # with the most budget left
            if self.preempt_hol_ticks > 0:
                head = sh.engine.queue_head()
                if head is None or admitted:
                    sh.hol_ticks = 0
                elif head == sh.last_head:
                    sh.hol_ticks += 1
                else:
                    sh.hol_ticks = 1
                sh.last_head = head
                if sh.hol_ticks >= self.preempt_hol_ticks:
                    self._relieve_head(sh)
                    sh.hol_ticks = 0
        # 2. step every live engine, timing decode ticks for the watch. The
        # host clock around step() covers the tick's work on the card only
        # because step() copies the next tokens to the host (models/
        # serving.py), which waits for the tick's kernels: the watch's
        # medians depend on that copy staying inside step()
        total_active = 0
        for sh in live_pre:
            total_active += sh.engine.step()
        for sh in live_dec:
            t0 = time.perf_counter()
            active = sh.engine.step()
            if active:
                sh.tick_s.append(time.perf_counter() - t0)
                del sh.tick_s[:-_TICK_WINDOW]
            total_active += active
        # 3. collect completions (prefill first, so a bundle can reach a
        # decode queue in the pump that produced it)
        for sh in live_pre:
            for c in sh.engine.completions[sh.done_seen:]:
                gid = sh.alias[c.request_index]
                st = self._reqs[gid]
                self._stamp_first(gid, now_s)
                generated = int(c.tokens.size) - st.prompt_size
                remaining = st.max_new - generated
                if remaining <= 0:
                    # a max_new=1 request: the prefill was the whole job
                    self._finalize(gid, c, sh.index, now_s)
                else:
                    self._handoff(
                        KVBundle(
                            request_id=gid,
                            tokens=c.tokens,
                            generated=generated,
                            remaining=remaining,
                            prefix_id=st.prefix_id,
                            kv_tokens=int(c.tokens.size),
                            payload_bytes=float(
                                self._bundle_bytes(int(c.tokens.size))
                            ),
                            produced_s=now_s,
                        ),
                        now_s,
                    )
            sh.done_seen = len(sh.engine.completions)
        for sh in live_dec:
            for c in sh.engine.completions[sh.done_seen:]:
                gid = sh.alias[c.request_index]
                self._stamp_first(gid, now_s)
                self._finalize(gid, c, sh.index, now_s)
            sh.done_seen = len(sh.engine.completions)
        # 4. the indictment watch (and cost-weight re-resolution)
        self._watch(now_s)
        # 5. probation: probe excluded shards toward exoneration
        total_active += self._probe(now_s)
        # 6. elastic pool resizing
        self._breathe(now_s)
        return total_active

    def _stamp_first(self, gid: int, now_s: float) -> None:
        st = self._reqs[gid]
        if st.first_s is None:
            st.first_s = now_s

    def _finalize(self, gid: int, c, shard: int, now_s: float) -> None:
        st = self._reqs[gid]
        self.completions.append(
            ClusterCompletion(
                request_id=gid,
                tokens=c.tokens,
                finished_by=c.finished_by,
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
        sh = self._all[target]
        idx = sh.engine.submit(
            Request(bundle.tokens, max_new=bundle.remaining)
        )
        sh.alias[idx] = bundle.request_id

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
        surviving decode shard."""
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

    def _migrate_decode_work(self, sh: _Shard, now_s: float) -> None:
        """Move everything off a decode shard: active slots evict into
        priced handoffs, the queue re-dispatches (shared by indictment
        drains and elastic demotions)."""
        for slot in list(sh.engine.active_slots()):
            idx, remnant = sh.engine.evict(slot)
            gid = sh.alias[idx]
            st = self._reqs[gid]
            st.drained = True
            self.counters["drained"] += 1
            self._handoff(
                KVBundle(
                    request_id=gid,
                    tokens=remnant.prompt,
                    generated=int(remnant.prompt.size) - st.prompt_size,
                    remaining=remnant.max_new,
                    prefix_id=st.prefix_id,
                    kv_tokens=int(remnant.prompt.size),
                    payload_bytes=float(
                        self._bundle_bytes(int(remnant.prompt.size))
                    ),
                    produced_s=now_s,
                ),
                now_s,
            )
        for idx, req in sh.engine.drop_queue():
            gid = sh.alias[idx]
            self._reqs[gid].drained = True
            self.counters["drained"] += 1
            self._dispatch(gid, req)

    # -- probation / exoneration -------------------------------------------

    def _probe(self, now_s: float) -> int:
        """Step every excluded shard under probation on a synthetic probe
        request, timing its decode ticks as the watch times live ones.
        Each completed probe closes one probation window, judged by the
        indictment test in reverse (median inside both the dominance bar
        and the TPOT SLO); ``exoneration_verdict`` decides re-admission
        over the windows. Probe completions never reach the ledger."""
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
        active_total = 0
        for sh in probing:
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
            if active:
                sh.probe_s.append(time.perf_counter() - t0)
            active_total += active
            if len(eng.completions) > sh.done_seen:
                # one probe window closed: its verdict, maybe exoneration
                sh.done_seen = len(eng.completions)
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
        dec_backlog = sum(sh.engine.queue_depth for sh in live_dec) / len(
            live_dec
        )
        pre_backlog = (
            sum(sh.engine.queue_depth for sh in live_pre) / len(live_pre)
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
        sh = min(
            live_pre,
            key=lambda s: (s.engine.outstanding_tokens(), s.index),
        )
        survivors = [s for s in live_pre if s.index != sh.index]
        for slot in list(sh.engine.active_slots()):
            idx, remnant = sh.engine.evict(slot)
            gid = sh.alias[idx]
            self._reqs[gid].drained = True
            self.counters["drained"] += 1
            self._submit_prefill_to(survivors, gid, remnant)
        for idx, req in sh.engine.drop_queue():
            gid = sh.alias[idx]
            self._reqs[gid].drained = True
            self.counters["drained"] += 1
            self._submit_prefill_to(survivors, gid, req)
        if self._prewarm is not None:
            self._prewarm(sh.engine)
        # the prewarm's own completions are not cluster traffic
        sh.done_seen = len(sh.engine.completions)
        self.prefill.remove(sh)
        sh.flip("decode")
        self.shards.append(sh)
        self.shards.sort(key=lambda s: s.index)
        self.router.add_shard(sh.index)
        self._resize_event("promote", sh)

    def _submit_prefill_to(
        self, survivors: List[_Shard], gid: int, req: Request
    ) -> None:
        sh = min(
            survivors,
            key=lambda s: (s.engine.outstanding_tokens(), s.index),
        )
        idx = sh.engine.submit(req)
        sh.alias[idx] = gid

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
        sh = min(
            returnable,
            key=lambda s: (s.engine.outstanding_tokens(), s.index),
        )
        # router first: the drain's handoffs must not land back on it
        self.router.remove_shard(sh.index)
        self.shards.remove(sh)
        self._migrate_decode_work(sh, now_s)
        sh.flip("prefill")
        self.prefill.append(sh)
        self.prefill.sort(key=lambda s: s.index)
        self._resize_event("demote", sh)
