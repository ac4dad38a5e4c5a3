"""ClusterServingLoad: the serving cluster measured under open-loop
traffic, the multi-engine members' shared drive loop.

The counterpart of the JAX package's ``serving_load/cluster_base.py``.
Where ``ServingLoad`` drives one ``ContinuousBatchingEngine``, this base
drives a ``ddlb_tpu_torch.serve.ServingCluster``: the trace's requests
enter through the cluster's front door (token-bucket admission when
enabled: a shed request is a counted ``rejected`` outcome, never a lost
one), are routed or disaggregated across engines, and the row reports the
same ``slo_*`` columns plus the cluster's ledger (``serve_rejected``,
``serve_handoffs`` / ``serve_handoff_bytes`` / ``serve_handoff_ms``,
``serve_drained``, ``serve_shards`` / ``serve_shards_excluded``,
``serve_affinity_hits``, ``serve_resizes``, ``serve_pool_history``,
``serve_readmitted``) and a ``serve_topology`` stamp (``router:dp=2``,
``disagg:p1+d1``, with ``:degraded=K`` after exclusions and
``:elastic=R`` after resizes) by which baselines are kept apart.

Placement, as the JAX member's (``serve/placement.py``): each engine on a
disjoint group of ranks when the world divides by the engine count
(``tp_per = world / n_engines`` ranks an engine, its weights
``init_params(n_experts=tp_per)`` sharded over them), otherwise every
engine over every rank. Engines on one group share one copy of the
seeded weights, each with its own KV cache; at world 1 every engine is on
the one device. At world > 1 every rank drives the loop below: its group
steps its own engine, and every rank takes the cluster's decisions from
one shared view of every engine, refreshed each pump
(``serve/cluster.py``). Arrivals release on rank 0's clock
(``_drain_clock``), and the loop's every test reads values that are the
same on every rank, so the ranks run the same pumps.

Validation extends the single-engine accounting across the cluster:
completed and rejected partition the trace exactly, every completion's
prompt survives every handoff byte for byte (the bundle prompt is the
``preempt()`` fold), and the SLO ledger agrees with the pooled completion
count.

Besides the JAX row's columns the row carries the port's ``hbm_bytes``,
``drains``, ``drain_ticks`` and ``drain_prefills``, ``prewarm_ticks`` /
``prewarm_prefills`` (the set-up probes' decode ticks and prompt
prefills, ``_prewarm``) and ``local_engines``: the counts are over the
engines this rank runs (``local_engines`` of them; every engine at world
1), so that they say what kernels this rank launched.

Telemetry as the JAX member's: each drain is a ``serve.drain`` span (with
the topology stamp), closed by a ``serve.ticks`` instant from each engine
this rank runs, then the ``serve.queue_depth`` gauge and a ``serve.slo``
instant; validation failures go through ``telemetry.log``. Every rank
emits its own, in its own trace shard; nothing is gathered for them. Not
ported: the live tick stream and the calibration table
(``perfmodel.calib``): the handoff is priced by the closed form.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.primitives.serving_load.base import ServingLoad

#: cluster knobs every multi-engine member shares (members merge these
#: into DEFAULT_OPTIONS beside their pool-shape knobs)
CLUSTER_OPTIONS = {
    #: front-door admission: "open" admits everything, "token_bucket"
    #: sheds past capacity
    "admission": "open",
    #: scale on the census-derived sustainable rate
    "admission_overcommit": 1.0,
    #: explicit tokens/second (0 = from the decode HBM census,
    #: serve/admission.decode_token_rate)
    "admission_rate_tps": 0.0,
    #: bucket depth in seconds of the sustained rate (the tolerated burst)
    "admission_burst_s": 0.5,
    #: router affinity gives way to load above this imbalance ratio
    "affinity_imbalance": 2.0,
    #: SLO-aware straggler watch: timed decode ticks a shard before the
    #: watch may act (0 = off)
    "watch_ticks": 0,
    #: indictment needs worst median > dominance * best median
    "watch_dominance": 2.0,
    #: 1 arms the promote/demote controller on disaggregated members
    #: (routed members ignore it: no second pool to breathe with)
    "elastic": 0,
    #: per-shard queued requests that mark a pool as the bottleneck
    "resize_backlog": 8,
    #: pumps between pool transitions
    "resize_cooldown": 64,
    #: probation window in decode ticks (0 = an indicted shard stays
    #: excluded)
    "probation_ticks": 0,
    #: pumps between probation probe ticks (probes run synchronously in
    #: the pump: probing a hung shard every pump stalls every live lane)
    "probe_interval": 4,
}
CLUSTER_ALLOWED = {
    "admission": ["open", "token_bucket"],
    "admission_overcommit": (0.01, None),
    "admission_rate_tps": (0.0, None),
    "admission_burst_s": (0.01, None),
    "affinity_imbalance": (1.0, None),
    "watch_ticks": (0, None),
    "watch_dominance": (1.0, None),
    "elastic": [0, 1],
    "resize_backlog": (1, None),
    "resize_cooldown": (1, None),
    "probation_ticks": (0, None),
    "probe_interval": (1, None),
}


class ClusterServingLoad(ServingLoad):
    """ABC for multi-engine serving members. Members declare the pool
    shape (``_pool_sizes``) and the topology stamp (``_topology_base``);
    placement, the drive loop, the columns and validation live here."""

    def _pool_sizes(self) -> Tuple[int, int]:
        """(n_prefill_engines, n_decode_engines)."""
        raise NotImplementedError

    def _topology_base(self) -> str:
        """The topology stamp before any suffix."""
        raise NotImplementedError

    # -- shapes --------------------------------------------------------------

    def _n_engines(self) -> int:
        return sum(self._pool_sizes())

    def _mesh_factors(self) -> Tuple[int, int]:
        """(n_engines, tp_per_engine): disjoint groups of ranks when the
        world divides by the engine count, else every engine spans the
        world (JAX :126-134; ``serve.placement.engine_groups``)."""
        from ddlb_tpu_torch.serve.placement import engine_groups

        n_eng = self._n_engines()
        return n_eng, engine_groups(self.runtime.world_size, n_eng)[0]

    def _check_shapes(self) -> None:
        super()._check_shapes()
        o = self.options
        _, n_dec = self._pool_sizes()
        _, tp_per = self._mesh_factors()
        if o["batch"] % n_dec != 0:
            raise ValueError(
                f"batch={o['batch']} not divisible by the decode pool "
                f"size {n_dec} (slots split evenly across shards)"
            )
        if (o["batch"] // n_dec) % tp_per != 0:
            raise ValueError(
                f"per-shard batch {o['batch'] // n_dec} not divisible "
                f"by per-engine tp={tp_per} (the MoE block router)"
            )

    # -- engine and cluster construction -------------------------------------

    def _build_engines(self, cfg, max_batch: int, max_need: int, num_pages):
        """This rank's engines, each on its group's ``(1, tp_per)`` mesh
        over its shard of the seeded weights (``init_params`` at
        ``n_experts=tp_per``, as the JAX member's ``_build_engine``), one
        copy a group; a stand-in for each engine that runs on other ranks."""
        from ddlb_tpu_torch.models.serving import ContinuousBatchingEngine
        from ddlb_tpu_torch.models.transformer import (
            init_params,
            place_params,
            shard_params,
        )
        from ddlb_tpu_torch.serve.placement import EngineStandIn

        placement = self._placement
        tp = placement.tp
        host, params, engines = None, {}, []
        for e in range(self._n_engines()):
            if not placement.is_local(e):
                engines.append(EngineStandIn(
                    max_need, cfg.page_size if cfg.cache_layout == "paged" else None,
                    num_pages or 0, tp,
                ))
                continue
            mesh = placement.mesh(e)
            if mesh not in params:
                if host is None:
                    host = init_params(cfg, pp=1, n_experts=tp, seed=self.seed)
                params[mesh] = place_params(
                    shard_params(host, cfg, tp, mesh.tp_rank), self.device
                )
            engines.append(ContinuousBatchingEngine(
                mesh, cfg, params[mesh],
                max_batch=max_batch, max_len=max_need, num_pages=num_pages,
            ))
        return engines

    def _census_rate(self) -> float:
        """``decode_token_rate`` at this row's shape on this device."""
        from ddlb_tpu_torch.serve.admission import decode_token_rate

        o = self.options
        return decode_token_rate(
            ctx=self.m,
            d_model=self.n,
            d_ff=self.k,
            vocab=o["vocab"],
            n_heads=o["n_heads"],
            batch=o["batch"],
            n_kv_heads=o["n_kv_heads"],
            layers=o["layers"],
            kv_cache=o["kv_cache"],
            mlp_kernel=o["mlp_kernel"],
            spec=self.runtime.chip_spec,
            n_devices=self.runtime.world_size,
        )

    def _make_admission(self):
        o = self.options
        if o["admission"] != "token_bucket":
            return None
        from ddlb_tpu_torch.serve.admission import TokenBucket

        rate = float(o["admission_rate_tps"])
        if rate <= 0.0:
            rate = self._census_rate() * float(o["admission_overcommit"])
        burst = max(1.0, rate * float(o["admission_burst_s"]))
        return TokenBucket(rate, burst)

    def _bundle_pricer(self):
        from ddlb_tpu_torch.perfmodel.cost import kv_bundle_bytes

        o = self.options
        return lambda kv_tokens: kv_bundle_bytes(
            d_model=self.n,
            n_heads=o["n_heads"],
            n_kv_heads=o["n_kv_heads"],
            layers=o["layers"],
            kv_cache=o["kv_cache"],
            tokens=kv_tokens,
        )

    def _prewarm(self, engines, n_dec, spec) -> None:
        """Set-up probes: the first use of every shape an engine will see.

        With one engine the warm-up drain visits every admission bucket.
        Across a cluster the router's placement reacts to wall-clock load,
        so a prompt bucket can reach some engine for the first time inside
        a pooled drain and bill its first-use costs (the kernel build at
        first use, allocator growth, the cuBLAS workspace) to real
        requests' TTFTs. So one ``max_new=1`` probe per distinct admission
        shape (prefix hit x pad bucket, including the one-token-longer
        resume prompts a prefill pool hands off) is admitted into every
        engine this rank runs (a one-token request completes at
        admission), plus one 2-token probe on each decode engine for its
        decode step, and on the prefill engines too when elastic (a
        promotion must not bill its first decode tick to a real request);
        then every engine resets. The probes run under the runner's matmul precision scope,
        as measured calls do.

        Their decode ticks and prompt prefills are counted
        (``prewarm_ticks``, ``prewarm_prefills``): they launch the decode
        and flash kernels like any others."""
        from ddlb_tpu_torch.models.serving import (
            ContinuousBatchingEngine,
            Request,
        )
        from ddlb_tpu_torch.primitives.base import matmul_precision_scope
        from ddlb_tpu_torch.workload import prefix_tokens

        pfx = prefix_tokens(spec, 0) if spec.prefix_pop else None
        P = int(pfx.size) if pfx is not None else 0
        S_max = engines[0].S_max
        bucket = ContinuousBatchingEngine._bucket
        n_pre = len(engines) - n_dec
        probes: Dict[Tuple[bool, int], np.ndarray] = {}
        for r in self._trace:
            lengths = {r.prompt.size}
            if n_pre and r.max_new > 1:
                # the decode pool re-prefills a handoff bundle whose prompt
                # is one (prefill-pool) token longer
                lengths.add(r.prompt.size + 1)
            for L in lengths:
                hit = (
                    P > 0
                    and L > P
                    and r.prompt.size >= P
                    and np.array_equal(r.prompt[:P], pfx)
                )
                key = (
                    (True, P + min(bucket(L - P), S_max - P))
                    if hit
                    else (False, min(bucket(L), S_max))
                )
                if key in probes:
                    continue
                probe = np.zeros(L, np.int32)
                probe[: r.prompt.size] = r.prompt
                probes[key] = probe
        with matmul_precision_scope(self.dtype):
            for i, e in enumerate(engines):
                if not self._placement.is_local(i):
                    continue
                for probe in probes.values():
                    e.submit(Request(probe, max_new=1))
                    e.admit_ready()
                if i < n_dec or self.options["elastic"]:
                    e.submit(Request(self._trace[0].prompt, max_new=2))
                    e.admit_ready()
                    e.step()
                self._prewarm_ticks += e.stats.steps
                self._prewarm_prefills += e.stats.admissions - e.stats.prefix_hits
                e.reset()

    def _tick_floor_s(self, n_dec: int) -> float:
        """The census's per-decode-tick estimate for one shard: the
        cluster's census rate split across the decode pool, inverted over
        the per-shard batch. The watch floors its reference with it, so a
        cluster whose every shard is degraded still sees raised weights.
        0.0 (no floor) when the census cannot price this shape."""
        o = self.options
        try:
            rate = self._census_rate()
        except (KeyError, ValueError, ZeroDivisionError):
            return 0.0
        if rate <= 0.0 or rate == float("inf"):
            return 0.0
        return (o["batch"] // n_dec) * n_dec / rate

    def _promote_prewarm_hook(self):
        """The prewarm an elastic cluster runs on a freshly promoted
        engine: one 2-token probe driven to completion under the matmul
        precision scope (its wall clock lands inside the measured drain,
        so a transition is never free; its ticks count in the drain's).
        The hook must not reset the engine: the cluster resyncs its
        ``done_seen`` cursor instead."""
        if not self.options["elastic"]:
            return None
        from ddlb_tpu_torch.models.serving import Request
        from ddlb_tpu_torch.primitives.base import matmul_precision_scope

        prompt = self._trace[0].prompt
        dtype = self.dtype

        def hook(engine) -> None:
            with matmul_precision_scope(dtype):
                engine.submit(Request(prompt, max_new=2))
                engine.admit_ready()
                while engine.active_slots() or engine.queue_depth:
                    engine.step()
                    engine.admit_ready()

        return hook

    def _input_setup(self) -> None:
        from ddlb_tpu_torch.perfmodel.cost import kv_handoff_seconds
        from ddlb_tpu_torch.serve.cluster import ServingCluster
        from ddlb_tpu_torch.serve.router import PrefixAffinityRouter
        from ddlb_tpu_torch.workload import generate_trace, prefix_tokens

        from ddlb_tpu_torch.serve.placement import EnginePlacement

        cfg = self._model_config()
        o = self.options
        _, n_dec = self._pool_sizes()
        spec = self.workload_spec()
        self._trace = generate_trace(spec)
        max_need = max(r.prompt.size + r.max_new for r in self._trace)
        batch_per = o["batch"] // n_dec
        num_pages = None
        if cfg.cache_layout == "paged":
            ps = cfg.page_size
            max_need = -(-max_need // ps) * ps
            num_pages = max(
                1, round(o["page_pool_frac"] * batch_per * (max_need // ps))
            )
        # every rank creates every engine's group, then sets up its own
        # engines; a failure on any rank raises on every rank
        self._placement = EnginePlacement(self.runtime, self._n_engines())
        self._prewarm_ticks = self._prewarm_prefills = 0
        failure = None
        try:
            engines = self._build_engines(cfg, batch_per, max_need, num_pages)
            if spec.prefix_pop:
                # every engine caches the hot prefix: resumed prompts still
                # start with it, so decode-pool prefix hits survive a handoff
                for e in engines:
                    e.set_shared_prefix(prefix_tokens(spec, 0))
            self._prewarm(engines, n_dec, spec)
        except Exception as exc:  # raised again on every rank by share
            failure = exc
        self._placement.share({}, failure)
        chip = self.runtime.chip_spec
        self._cluster = ServingCluster(
            engines[:n_dec],
            engines[n_dec:],
            router=PrefixAffinityRouter(
                n_dec, imbalance=float(o["affinity_imbalance"])
            ),
            admission=self._make_admission(),
            bundle_bytes=self._bundle_pricer(),
            handoff_seconds=lambda b: kv_handoff_seconds(b, chip),
            preempt_hol_ticks=o["preempt_hol_ticks"],
            watch_ticks=o["watch_ticks"],
            watch_dominance=float(o["watch_dominance"]),
            slo_tpot_ms=float(o["slo_tpot_ms"]),
            elastic=bool(o["elastic"]),
            resize_backlog=int(o["resize_backlog"]),
            resize_cooldown=int(o["resize_cooldown"]),
            probation_ticks=int(o["probation_ticks"]),
            probe_interval=int(o["probe_interval"]),
            tick_floor_s=self._tick_floor_s(n_dec),
            prewarm=self._promote_prewarm_hook(),
            placement=self._placement,
        )
        self._last: Optional[Dict[str, Any]] = None
        self._drains = 0
        self._pooled = None
        self._pooled_completed = 0
        self._makespan_total = 0.0
        self._drain_ticks = self._drain_prefills = 0
        self._fn = self._run_trace
        self.runtime.synchronize()

    def _run_trace(self):
        self._drain()
        # the cache of an engine this rank runs, so a fence on it includes
        # its last step
        return self._cluster.local_engines()[0].cache["k"]

    # -- the cluster drive loop ---------------------------------------------

    def _drain(self) -> None:
        """One open-loop replay against the freshly reset cluster: the
        single-engine protocol, ending on the cluster's ledger (completed
        + rejected = the trace's length: a shed request is an outcome).
        Every test of the loop reads the shared ledger or rank 0's clock, so
        every rank runs the same pumps; a pump stamps with rank 0's reading
        at its start, which travels in the pump's exchange."""
        from ddlb_tpu_torch.workload import SLOTracker

        o = self.options
        cl = self._cluster
        cl.reset()
        trace = self._trace
        n = len(trace)
        self._drains += 1
        if self._drains == 1:
            tracker = SLOTracker(o["slo_ttft_ms"], o["slo_tpot_ms"])
        elif self._pooled is None:
            tracker = self._pooled = SLOTracker(
                o["slo_ttft_ms"], o["slo_tpot_ms"]
            )
        else:
            tracker = self._pooled
            tracker.new_drain()
        gid2trace: Dict[int, int] = {}
        orig_prompt = {r.index: r.prompt.size for r in trace}
        submitted = 0
        done_seen = 0
        with telemetry.span("serve.drain", cat="serve", requests=n,
                            topology=self._topology_base()):
            clock = self._drain_clock()
            while cl.accounted < n:
                now = clock()
                while submitted < n and trace[submitted].arrival_s <= now:
                    r = trace[submitted]
                    gid, _admitted = cl.submit(
                        r.prompt, r.max_new, r.prefix_id, now_s=now
                    )
                    gid2trace[gid] = r.index
                    tracker.arrived(r.index, r.arrival_s)
                    submitted += 1
                tracker.observe_queue(cl.queue_depth)
                active = cl.pump(clock.local())
                for c in cl.completions[done_seen:]:
                    orig = gid2trace[c.request_id]
                    tracker.first_token(orig, c.first_s)
                    tracker.finished(
                        orig,
                        c.finished_s,
                        c.tokens.size - orig_prompt[orig],
                    )
                done_seen = len(cl.completions)
                if active == 0 and not cl.queue_depth and submitted < n:
                    wait = trace[submitted].arrival_s - clock()
                    if wait > 0:
                        time.sleep(wait)
            makespan = clock()
        for e in cl.local_engines():
            e.mark_ticks()
        horizon = max(self._trace_horizon_s(), 1e-9)
        if tracker is self._pooled:
            self._makespan_total += makespan
            self._pooled_completed += len(cl.completions)
            goodput_window = self._makespan_total
        else:
            goodput_window = makespan
        stats = cl.engine_stats()
        for e in cl.local_engines():
            self._drain_ticks += e.stats.steps
            self._drain_prefills += e.stats.admissions - e.stats.prefix_hits
        fields = tracker.row_fields(goodput_window, offered_rps=n / horizon)
        telemetry.record_max("serve.queue_depth", tracker.queue_peak)
        telemetry.instant(
            "serve.slo", cat="serve", completed=tracker.completed,
            rejected=len(cl.rejections), ttft_p95_ms=fields["slo_ttft_p95_ms"],
            goodput_rps=fields["slo_goodput_rps"], queue_peak=tracker.queue_peak,
        )
        self._last = {
            "tracker": tracker,
            "fields": fields,
            "makespan_s": makespan,
            "completions": [
                (gid2trace[c.request_id], c.tokens) for c in cl.completions
            ],
            "rejected": [gid2trace[g] for g in cl.rejections],
            "counters": dict(cl.counters),
            "stats": stats,
            "affinity_hits": cl.router.affinity_hits,
            "pool_history": list(cl.pool_history),
        }

    # -- row columns ---------------------------------------------------------

    def _topology(self) -> str:
        """The stamp baselines are kept apart by: the base shape, then
        ``:degraded=K`` when shards were excluded, then ``:elastic=R``
        when the pools resized."""
        base = self._topology_base()
        if not self._last:
            return base
        excl = int(self._last["counters"]["shards_excluded"])
        resizes = int(self._last["counters"].get("resizes", 0))
        if excl:
            base = f"{base}:degraded={excl}"
        if resizes:
            base = f"{base}:elastic={resizes}"
        return base

    def extra_row_fields(self) -> dict:
        """The JAX row's ``slo_*`` / ``serve_*`` columns (:596-628), then
        the port's ``hbm_bytes``, the drains' and the set-up probes'
        counts on this rank's engines, and their number."""
        if self._last is None:
            return {}
        s = self._last["stats"]
        c = self._last["counters"]
        n_pre, n_dec = self._pool_sizes()
        out = dict(self._last["fields"])
        out.update(
            {
                "serve_occupancy": round(s.occupancy, 4),
                "serve_prefix_hits": s.prefix_hits,
                "serve_admissions_deferred": s.admissions_deferred,
                "serve_preemptions": s.preemptions,
                "serve_kv_evicted_tokens": s.kv_evicted_tokens,
                "serve_peak_pages": s.peak_pages_in_use,
                "serve_pages_capacity": s.pages_capacity,
                "serve_topology": self._topology(),
                "serve_shards": n_pre + n_dec,
                "serve_shards_excluded": int(c["shards_excluded"]),
                "serve_rejected": int(c["rejected"]),
                "serve_handoffs": int(c["handoffs"]),
                "serve_handoff_bytes": float(c["handoff_bytes"]),
                "serve_handoff_ms": round(c["handoff_s"] * 1000.0, 4),
                "serve_drained": int(c["drained"]),
                "serve_affinity_hits": int(self._last["affinity_hits"]),
                "serve_resizes": int(c.get("resizes", 0)),
                "serve_pool_history": ";".join(
                    self._last.get("pool_history", ())
                ),
                "serve_readmitted": int(c.get("readmitted", 0)),
                "hbm_bytes": self.hbm_bytes(),
                "drains": self._drains,
                "drain_ticks": self._drain_ticks,
                "drain_prefills": self._drain_prefills,
                "prewarm_ticks": self._prewarm_ticks,
                "prewarm_prefills": self._prewarm_prefills,
                "local_engines": len(self._cluster.local_engines()),
            }
        )
        return out

    # -- validation ----------------------------------------------------------

    def validate(self, result) -> bool:
        """The single-engine accounting extended across the cluster:
        completed and rejected partition the trace (exactly once on both
        sides), every completion honours its budget with its prompt byte
        for byte through any handoffs, and the SLO ledger agrees with the
        pooled completion count."""
        if self._last is None:
            telemetry.log("serving_load validation FAILED: no drain ran")
            return False
        o = self.options
        trace = {r.index: r for r in self._trace}
        seen: Dict[int, int] = {}
        ok = True
        for orig, tokens in self._last["completions"]:
            seen[orig] = seen.get(orig, 0) + 1
            r = trace[orig]
            S0 = r.prompt.size
            if tokens.size != S0 + r.max_new:
                telemetry.log(f"serving_load validation FAILED: request {orig} "
                              f"length {tokens.size} != {S0 + r.max_new}")
                ok = False
                continue
            if not np.array_equal(tokens[:S0], r.prompt):
                telemetry.log(f"serving_load validation FAILED: request {orig} prompt "
                              f"mangled (the handoff chain broke the ledger)")
                ok = False
            if ((tokens < 0) | (tokens >= o["vocab"])).any():
                telemetry.log(f"serving_load validation FAILED: request {orig} token out "
                              f"of vocab range")
                ok = False
        rejected = list(self._last["rejected"])
        if any(v != 1 for v in seen.values()):
            telemetry.log("serving_load validation FAILED: a request completed more "
                          "than once")
            ok = False
        overlap = set(seen) & set(rejected)
        if overlap:
            telemetry.log(f"serving_load validation FAILED: requests {sorted(overlap)} "
                          f"both completed and rejected")
            ok = False
        if sorted(set(seen) | set(rejected)) != sorted(trace) or len(
            rejected
        ) != len(set(rejected)):
            telemetry.log(f"serving_load validation FAILED: outcomes do not partition "
                          f"the trace ({len(seen)} completed + {len(rejected)} rejected "
                          f"of {len(trace)})")
            ok = False
        tracker = self._last["tracker"]
        expected = (
            self._pooled_completed
            if tracker is self._pooled
            else len(self._last["completions"])
        )
        if tracker.completed != expected:
            telemetry.log(f"serving_load validation FAILED: SLO ledger count "
                          f"{tracker.completed} != {expected}")
            ok = False
        return ok
