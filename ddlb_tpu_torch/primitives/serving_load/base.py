"""ServingLoad: the serving engine measured under open-loop traffic.

The counterpart of the JAX package's ``serving_load/base.py``. A seeded
open-loop workload (``ddlb_tpu_torch/workload``: Poisson or bursty
arrivals, a mix of prompt and output lengths, a Zipf shared-prefix
population) is replayed against the continuous-batching engine
(``models/serving.py``), and the row reports the latency distribution the
traffic met (TTFT and TPOT percentiles, goodput under the SLO bound,
attainment, queue gauges, preemption counters) as ``slo_*`` and
``serve_*`` columns under the JAX package's names, beside the timing
statistics. Swept over ``rate`` the rows are the latency against offered
load curve.

Shape mapping onto ``(m, n, k)``: ``m`` the mean prompt length (prompts
are lognormal around it, from ``m/4`` to ``4 m``), ``n`` d_model, ``k``
d_ff.

One measured call is one full drain of the trace: arrivals release on the
host clock whatever the engine's progress, so queueing delay is real.
Time it with ``time_measurement_backend='host_clock'`` (the drain is
host-scheduled). Every drain after the first pools into one SLO tracker
(the first, with the engine's first calls, is thrown away; a single
drain's p95 over a small trace is noise).

Members: ``engine`` admits into any free slot every tick (plus the
head-of-line preemption policy, ``preempt_hol_ticks``); ``static`` admits
only when every slot is idle; the cluster members ``router`` and
``disagg`` (``cluster_base.py``) drive several engines behind the
``serve/`` cluster.

Every rank of a tp mesh drives its own engine; the drive loop reads rank
0's clock on every rank (``_drain_clock``), so the ranks release the same
arrivals at the same pumps.

Validation checks the drain's accounting (every request completed once,
its budget honoured, its prompt at the front of its tokens, tokens in
range, the SLO ledger's count); the engine's token chains are its own
contract, held in ``tests/test_torch_serving_engine.py``.

Besides the JAX package's columns the row carries ``hbm_bytes`` (the
traffic floor, as ``transformer_decode``'s rows do) and, over every
drain of the row (warm-up and validation included), ``drains``,
``drain_ticks`` (decode ticks: one K11/K12 launch a layer each under
``decode_kernel=pallas``) and ``drain_prefills`` (admissions that ran a
prompt prefill: those the shared prefix did not serve).

Telemetry as the JAX member's: each drain is a ``serve.drain`` span,
closed by the engine's ``serve.ticks`` instant (the drain steps the
engine itself, so the instant ``run`` would emit comes from here), and
followed by the ``serve.queue_depth`` gauge and a ``serve.slo`` instant;
validation failures are logged through ``telemetry.log``. At world > 1
every rank emits its own in its own trace shard. Rank 0 posts the
drain's queue gauge to the live stream (``serving_tick``,
``observatory/live.py``) at most every ``_TICK_POST_INTERVAL_S``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.observatory import live
from ddlb_tpu_torch.models.serving import ContinuousBatchingEngine, Request
from ddlb_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    place_params,
    shard_params,
)
from ddlb_tpu_torch.primitives.base import Primitive, torch_dtype
from ddlb_tpu_torch.workload import SLOTracker, WorkloadSpec, generate_trace, prefix_tokens


#: seconds between two ``serving_tick`` events of a drain on the live
#: stream (``observatory/live.py``; rank 0 only)
_TICK_POST_INTERVAL_S = 0.5


class DrainClock:
    """Seconds since a drain began, called wherever the drive loop reads
    the time (releasing arrivals, stamping first tokens and completions,
    the idle wait, the makespan).

    Every rank runs the drive loop, and the ranks must release the same
    arrivals before the same admissions, or their prefills post
    collectives that no longer pair. So at world > 1 a reading is rank 0's
    host clock, broadcast (``Runtime.broadcast_host``). ``local()`` is this
    rank's own reading with no collective, which on rank 0 is the drain's
    time: the cluster's pump takes it, and its exchange carries rank 0's
    to every rank. At world 1 both are this process's clock."""

    def __init__(self, runtime) -> None:
        self._runtime = runtime
        self._t0 = time.perf_counter()

    def local(self) -> float:
        return time.perf_counter() - self._t0

    def __call__(self) -> float:
        rt = self._runtime
        if rt.world_size == 1:
            return self.local()
        return rt.broadcast_host(self.local() if rt.rank == 0 else 0.0, 0)


class ServingLoad(Primitive):
    """ABC for load-driven serving members (the drive loop lives here;
    members choose the admission policy)."""

    primitive_name = "serving_load"

    BASE_OPTIONS = {
        "batch": 8,
        "vocab": 512,
        "n_heads": 8,
        "n_kv_heads": 0,
        "layers": 1,
        "kv_cache": "bf16",
        "mlp_kernel": "bf16",
        "attn_kernel": "einsum",
        "decode_kernel": "einsum",
        "cache_layout": "contiguous",
        "page_size": 128,
        "page_pool_frac": 1.0,
        "rate": 4.0,
        "process": "poisson",
        "burst_factor": 4.0,
        "burst_duty": 0.2,
        "burst_len_s": 1.0,
        "n_requests": 0,
        "out_mean": 8,
        "out_max": 32,
        "prompt_sigma": 0.4,
        "prefix_pop": 0,
        "prefix_len": 0,
        "prefix_alpha": 1.1,
        "slo_ttft_ms": 2000.0,
        "slo_tpot_ms": 500.0,
        "preempt_hol_ticks": 0,
    }
    BASE_ALLOWED = {
        "batch": (1, None),
        "vocab": (2, None),
        "n_heads": (1, None),
        "n_kv_heads": (0, None),
        "layers": (1, None),
        "kv_cache": ["bf16", "int8"],
        "mlp_kernel": ["bf16", "int8", "int8_weights"],
        "attn_kernel": ["flash", "einsum"],
        "decode_kernel": ["einsum", "pallas"],
        "cache_layout": ["contiguous", "paged"],
        "page_size": (1, None),
        "page_pool_frac": (0.01, 1.0),
        "rate": (0.01, None),
        "process": ["poisson", "bursty"],
        "burst_factor": (1.0, None),
        "burst_duty": (0.01, 0.99),
        "burst_len_s": (0.01, None),
        "n_requests": (0, None),
        "out_mean": (1, None),
        "out_max": (1, None),
        "prompt_sigma": (0.0, 2.0),
        "prefix_pop": (0, None),
        "prefix_len": (0, None),
        "prefix_alpha": (0.1, None),
        "slo_ttft_ms": (1.0, None),
        "slo_tpot_ms": (1.0, None),
        "preempt_hol_ticks": (0, None),
    }

    # -- schema and shapes ---------------------------------------------------------

    def _mesh_factors(self) -> Tuple[int, int]:
        """(1, world size): the engine's batch axis is the slot axis."""
        return 1, self.runtime.world_size

    def _check_shapes(self) -> None:
        o = self.options
        _, tp = self._mesh_factors()
        if self.n % o["n_heads"] != 0:
            raise ValueError(
                f"n={self.n} (d_model) not divisible by n_heads={o['n_heads']}"
            )
        if o["n_heads"] % tp != 0:
            raise ValueError(f"n_heads={o['n_heads']} not divisible by tp={tp}")
        if o["n_kv_heads"]:
            if o["n_heads"] % o["n_kv_heads"] or o["n_kv_heads"] % tp:
                raise ValueError(
                    f"n_kv_heads={o['n_kv_heads']} must divide "
                    f"n_heads={o['n_heads']} and be divisible by tp={tp}"
                )
        if o["batch"] % tp != 0:
            raise ValueError(
                f"batch={o['batch']} not divisible by tp={tp} (the MoE block router)"
            )
        if self.dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError("serving_load requires a floating dtype")
        if o["prefix_pop"] and not o["prefix_len"]:
            raise ValueError("prefix_pop > 0 needs prefix_len >= 1")

    # -- the workload ----------------------------------------------------------

    def workload_spec(self) -> WorkloadSpec:
        """The trace's identity: the options, the shape and the seed, so
        equal rows replay equal traffic (:184)."""
        o = self.options
        return WorkloadSpec(
            n_requests=o["n_requests"] or 3 * o["batch"],
            rate_rps=float(o["rate"]),
            process=o["process"],
            burst_factor=float(o["burst_factor"]),
            burst_duty=float(o["burst_duty"]),
            burst_len_s=float(o["burst_len_s"]),
            prompt_mean=self.m,
            prompt_sigma=float(o["prompt_sigma"]),
            prompt_min=max(1, self.m // 4),
            prompt_max=4 * self.m,
            out_mean=o["out_mean"],
            out_min=1,
            out_max=o["out_max"],
            vocab=o["vocab"],
            prefix_pop=o["prefix_pop"],
            prefix_alpha=float(o["prefix_alpha"]),
            prefix_len=o["prefix_len"],
            seed=self.seed,
        )

    def _trace_horizon_s(self) -> float:
        """The last arrival's offset: an open-loop drain ends no earlier."""
        return self._trace[-1].arrival_s if self._trace else 0.0

    # -- counts ----------------------------------------------------------------

    def flops(self) -> float:
        """Useful work of the whole trace (:216): per request one prompt
        prefill and its generated tokens' decode forwards (idle lanes,
        re-prefills after preemption and waits are overhead)."""
        o = self.options
        D, F = self.n, self.k
        L, V = o["layers"], o["vocab"]
        kv_frac = (o["n_kv_heads"] or o["n_heads"]) / o["n_heads"]
        proj = (4.0 + 4.0 * kv_frac) * D * D
        total = 0.0
        for r in self._trace:
            S0 = r.prompt.size
            total += S0 * (L * (proj + 2.0 * S0 * D + 4.0 * D * F))
            total += 2.0 * D * V
            steps = r.max_new - 1
            ctx_sum = steps * S0 + steps * (steps - 1) / 2.0
            total += (
                steps * (L * (proj + 4.0 * D * F) + 2.0 * D * V)
                + L * 4.0 * D * ctx_sum
            )
        return total

    def hbm_bytes(self) -> float:
        """Traffic floor (:240): every generated token re-reads the weights
        and the KV cache of a decode step at ``m``."""
        from ddlb_tpu_torch.utils.hbm_budget import decode_budget

        o = self.options
        census = decode_budget(
            ctx=self.m, d_model=self.n, d_ff=self.k, vocab=o["vocab"],
            n_heads=o["n_heads"], batch=o["batch"], n_kv_heads=o["n_kv_heads"],
            layers=o["layers"], kv_cache=o["kv_cache"],
            mlp_kernel=o["mlp_kernel"], phase="decode",
        )
        per_pass = census["weights"] + census["kv_cache"]
        return sum(r.max_new for r in self._trace) * per_pass

    def cost_model(self):
        """The decode census floor, floored again at the trace's arrival
        horizon (:266): an open-loop drain cannot end before its last
        request arrives, so ``predicted_s`` is ``max(census floor,
        horizon)``; without it every low-load row would read as a large
        false inefficiency."""
        est = super().cost_model()
        horizon = self._trace_horizon_s()
        if horizon > est.predicted_s:
            est = dataclasses.replace(est, predicted_s=horizon)
        return est

    # -- the engine --------------------------------------------------------------

    def _model_config(self) -> TransformerConfig:
        o = self.options
        return TransformerConfig(
            vocab=o["vocab"], d_model=self.n, n_heads=o["n_heads"],
            n_kv_heads=o["n_kv_heads"], d_ff=self.k, layers_per_stage=o["layers"],
            mlp_kernel=o["mlp_kernel"], kv_cache=o["kv_cache"],
            attn_kernel=o["attn_kernel"], decode_kernel=o["decode_kernel"],
            cache_layout=o["cache_layout"], page_size=o["page_size"],
            dtype=torch_dtype(self.dtype),
        )

    @property
    def _call_args(self):
        return ()

    def _input_setup(self) -> None:
        cfg = self._model_config()
        dp, tp = self._mesh_factors()
        self.mesh = self.runtime.mesh(dp, tp, 1)
        self.num_partitions = dp * tp
        o = self.options
        spec = self.workload_spec()
        self._trace = generate_trace(spec)
        params = place_params(
            shard_params(init_params(cfg, pp=1, n_experts=tp, seed=self.seed), cfg,
                         tp, self.mesh.tp_rank),
            self.device,
        )
        max_need = max(r.prompt.size + r.max_new for r in self._trace)
        num_pages = None
        if cfg.cache_layout == "paged":
            ps = cfg.page_size
            max_need = -(-max_need // ps) * ps
            num_pages = max(1, round(o["page_pool_frac"] * o["batch"] * (max_need // ps)))
        self._engine = ContinuousBatchingEngine(
            self.mesh, cfg, params, max_batch=o["batch"], max_len=max_need,
            num_pages=num_pages,
        )
        if spec.prefix_pop:
            # the hot (rank 0) member is the engine's shared prefix; the
            # others miss by design
            self._engine.set_shared_prefix(prefix_tokens(spec, 0))
        self._last: Optional[Dict[str, Any]] = None
        self._drains = 0
        self._pooled: Optional[SLOTracker] = None
        self._makespan_total = 0.0
        self._drain_ticks = self._drain_prefills = 0
        self._fn = self._run_trace
        self.runtime.synchronize()

    def _run_trace(self):
        self._drain()
        # the last tick's cache, so a fence on it includes the last step
        return self._engine.cache["k"]

    # -- the drive loop ----------------------------------------------------------

    def _admission_open(self, engine) -> bool:
        """Member policy: may queued requests be admitted now?"""
        raise NotImplementedError

    def _drain_clock(self) -> "DrainClock":
        """The drain's clock, started now (``DrainClock``)."""
        return DrainClock(self.runtime)

    def _drain(self) -> None:
        """One open-loop replay of the trace against the reset engine
        (:380): arrivals release on the host clock; per-request timelines,
        queue gauges and the engine's counters fold into ``self._last``."""
        o = self.options
        eng = self._engine
        eng.reset()
        trace = self._trace
        n = len(trace)
        self._drains += 1
        if self._drains == 1:
            # the first drain carries the first calls: its latencies never
            # join the pooled distributions (kept for a single-drain run)
            tracker = SLOTracker(o["slo_ttft_ms"], o["slo_tpot_ms"])
        elif self._pooled is None:
            tracker = self._pooled = SLOTracker(o["slo_ttft_ms"], o["slo_tpot_ms"])
        else:
            tracker = self._pooled
            tracker.new_drain()
        alias: Dict[int, int] = {}        # engine request index -> trace index
        orig_prompt = {r.index: r.prompt.size for r in trace}
        hol_ticks = 0
        last_head: Optional[int] = None
        submitted = done_seen = 0
        # the stream's state is read once: a drain with it off does nothing for it
        post_ticks = self.runtime.rank == 0 and bool(live.live_path())
        last_post = -_TICK_POST_INTERVAL_S
        with telemetry.span("serve.drain", cat="serve", requests=n):
            clock = self._drain_clock()
            while done_seen < n:
                now = clock()
                while submitted < n and trace[submitted].arrival_s <= now:
                    r = trace[submitted]
                    alias[eng.submit(Request(r.prompt, max_new=r.max_new))] = r.index
                    tracker.arrived(r.index, r.arrival_s)
                    submitted += 1
                admitted = eng.admit_ready() if self._admission_open(eng) else 0
                if admitted:
                    # admission computes the first token; re-stamping active
                    # slots is idempotent, so a re-admission changes nothing
                    t_now = clock()
                    for s in eng.active_slots():
                        tracker.first_token(alias[eng.slot_request(s)], t_now)
                    hol_ticks = 0
                head_req = eng.queue_head()
                head = alias[head_req] if head_req is not None else None
                if head is not None and head == last_head and not admitted:
                    hol_ticks += 1
                    if (o["preempt_hol_ticks"] and hol_ticks > o["preempt_hol_ticks"]
                            and eng.active_slots()):
                        self._preempt_for_head(eng, alias)
                        hol_ticks = 0
                else:
                    last_head = head
                tracker.observe_queue(eng.queue_depth)
                active = eng.step()
                t_now = clock()
                for c in eng.completions[done_seen:]:
                    orig = alias[c.request_index]
                    tracker.first_token(orig, t_now)  # one-token finishers
                    tracker.finished(orig, t_now, c.tokens.size - orig_prompt[orig])
                done_seen = len(eng.completions)
                if post_ticks and clock.local() - last_post >= _TICK_POST_INTERVAL_S:
                    # the dashboard's queue-depth gauge
                    live.post_event("serving_tick", queue_depth=eng.queue_depth,
                                    active=active, done=done_seen, total=n)
                    last_post = clock.local()
                if active == 0 and not eng.queue_depth and submitted < n:
                    # idle: sleep exactly to the next arrival, whose time is known
                    wait = trace[submitted].arrival_s - clock()
                    if wait > 0:
                        time.sleep(wait)
            makespan = clock()
        eng.mark_ticks()
        horizon = max(self._trace_horizon_s(), 1e-9)
        if tracker is self._pooled:
            self._makespan_total += makespan
            goodput_window = self._makespan_total
        else:
            goodput_window = makespan
        s = eng.stats
        self._drain_ticks += s.steps
        self._drain_prefills += s.admissions - s.prefix_hits
        fields = tracker.row_fields(goodput_window, offered_rps=n / horizon)
        telemetry.record_max("serve.queue_depth", tracker.queue_peak)
        telemetry.instant(
            "serve.slo", cat="serve", completed=tracker.completed,
            ttft_p95_ms=fields["slo_ttft_p95_ms"],
            goodput_rps=fields["slo_goodput_rps"], queue_peak=tracker.queue_peak,
        )
        self._last = {
            "tracker": tracker,
            "fields": fields,
            "makespan_s": makespan,
            "completions": [(alias[c.request_index], c.tokens) for c in eng.completions],
        }

    def _preempt_for_head(self, eng, alias: Dict[int, int]) -> None:
        """The head-of-line policy: preempt the active slot with the most
        budget left, the timeline alias kept on the original request."""
        slot = max(eng.active_slots(), key=eng.remaining_budget)
        orig = alias[eng.slot_request(slot)]
        alias[eng.preempt(slot)] = orig

    # -- row columns -------------------------------------------------------------

    def extra_row_fields(self) -> dict:
        """The SLO columns pooled over the post-warm-up drains, the
        engine's counters of the last drain, the cluster columns at their
        single-engine values (:513-555), and the port's own ``hbm_bytes``,
        ``drains``, ``drain_ticks`` and ``drain_prefills``."""
        if self._last is None:
            return {}
        s = self._engine.stats
        out = dict(self._last["fields"])
        out.update({
            "serve_occupancy": round(s.occupancy, 4),
            "serve_prefix_hits": s.prefix_hits,
            "serve_admissions_deferred": s.admissions_deferred,
            "serve_preemptions": s.preemptions,
            "serve_kv_evicted_tokens": s.kv_evicted_tokens,
            "serve_peak_pages": s.peak_pages_in_use,
            "serve_pages_capacity": s.pages_capacity,
            "serve_topology": "single",
            "serve_shards": 1,
            "serve_shards_excluded": 0,
            "serve_rejected": 0,
            "serve_handoffs": 0,
            "serve_handoff_bytes": 0.0,
            "serve_handoff_ms": 0.0,
            "serve_drained": 0,
            "serve_affinity_hits": 0,
            "serve_resizes": 0,
            "serve_pool_history": "",
            "serve_readmitted": 0,
            "hbm_bytes": self.hbm_bytes(),
            "drains": self._drains,
            "drain_ticks": self._drain_ticks,
            "drain_prefills": self._drain_prefills,
        })
        return out

    # -- validation --------------------------------------------------------------

    def validate(self, result) -> bool:
        """The last drain's accounting (:557): every trace request
        completed exactly once, with exactly its budget (the engine runs
        without eos), its prompt at the front, every token in range, and
        the SLO ledger's count equal to the drains' requests."""
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
                telemetry.log(f"serving_load validation FAILED: request {orig} prompt mangled")
                ok = False
            if ((tokens < 0) | (tokens >= o["vocab"])).any():
                telemetry.log(f"serving_load validation FAILED: request {orig} token out "
                              f"of vocab range")
                ok = False
        if sorted(seen) != sorted(trace) or any(v != 1 for v in seen.values()):
            telemetry.log(f"serving_load validation FAILED: {len(seen)} distinct "
                          f"completions for {len(trace)} requests")
            ok = False
        tracker = self._last["tracker"]
        expected = ((self._drains - 1) * len(trace) if tracker is self._pooled
                    else len(trace))
        if tracker.completed != expected:
            telemetry.log(f"serving_load validation FAILED: SLO ledger count "
                          f"{tracker.completed} != {expected} ({self._drains} drains "
                          f"of {len(trace)} requests)")
            ok = False
        return ok
