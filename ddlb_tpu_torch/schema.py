"""The one registry of the port's result-row columns, a docstring each.

A copy of the JAX package's ``schema.py`` limited to the columns this
package writes: ``benchmark.make_result_row``'s (identity, statistics,
environment, the telemetry metric snapshot, the cost-model columns and
the cross-rank skew columns), then the columns a family adds through
``extra_row_fields``, the port's own among them (``device_kind``, the compiled member's
``compile_s``, ``dynamo_graphs`` and ``async_tp_fused``, the model
families' ``hbm_bytes``, the serving drains' counts). A shared column has
the JAX package's name and meaning; the port's name test holds every key
of a row, error rows included, to this registry.

Stdlib only, import-free.
"""

from __future__ import annotations

from typing import Dict

#: column name -> one-line docstring. Grouped by the code that writes the
#: column; the order is documentation, not the CSV order (the CSV header
#: is fixed by the first row written, widened by a member's own columns).
ROW_COLUMNS: Dict[str, str] = {
    # -- identity (make_result_row) ------------------------------------
    "implementation": "sweep impl id (base implementation + position)",
    "primitive": "primitive family name (registry.ALLOWED_PRIMITIVES)",
    "base_implementation": "implementation class key within the family",
    "option": "DEFAULT-merged option string, ';'-joined k=v pairs",
    "m": "GEMM/problem M dimension",
    "n": "GEMM/problem N dimension",
    "k": "GEMM/problem K dimension",
    "dtype": "operand dtype name",
    "unit": "what the Throughput column measures (TFLOPS or GB/s)",
    # -- measurement statistics (robust_stats over the times) ----------
    "mean time (ms)": "mean per-call latency over the timing loop",
    "std time (ms)": "standard deviation of per-call latency",
    "min time (ms)": "fastest timed call",
    "max time (ms)": "slowest timed call",
    "median time (ms)": "median per-call latency: the pinned statistic",
    "p95 time (ms)": "95th-percentile per-call latency",
    "Throughput (TFLOPS)": "mean flops()/time throughput (family unit)",
    "Throughput std (TFLOPS)": "std of the per-sample throughput",
    # -- environment ----------------------------------------------------
    "world_size": "ranks the row ran across (-1: the runtime never started)",
    "num_processes": "participating processes (one device each)",
    "hostname": "host that produced the row",
    "platform": "torch device type the row ran on (cuda / cpu / 'unknown')",
    "device_kind": "torch.cuda.get_device_name of the row's card ('cpu' on the host)",
    "time_measurement_backend": "host_clock or device_loop",
    "barrier_at_each_iteration": "whether each timed call barriered first",
    # -- telemetry metric snapshot (telemetry.ROW_METRIC_DEFAULTS) ------
    "barrier_wait_s": "summed Runtime.barrier() wait during the row",
    "loop_overhead_s": (
        "device_loop dispatch/fence slack: median over windows of host"
        " seconds minus CUDA-event seconds (0.0 on host_clock rows)"
    ),
    "hbm_high_water_bytes": "allocator peak when THIS config raised it",
    "collective_bytes": "per-device wire bytes/op from wire_bytes()",
    "hbm_peak_gib": (
        "allocator peak in GiB (only when raised by this row; NaN"
        " otherwise and on the CPU)"
    ),
    # -- the cost model (benchmark._perfmodel_fields over
    #    perfmodel/cost.py; defaults on rows whose member was never built)
    "predicted_s": "closed-form lower bound for this config (seconds)",
    "roofline_frac": "predicted_s / measured median, clamped to (0, 1]",
    "bound": "dominating roofline term: compute / comm / hbm",
    "chip": "hardware spec the prediction was made against (perfmodel/specs.py)",
    # -- the calibrated prediction (perfmodel/calib.py constants fitted
    #    from banked history; NaN / NaN / "" unless DDLB_TPU_CALIB names a
    #    table with a group for the row's chip and timing backend) --------
    "predicted_cal_s": (
        "calibrated absolute prediction: the analytical bound plus"
        " fitted per-hop latency / per-step overhead / dispatch"
        " constants through the schedule law (NaN when uncalibrated)"
    ),
    "cal_residual_frac": (
        "(measured median - predicted_cal_s) / predicted_cal_s:"
        " positive means slower than the fitted model (NaN when"
        " uncalibrated)"
    ),
    "cal_version": (
        "calibration-table fingerprint the row was priced against"
        " (perfmodel.calib.table_version); '' when uncalibrated"
    ),
    # -- measured-overlap attribution (observatory/attribution.py) -------
    "measured_overlap_frac": (
        "achieved overlap fraction: (serial floor - measured) / hideable,"
        " in [0, 1]; NaN off overlap members and on rows with no hideable"
        " window at the schedule's granularity (one-rank collective, zero"
        " comm or compute term, chunked engine at chunk_count=1)"
    ),
    "phase_compute_s": "model compute-phase floor (the compute term, seconds)",
    "phase_comm_s": "model comm-phase floor (the wire term, seconds)",
    "phase_idle_s": "measured time no roofline term explains (overhead)",
    # -- cross-rank skew attribution (telemetry/clocksync.py fold over
    #    the row's collective entry/exit stamps; defaults on
    #    single-process rows) ---------------------------------------------
    "skew_enter_s": (
        "summed arrival skew: per collective, how long it waited on its"
        " last-arriving rank (aligned max enter - min enter), seconds"
    ),
    "skew_exit_s": "summed collective exit spread (aligned), seconds",
    "straggler_rank": (
        "rank that caused the most arrival-skew seconds as the last"
        " arrival; -1 when no skew / single-process"
    ),
    "straggler_frac": (
        "skew_enter_s / total collective time: the share of the row's"
        " collective wall time spent waiting on last arrivals, in [0,1]"
    ),
    "clock_unc_s": (
        "worst-rank clock-alignment uncertainty bound (midpoint"
        " estimator, telemetry/clocksync.py) the skew columns carry"
    ),
    # -- validation / outcome -------------------------------------------
    "valid": "validation verdict (soft: recorded, never fatal)",
    "error": "error string; empty on measured rows",
    # -- family extras (impl.extra_row_fields; only on measured rows of
    #    the family) -------------------------------------------------------
    "compile_s": "compiled member: seconds of its first call (the compile)",
    "dynamo_graphs": "compiled member: Dynamo graphs its first call traced",
    "async_tp_fused": (
        "compiled member: collective matmuls async TP fused (None with"
        " the pass off)"
    ),
    "composition": (
        "resolved collective composition (flat / hierarchical / striped)"
        " stamped by the topology-adaptive members"
    ),
    "hbm_bytes": "model families: the call's device-memory traffic floor, bytes",
    "spec_accept_rate": "speculative decoding measured acceptance rate",
    "spec_rounds": "speculative decoding verify rounds measured",
    "spec_proposals": "speculative decoding proposed-token count",
    "serve_occupancy": "serving engine mean batch-slot occupancy",
    "serve_admissions_deferred": "serving admissions deferred by HBM gate",
    "serve_peak_pages": "serving paged-KV peak pages in use",
    "serve_pages_capacity": "serving paged-KV pool capacity",
    "serve_prefix_hits": "serving shared-prefix cache hits",
    "serve_steps": "transformer_decode phase=serve: the engine's decode ticks",
    "serve_generated": "transformer_decode phase=serve: tokens generated",
    # -- serving_load SLO telemetry (open-loop traffic drains) ----------
    "slo_offered_rps": "realized offered load: requests / arrival horizon",
    "slo_completed": "completions pooled over the row's post-warmup drains",
    "slo_ttft_p50_ms": "median time-to-first-token incl. queueing wait",
    "slo_ttft_p95_ms": "p95 time-to-first-token incl. queueing wait",
    "slo_ttft_p99_ms": "p99 time-to-first-token incl. queueing wait",
    "slo_tpot_p50_ms": "median per-output-token latency (steady decode)",
    "slo_tpot_p95_ms": "p95 per-output-token latency",
    "slo_tpot_p99_ms": "p99 per-output-token latency",
    "slo_e2e_p95_ms": "p95 end-to-end request latency (arrival to done)",
    "slo_goodput_rps": "completions meeting BOTH SLO bounds per second",
    "slo_attainment": "fraction of completions meeting both SLO bounds",
    "serve_queue_peak": "peak admission-queue depth over the drain",
    "serve_queue_mean": "mean admission-queue depth over the drain",
    "serve_preemptions": "requests preempted (requeued, KV evicted)",
    "serve_kv_evicted_tokens": "KV cache rows abandoned by preemptions",
    # -- serving cluster ledger (router and disagg members; single-engine
    #    rows carry "single" / zeros so a mixed sweep keeps one header) --
    "serve_topology": "cluster composition stamp (single, router:dp=N, disagg:pP+dD; :degraded=K after a drill; :elastic=R after pool resizes)",
    "serve_shards": "engines in the serving cluster (1 = single engine)",
    "serve_shards_excluded": "decode shards indicted and drained this row",
    "serve_rejected": "requests shed at the admission-control door",
    "serve_handoffs": "prefill->decode / drain KV-bundle handoffs",
    "serve_handoff_bytes": "KV bytes moved across engine handoffs (priced census)",
    "serve_handoff_ms": "priced cumulative handoff latency (not slept)",
    "serve_drained": "in-flight/queued requests migrated off indicted or resized shards",
    "serve_affinity_hits": "router dispatches that honored prefix affinity",
    "serve_resizes": "elastic pool transitions this row (promote + demote)",
    "serve_pool_history": "semicolon-joined transition journal (promote:3@120;exonerate:1@300)",
    "serve_readmitted": "indicted shards exonerated and re-admitted after probation",
    # -- serving_load drain counts (the port's own) ---------------------
    "drains": "serving_load: drains of the trace the row ran",
    "drain_ticks": "serving_load: decode ticks of this rank's engines over every drain",
    "drain_prefills": "serving_load: prompt prefills over every drain (prefix hits excluded)",
    "prewarm_ticks": "serving cluster: decode ticks of the set-up probes",
    "prewarm_prefills": "serving cluster: prompt prefills of the set-up probes",
    "local_engines": "serving cluster: engines this rank runs",
}
