"""The port's ``serving_load`` family against the JAX package's.

Nothing here asserts a latency: the drain is open-loop on the host clock,
so its timings vary run to run. What is checked: the config's ``engine``
and ``static`` entries run on the CPU with valid rows; each row carries
exactly the JAX row's ``slo_*`` / ``serve_*`` columns; the trace, the
option schema and the FLOP and byte counts are the JAX member's; the
head-of-line policy preempts under overload and the accounting still
holds; the cluster members load (their own tests are
``test_torch_serving_cluster.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from ddlb_tpu_torch.cli.benchmark import load_config, run_benchmark
from ddlb_tpu_torch.primitives import registry
from ddlb_tpu_torch.primitives.registry import load_impl_class

SMALL = dict(batch=4, vocab=64, n_heads=4, n_requests=8, out_mean=4, out_max=8,
             rate=400.0)


def _rows(impls, tmp_path, m=8, warmups=1, iterations=1):
    return run_benchmark({
        "primitive": "serving_load", "m": m, "n": 32, "k": 64, "dtype": "float32",
        "device": "cpu", "num_iterations": iterations, "num_warmups": warmups,
        "time_measurement_backend": "host_clock", "barrier_at_each_iteration": False,
        "output_csv": str(tmp_path / "sl.csv"), "implementations": impls,
    })


def _jax_row_keys():
    from ddlb_tpu.benchmark import benchmark_worker

    row = benchmark_worker({
        "primitive": "serving_load", "impl_id": "engine_0", "base_implementation": "engine",
        # the JAX runtime sees the 8-device simulation: tp = 8 needs 8 heads
        "options": dict(SMALL, batch=8, n_heads=8), "m": 8, "n": 32, "k": 64,
        "dtype": "float32",
        "num_iterations": 1, "num_warmups": 0, "validate": True,
        "time_measurement_backend": "host_clock", "barrier_at_each_iteration": False,
    })
    assert row["valid"] and not row["error"], row["error"]
    return {key for key in row if key.startswith(("slo_", "serve_"))}


def test_config_entries_run_on_the_cpu(tmp_path):
    """``scripts/config_serving_load.json``'s entries on the CPU: every
    row valid, the ``engine`` and ``static`` rows with the single-engine
    cluster columns, the ``router`` and ``disagg`` rows with their
    topology. Two drains a row (one timed, one validated), not the
    config's five: the slowest row's drain lasts its 2 s of arrivals."""
    cfg = load_config("scripts/config_serving_load.json")["benchmark"]
    cfg.update(device="cpu", output_csv=str(tmp_path / "cfg.csv"), num_warmups=0,
               num_iterations=1)
    rows = run_benchmark(cfg)
    by = {}
    for row in rows:
        by.setdefault(row["base_implementation"], []).append(row)
    assert [len(by[name]) for name in ("engine", "static", "router", "disagg")] == [6, 1, 2, 1]
    for row in by["engine"] + by["static"]:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
        assert row["slo_completed"] == 24 * (row["drains"] - 1)
        assert row["serve_topology"] == "single" and row["serve_shards"] == 1
        assert row["drain_prefills"] + row["drains"] * row["serve_prefix_hits"] >= 24
        assert row["unit"] == "TFLOPS" and row["hbm_bytes"] > 0
    paged = [r for r in by["engine"] if "cache_layout=paged" in r["option"]]
    assert len(paged) == 1 and paged[0]["serve_prefix_hits"] > 0
    assert paged[0]["serve_pages_capacity"] > 0
    for row in by["router"] + by["disagg"]:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
        assert row["slo_completed"] + row["serve_rejected"] == 24 * (row["drains"] - 1)
        assert row["serve_shards"] == 2 and row["drain_ticks"] > 0
    assert {r["serve_topology"] for r in by["router"]} == {"router:dp=2"}
    assert by["disagg"][0]["serve_topology"] == "disagg:p1+d1"


def test_row_carries_exactly_the_jax_columns(tmp_path):
    ours = _rows({"engine": [dict(SMALL)], "static": [dict(SMALL)]}, tmp_path)
    want = _jax_row_keys()
    for row in ours:
        assert row["valid"] and not row["error"], row["error"]
        assert {key for key in row if key.startswith(("slo_", "serve_"))} == want
        assert np.isfinite(row["slo_ttft_p95_ms"]) and row["slo_goodput_rps"] >= 0


def test_hol_preemption_fires_under_overload_and_accounts(tmp_path):
    """A burst of long generations pins every slot: the head-of-line
    policy preempts instead of waiting, rows are evicted, and every
    request still completes exactly once at its full budget (the
    validation). Pallas decode on a paged pool: K12's plain version."""
    (row,) = _rows({"engine": [dict(SMALL, rate=2000.0, n_requests=12, out_mean=30,
                                    out_max=40, preempt_hol_ticks=3)]}, tmp_path)
    assert row["valid"] and not row["error"], row["error"]
    assert row["serve_preemptions"] > 0 and row["serve_kv_evicted_tokens"] > 0
    (paged,) = _rows({"engine": [dict(SMALL, rate=2000.0, n_requests=12, out_mean=30,
                                      out_max=40, preempt_hol_ticks=3,
                                      cache_layout="paged", page_size=16,
                                      page_pool_frac=0.5, decode_kernel="pallas",
                                      prefix_pop=2, prefix_len=16)]}, tmp_path)
    assert paged["valid"] and not paged["error"], paged["error"]
    assert paged["serve_preemptions"] > 0


@pytest.mark.parametrize("member", ["router", "disagg"])
def test_cluster_members_not_yet_ported(member):
    """The cluster members are ported: each loads and the family lists all
    four. A family without a topology member raises the registry's
    unknown-member error."""
    assert load_impl_class("serving_load", member).__name__.lower().startswith(member)
    assert registry.implementation_names("serving_load") == (
        "engine", "static", "router", "disagg")
    with pytest.raises(ValueError, match="Unknown implementation 'pytorch_hier'"):
        load_impl_class("tp_columnwise", registry.port_member_name("jax_spmd_hier"))


@pytest.mark.parametrize("member", ["engine", "static", "router", "disagg"])
def test_schema_trace_and_counts_equal_jax(member):
    from ddlb_tpu.primitives.registry import load_impl_class as jax_load
    from ddlb_tpu.primitives.serving_load.base import ServingLoad as JaxServingLoad
    from ddlb_tpu.workload import generate_trace

    jax_cls = jax_load("serving_load", member)
    ours_cls = load_impl_class("serving_load", member)
    assert ours_cls.option_schema() == jax_cls.option_schema()
    opts = dict(SMALL, prefix_pop=3, prefix_len=6, n_kv_heads=2, kv_cache="int8")
    ours = ours_cls(8, 32, 64, dtype="float32", device="cpu", seed=3, **opts)
    theirs = SimpleNamespace(options=dict(ours.options), m=8, n=32, k=64, seed=3)
    theirs._trace = generate_trace(JaxServingLoad.workload_spec(theirs))
    assert len(ours._trace) == len(theirs._trace) == 8
    for a, b in zip(ours._trace, theirs._trace):
        assert a.arrival_s == b.arrival_s and a.max_new == b.max_new
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert ours.flops() == JaxServingLoad.flops(theirs)
    assert ours.hbm_bytes() == pytest.approx(JaxServingLoad.hbm_bytes(theirs), rel=1e-12)


@pytest.mark.parametrize("options,match", [
    (dict(n_heads=5), "not divisible by n_heads"),
    (dict(n_kv_heads=3), "must divide"),
    (dict(prefix_pop=2), "needs prefix_len"),
    (dict(process="closed"), "not in allowed values"),
])
def test_option_errors(options, match):
    with pytest.raises(ValueError, match=match):
        load_impl_class("serving_load", "engine")(8, 32, 64, dtype="float32",
                                                  device="cpu", **{**SMALL, **options})
    with pytest.raises(ValueError, match="floating dtype"):
        load_impl_class("serving_load", "static")(8, 32, 64, dtype="int32",
                                                  device="cpu", **SMALL)
