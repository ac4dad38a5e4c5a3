"""The port's ``workload/`` against the JAX package's: the same spec and seed
give the same trace field for field, and the same event stream folds into
the same ``slo_*`` columns (both packages' modules are numpy and stdlib
only, so every comparison is exact)."""

import math
import re

import numpy as np
import pytest

from ddlb_tpu import workload as jwl
from ddlb_tpu_torch import workload as twl

SPECS = {
    "poisson": dict(n_requests=40, rate_rps=25.0),
    "bursty": dict(n_requests=40, rate_rps=10.0, process="bursty", burst_factor=3.0,
                   burst_duty=0.25, burst_len_s=0.5),
    "prefix": dict(n_requests=30, rate_rps=50.0, prefix_pop=4, prefix_len=16,
                   prefix_alpha=1.3, prompt_mean=32, prompt_sigma=0.8, out_mean=9,
                   out_max=20, vocab=128, seed=7),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_trace_equals_jax_field_for_field(name):
    ours = twl.generate_trace(twl.WorkloadSpec(**SPECS[name]))
    theirs = jwl.generate_trace(jwl.WorkloadSpec(**SPECS[name]))
    assert len(ours) == len(theirs) == SPECS[name]["n_requests"]
    for a, b in zip(ours, theirs):
        assert (a.index, a.arrival_s, a.max_new, a.prefix_id) == \
            (b.index, b.arrival_s, b.max_new, b.prefix_id)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert twl.WorkloadSpec(**SPECS[name]).max_total_tokens == \
        jwl.WorkloadSpec(**SPECS[name]).max_total_tokens


def test_prefix_tokens_equal_jax():
    spec = SPECS["prefix"]
    for pid in range(spec["prefix_pop"]):
        np.testing.assert_array_equal(
            twl.prefix_tokens(twl.WorkloadSpec(**spec), pid),
            jwl.prefix_tokens(jwl.WorkloadSpec(**spec), pid))
    with pytest.raises(ValueError, match="outside population"):
        twl.prefix_tokens(twl.WorkloadSpec(**spec), 4)


@pytest.mark.parametrize("bad", [dict(n_requests=0), dict(rate_rps=0.0),
                                 dict(process="closed"),
                                 dict(process="bursty", burst_factor=5.0),
                                 dict(prompt_min=0), dict(out_min=9, out_max=3),
                                 dict(prefix_pop=2), dict(vocab=1)])
def test_spec_validation_equals_jax(bad):
    kw = {**dict(n_requests=4, rate_rps=1.0), **bad}
    with pytest.raises(ValueError) as theirs:
        jwl.WorkloadSpec(**kw)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        twl.WorkloadSpec(**kw)


def test_streaming_quantiles_equal_jax():
    xs = np.random.default_rng(0).lognormal(2.0, 1.2, 5000)
    ours, theirs = twl.StreamingQuantile(), jwl.StreamingQuantile()
    for x in list(xs) + [0.0, -1.0, float("inf")]:
        ours.add(x)
        theirs.add(x)
    assert len(ours) == len(theirs)
    for q in (0.0, 0.05, 0.5, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    for q in (0.05, 0.5, 0.95, 0.99):
        exact = np.quantile(xs, q)
        assert abs(ours.quantile(q) - exact) <= 0.01 * exact
    assert math.isnan(twl.StreamingQuantile().quantile(0.5))


def _feed(tracker, drain, rng):
    """One drain's event stream: arrivals, queue gauges, first tokens (a
    re-stamp included), finishes (one-token requests included)."""
    n = 12
    if drain:
        tracker.new_drain()
    for i in range(n):
        tracker.arrived(i, 0.05 * i)
    for t in range(30):
        tracker.observe_queue(int(rng.integers(0, 6)))
    for i in range(n):
        t_first = 0.05 * i + float(rng.uniform(0.01, 0.4))
        tracker.first_token(i, t_first)
        tracker.first_token(i, t_first + 1.0)  # idempotent
        tracker.finished(i, t_first + float(rng.uniform(0.0, 0.5)),
                         int(rng.integers(1, 9)))


def test_slo_row_fields_equal_jax():
    ours, theirs = twl.SLOTracker(150.0, 40.0), jwl.SLOTracker(150.0, 40.0)
    for drain in range(3):
        for tracker in (ours, theirs):
            _feed(tracker, drain, np.random.default_rng(drain))
        a, b = ours.row_fields(1.7 * (drain + 1), 20.0), theirs.row_fields(1.7 * (drain + 1), 20.0)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == b[key] or (a[key] != a[key] and b[key] != b[key]), key
    assert ours.completed == theirs.completed == 36
    assert ours.queue_peak == theirs.queue_peak and ours.queue_recent == theirs.queue_recent
    empty = twl.SLOTracker(1.0, 1.0).row_fields(0.0, 1.0)
    assert math.isnan(empty["slo_goodput_rps"]) and math.isnan(empty["slo_ttft_p50_ms"])
