"""The port's serving cluster (``ddlb_tpu_torch/serve``, the ``router``
and ``disagg`` members of ``serving_load``) against the JAX package's.

Cheapest first: the admission bucket, the router's policy, the handoff
bundle, the census rate and the handoff price, the exoneration verdict
(each driven alike on both sides and compared exactly); then the cluster
facade on real tiny engines, where the completions must equal solo greedy
chains and the JAX cluster's tokens on the same requests (parameters
carried bit for bit by ``params_from_numpy``; float32 at this width
decides every argmax far from a tie): routed, disaggregated, a drain
mid-flight, the elastic promote and demote, probation, the probe cadence
and the straggler watch, with the JAX tests' stubs; then the members end
to end through the runner (the config's entries, the row's columns
against a JAX row's, the option schemas). World > 1 is
``test_torch_serving_cluster_multirank.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax

from ddlb_tpu.models.decode import make_decode_fn as jax_make_decode_fn
from ddlb_tpu.models.serving import ContinuousBatchingEngine as JaxEngine
from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
from ddlb_tpu.models.transformer import init_params as jax_init
from ddlb_tpu_torch.models import transformer as tmodel
from ddlb_tpu_torch.models.serving import ContinuousBatchingEngine, Request
from ddlb_tpu_torch.runtime import Runtime

WIDTH = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, layers_per_stage=2,
             attn_kernel="einsum")
SLOTS, S_MAX = 2, 48


# -- admission, routing, the bundle, the prices ---------------------------------


def _both(name):
    """(the JAX package's ``serve.<name>``, the port's)."""
    import ddlb_tpu.serve as jserve
    import ddlb_tpu_torch.serve as tserve

    return getattr(jserve, name), getattr(tserve, name)


def _schedule(seed, steps=60):
    """A seeded (tokens, now_s) schedule; the clock steps back now and then."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(steps):
        t = max(0.0, t + rng.uniform(-0.05, 0.3))
        out.append((float(rng.integers(1, 12)), t))
    return out


@pytest.mark.parametrize("rate,burst,seed", [(10.0, 20.0, 0), (1.0, 4.0, 1), (40.0, 8.0, 2)])
def test_token_bucket_decisions_equal_jax(rate, burst, seed):
    """One schedule through both buckets: every admit/reject, the level
    and the counters agree exactly."""
    JaxBucket, Bucket = _both("TokenBucket")
    jb, tb = JaxBucket(rate, burst), Bucket(rate, burst)
    for tokens, now in _schedule(seed):
        assert tb.try_take(tokens, now) == jb.try_take(tokens, now)
        assert tb.level(now) == jb.level(now)
    assert (tb.admitted, tb.rejected) == (jb.admitted, jb.rejected)
    assert tb.admitted and tb.rejected


class TestTokenBucket:
    def _bucket(self, rate=10.0, burst=20.0):
        return _both("TokenBucket")[1](rate, burst)

    def test_starts_full_and_debits_all_or_nothing(self):
        b = self._bucket()
        assert b.level(0.0) == 20.0
        assert b.try_take(15.0, 0.0)
        level = b.level(0.0)
        assert not b.try_take(10.0, 0.0)
        assert b.level(0.0) == level
        assert b.try_take(5.0, 0.0)

    def test_refill_cap_and_monotone_clock(self):
        b = self._bucket()
        assert b.try_take(20.0, 0.0)
        assert b.level(1.0) == pytest.approx(10.0)
        assert b.level(100.0) == pytest.approx(20.0)
        assert b.level(3.0) == pytest.approx(20.0)

    def test_validation(self):
        Bucket = _both("TokenBucket")[1]
        with pytest.raises(ValueError, match="rate_tps"):
            Bucket(0.0, 1.0)
        with pytest.raises(ValueError, match="burst_tokens"):
            Bucket(1.0, 0.0)


def _router_ops(seed, n=3, steps=80):
    """A seeded sequence of router calls: mostly routes (with or without a
    prefix, against random loads), with drops, readmissions, weights,
    growth, additions and removals between them."""
    rng = np.random.default_rng(seed)
    ops, width = [], n
    for _ in range(steps):
        kind = rng.choice(["route"] * 8 + ["drop", "readmit", "weight", "add", "remove"])
        shard = int(rng.integers(0, width))
        if kind == "add":
            width += int(rng.integers(0, 2))
            shard = int(rng.integers(0, width))
        ops.append((str(kind), shard, int(rng.integers(-1, 4)),
                    [float(x) for x in rng.integers(0, 12, width + 1)],
                    float(rng.uniform(1.0, 3.0))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_router_choices_equal_jax(seed):
    """One call sequence through both routers: every choice (or refusal),
    the affinity table, the hit count, the live set and the weights
    agree."""
    JaxRouter, Router = _both("PrefixAffinityRouter")
    jr, tr = JaxRouter(3, 1.5), Router(3, 1.5)
    routed = 0
    for kind, shard, prefix, loads, weight in _router_ops(seed):
        for r in (jr, tr):
            if kind == "drop":
                r.drop_shard(shard)
            elif kind == "readmit":
                r.readmit_shard(shard, weight)
            elif kind == "weight":
                r.set_weight(shard, weight)
            elif kind == "add":
                r.add_shard(shard)
            elif kind == "remove":
                r.remove_shard(shard)
        if kind == "route":
            outs = []
            for r in (jr, tr):
                try:
                    outs.append(r.route(prefix, loads))
                except RuntimeError as exc:
                    outs.append(str(exc))
            assert outs[0] == outs[1]
            routed += isinstance(outs[1], int)
        assert tr.affinity == jr.affinity and tr.affinity_hits == jr.affinity_hits
        assert tr.live_shards() == jr.live_shards() and tr.weights == jr.weights
    assert routed > 10


class TestPrefixAffinityRouter:
    def _router(self, n=3, imbalance=2.0):
        return _both("PrefixAffinityRouter")[1](n, imbalance)

    def test_least_outstanding_with_index_tiebreak(self):
        r = self._router()
        assert r.route(-1, [5, 2, 9]) == 1
        assert r.route(-1, [4, 4, 4]) == 0

    def test_affinity_sticks_until_imbalanced(self):
        r = self._router()
        first = r.route(7, [0, 0, 0])
        out = [0, 0, 0]
        out[first] = 2
        assert r.route(7, out) == first and r.affinity_hits == 1
        out[first] = 9
        assert r.route(7, out) != first

    def test_drop_readmit_weight_and_elastic_set(self):
        r = self._router()
        assert r.route(3, [0, 1, 1]) == 0
        r.drop_shard(0)
        assert 3 not in r.affinity and r.route(3, [0, 1, 1]) in (1, 2)
        r.readmit_shard(0, weight=2.0)
        assert r.route(-1, [1, 3, 3]) == 0
        r.set_weight(0, 3.0)
        assert r.route(-1, [2, 2, 2]) == 1
        grown = self._router(2)
        grown.grow(3)
        assert grown.live_shards() == [0, 1]
        grown.add_shard(2)
        assert grown.route(5, [9, 9, 0]) == 2
        grown.remove_shard(2)
        assert 5 not in grown.affinity

    def test_validation(self):
        Router = _both("PrefixAffinityRouter")[1]
        with pytest.raises(ValueError, match="n_shards"):
            Router(0)
        with pytest.raises(ValueError, match="imbalance"):
            Router(2, imbalance=0.5)
        with pytest.raises(ValueError, match="weight"):
            Router(2).set_weight(0, 0.5)
        r = Router(1)
        r.drop_shard(0)
        with pytest.raises(RuntimeError, match="no live shards"):
            r.route(-1, [0])


def test_kv_bundle_coerces_and_validates():
    JaxBundle, Bundle = _both("KVBundle")
    kw = dict(request_id=0, tokens=[1, 2, 3], generated=1, remaining=2, prefix_id=-1,
              kv_tokens=3, payload_bytes=10.0, produced_s=0.0)
    b = Bundle(**kw)
    assert b.tokens.dtype == np.int32 and b.tokens.tolist() == JaxBundle(**kw).tokens.tolist()
    with pytest.raises(ValueError, match="remaining"):
        Bundle(**dict(kw, remaining=0))


CENSUS_SHAPES = [
    dict(ctx=64, d_model=64, d_ff=128, vocab=128, n_heads=4, batch=4, n_kv_heads=0,
         layers=2, kv_cache="bf16", mlp_kernel="bf16", attn_kernel="einsum"),
    dict(ctx=512, d_model=2048, d_ff=8192, vocab=16384, n_heads=16, batch=8,
         n_kv_heads=4, layers=1, kv_cache="int8", mlp_kernel="int8_weights",
         attn_kernel="flash"),
]


def _jax_spec_like(spec):
    """A JAX ``ChipSpec`` with the port spec's numbers."""
    from ddlb_tpu.perfmodel.specs import ChipSpec as JaxSpec

    return JaxSpec(name=spec.name, peak_tflops={"bfloat16": 1.0},
                   hbm_gib=spec.hbm_bytes / float(1 << 30),
                   hbm_bw_gbs=spec.hbm_bw / 1e9, ici_bw_gbs=spec.link_bw / 1e9,
                   dcn_bw_gbs=1.0)


@pytest.mark.parametrize("chip", ["cpu", "h100-sxm"])
@pytest.mark.parametrize("shape", range(len(CENSUS_SHAPES)))
def test_census_rate_and_handoff_price_equal_jax(chip, shape):
    """``decode_token_rate``, ``kv_bundle_bytes`` and
    ``kv_handoff_seconds`` equal the JAX functions' under the same spec
    numbers; the port's CPU entry is JAX's ``cpu-sim``."""
    from ddlb_tpu.perfmodel.cost import kv_bundle_bytes as jax_bytes
    from ddlb_tpu.perfmodel.cost import kv_handoff_seconds as jax_seconds
    from ddlb_tpu.perfmodel.specs import get_spec
    from ddlb_tpu_torch.perfmodel.cost import kv_bundle_bytes, kv_handoff_seconds
    from ddlb_tpu_torch.perfmodel.specs import CHIP_SPECS

    spec = CHIP_SPECS[chip]
    jspec = get_spec("cpu-sim") if chip == "cpu" else _jax_spec_like(spec)
    if chip == "cpu":
        assert (spec.hbm_bw, spec.link_bw, spec.hbm_bytes) == (
            jspec.hbm_bw, jspec.link_bw("ici"), jspec.hbm_bytes)
    kw = dict(CENSUS_SHAPES[shape])
    jax_rate, rate = _both("decode_token_rate")
    for n_devices in (1, 4):
        want = jax_rate(spec=jspec, n_devices=n_devices, **kw)
        got = rate(spec=spec, n_devices=n_devices,
                   **{k: v for k, v in kw.items() if k != "attn_kernel"})
        assert got == pytest.approx(want, rel=1e-12)
        assert 0.0 < want < float("inf")
    for tokens in (0, 1, 17, 513):
        args = dict(d_model=kw["d_model"], n_heads=kw["n_heads"],
                    n_kv_heads=kw["n_kv_heads"], layers=kw["layers"],
                    kv_cache=kw["kv_cache"], tokens=tokens)
        nbytes = kv_bundle_bytes(**args)
        assert nbytes == jax_bytes(**args)
        assert kv_handoff_seconds(nbytes, spec) == jax_seconds(nbytes, jspec)


def test_chip_spec_by_device():
    """The CPU runtime's entry; the H100's by its name; another card
    raises, naming itself."""
    from ddlb_tpu_torch.perfmodel.specs import CHIP_SPECS, spec_for_device

    assert Runtime("cpu").chip_spec is CHIP_SPECS["cpu"]
    h100 = spec_for_device("cuda", "NVIDIA H100 80GB HBM3")
    assert (h100.name, h100.hbm_bw, h100.link_bw) == ("h100-sxm", 3.35e12, 4.5e11)
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        spec_for_device("cuda", "NVIDIA A100-SXM4-80GB")


def test_exoneration_verdict_equals_jax():
    """Every window history up to length 6, at the default thresholds and
    at others: the same verdict."""
    import itertools

    from ddlb_tpu.observatory import health as jax_health
    from ddlb_tpu_torch.observatory import health

    assert (health.MIN_OBSERVATIONS, health.DOMINANCE) == (
        jax_health.MIN_OBSERVATIONS, jax_health.DOMINANCE)
    verdicts = 0
    for n in range(7):
        for windows in itertools.product([False, True], repeat=n):
            for kw in ({}, dict(min_observations=2, dominance=0.5)):
                got = health.exoneration_verdict(windows, **kw)
                assert got == jax_health.exoneration_verdict(windows, **kw)
                verdicts += got
    assert verdicts > 0


# -- the cluster on real engines ------------------------------------------------

_PARAMS = []


def _params():
    if not _PARAMS:
        jc, tc = JaxConfig(**WIDTH), tmodel.TransformerConfig(**WIDTH)
        jp = jax_init(jc, pp=1, n_experts=1, seed=0)
        tp_ = tmodel.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
        mesh = jax.make_mesh((1, 1), ("dp", "tp"), devices=jax.devices()[:1])
        _, sh = jax_make_decode_fn(mesh, jc)
        jp = {k: jax.device_put(v, sh[k]) for k, v in jp.items()}
        _PARAMS.append((jc, tc, jp, tp_, mesh))
    return _PARAMS[0]


def _engines(n):
    """``n`` tp = 1 engines of the port and ``n`` of the JAX package on the
    same parameters, and a maker of the port's (a request's greedy chain
    is then slot- and engine-independent: solo replay is an exact oracle
    for anything the cluster schedules)."""
    jc, tc, jp, tp_, mesh = _params()
    tmesh = Runtime("cpu").mesh(1, 1)

    def make():
        return ContinuousBatchingEngine(tmesh, tc, tp_, max_batch=SLOTS, max_len=S_MAX)

    jax_engines = [JaxEngine(mesh, jc, jp, max_batch=SLOTS, max_len=S_MAX) for _ in range(n)]
    return [make() for _ in range(n)], jax_engines, make


def _solo(make, prompt, max_new):
    eng = make()
    eng.submit(Request(prompt, max_new=max_new))
    return eng.run()[0].tokens


def _requests(seed, count, lo=1, hi=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 64, int(rng.integers(4, 10))).astype(np.int32),
             int(rng.integers(lo, hi + 1))) for _ in range(count)]


def _pump_until_done(cluster, n, t=0.0, limit=500):
    while cluster.accounted < n:
        cluster.pump(t)
        t += 0.01
        limit -= 1
        assert limit > 0, "cluster failed to drain"
    return t


def _clusters(n_dec, n_pre=0, **kw):
    """The port's cluster and the JAX package's, built alike, and the
    port's engine maker."""
    from ddlb_tpu.serve import ServingCluster as JaxCluster
    from ddlb_tpu_torch.serve import ServingCluster

    ours, theirs, make = _engines(n_dec + n_pre)
    return (ServingCluster(ours[:n_dec], ours[n_dec:], **kw),
            JaxCluster(theirs[:n_dec], theirs[n_dec:], **kw), make)


def _assert_chains(cluster, jax_cluster, reqs, make, gids=None):
    """Every completion equals its solo chain and the JAX cluster's tokens
    for the same request; the counters agree."""
    gids = gids or {g: g for g in range(len(reqs))}
    want = {c.request_id: c for c in jax_cluster.completions}
    assert sorted(c.request_id for c in cluster.completions) == sorted(want)
    for c in cluster.completions:
        prompt, max_new = reqs[gids[c.request_id]]
        np.testing.assert_array_equal(c.tokens, _solo(make, prompt, max_new))
        w = want[c.request_id]
        np.testing.assert_array_equal(c.tokens, np.asarray(w.tokens))
        assert (c.shard, c.handoffs, c.finished_by) == (w.shard, w.handoffs, w.finished_by)
    assert cluster.counters == jax_cluster.counters
    assert cluster.pool_history == jax_cluster.pool_history


def _submit_all(clusters, reqs, now_s=0.0):
    for prompt, max_new in reqs:
        results = [cl.submit(prompt, max_new, now_s=now_s) for cl in clusters]
        assert results[0] == results[1]


class TestClusterExactness:
    def test_routed_matches_solo_chains_and_jax(self):
        ours, theirs, make = _clusters(2)
        reqs = _requests(0, 5)
        _submit_all((ours, theirs), reqs)
        _pump_until_done(ours, 5)
        _pump_until_done(theirs, 5)
        _assert_chains(ours, theirs, reqs, make)

    def test_disagg_handoff_chain_exact(self):
        """Prefill-pool first token + decode-pool continuation = the solo
        chain; one handoff per request with budget past its prefill."""
        price = dict(bundle_bytes=lambda kv_tokens: 100.0 * kv_tokens,
                     handoff_seconds=lambda b: b * 1e-9)
        ours, theirs, make = _clusters(2, 1, **price)
        reqs = _requests(1, 5)
        reqs[0] = (reqs[0][0], 1)
        _submit_all((ours, theirs), reqs)
        _pump_until_done(ours, 5)
        _pump_until_done(theirs, 5)
        assert ours.counters["handoffs"] == sum(1 for _, m in reqs if m > 1)
        assert ours.counters["handoff_bytes"] > 0 and ours.counters["handoff_s"] > 0
        for c in ours.completions:
            assert c.handoffs == (1 if reqs[c.request_id][1] > 1 else 0)
        _assert_chains(ours, theirs, reqs, make)

    def test_drain_mid_flight_exact_and_zero_lost(self):
        ours, theirs, make = _clusters(2)
        reqs = _requests(2, 6, 4, 8)
        _submit_all((ours, theirs), reqs)
        for cl in (ours, theirs):
            cl.pump(0.0)
            cl.pump(0.01)
            cl.drain_shard(1, 0.02)
        assert ours.queue_depths()[1] == -1
        assert ours.counters["shards_excluded"] == 1 and ours.counters["drained"] > 0
        _pump_until_done(ours, 6, 0.03)
        _pump_until_done(theirs, 6, 0.03)
        assert all(c.shard == 0 for c in ours.completions)
        _assert_chains(ours, theirs, reqs, make)

    def test_views_track_the_engines(self):
        """The shared view the decisions read equals each engine's own
        figures after every submission, pump and drain (at world 1 the
        exchange is the identity, so the view is the live state)."""
        from ddlb_tpu_torch.serve.cluster import EngineView

        ours, _, _ = _clusters(2, 1, bundle_bytes=lambda kv_tokens: 1.0 * kv_tokens)

        def same():
            for sh in ours._all:
                assert sh.view == EngineView.of(sh.engine), sh.index

        same()
        for prompt, max_new in _requests(3, 6, 2, 6):
            ours.submit(prompt, max_new, now_s=0.0)
            same()
        for i in range(3):
            ours.pump(0.01 * i)
            same()
        ours.drain_shard(1, 0.05)
        same()
        t = 0.06
        while ours.accounted < 6:
            ours.pump(t)
            same()
            t += 0.01

    def test_drain_last_shard_refused(self):
        ours, _, _ = _clusters(1)
        with pytest.raises(RuntimeError, match="last live decode shard"):
            ours.drain_shard(0, 0.0)

    def test_rejection_is_a_counted_outcome(self):
        Bucket = _both("TokenBucket")
        ours, theirs, _ = _clusters(1)
        ours.admission, theirs.admission = Bucket[1](1.0, 4.0), Bucket[0](1.0, 4.0)
        _submit_all((ours, theirs), [(np.array([1, 2, 3]), 4), (np.array([4, 5, 6]), 4)])
        _pump_until_done(ours, 2)
        assert [c.request_id for c in ours.completions] == [0]
        assert ours.rejections == [1] and ours.counters["rejected"] == 1


def _tick_clock(monkeypatch, engines, tick_s):
    """The cluster module's ``perf_counter`` becomes a clock that only
    engine steps advance, engine i's by ``tick_s[i]``: the watch's and the
    probes' medians are then exact, whatever the host's load."""
    from ddlb_tpu_torch.serve import cluster as cluster_module

    clock = SimpleNamespace(t=0.0)
    monkeypatch.setattr(cluster_module, "time",
                        SimpleNamespace(perf_counter=lambda: clock.t))
    for engine, dt in zip(engines, tick_s):
        def timed_step(step=engine.step, dt=dt):
            active = step()
            clock.t += dt
            return active

        engine.step = timed_step


class TestElasticPools:
    """The resize controller, probation and the watch on real tiny
    engines, with the JAX tests' stubs; solo chains stay the oracle."""

    def test_promote_exact_and_zero_lost(self):
        ours, theirs, make = _clusters(1, 2, elastic=True, resize_backlog=2,
                                       resize_cooldown=1000)
        reqs = _requests(7, 8, 4, 6)
        _submit_all((ours, theirs), reqs)
        assert len(ours.queue_depths()) == 1
        _pump_until_done(ours, 8)
        _pump_until_done(theirs, 8)
        assert ours.counters["resizes"] >= 1
        assert any(ev.startswith("promote:") for ev in ours.pool_history)
        assert len(ours.queue_depths()) == 2
        assert all(c.first_s <= c.finished_s for c in ours.completions)
        _assert_chains(ours, theirs, reqs, make)

    def test_demote_returns_promoted_shard_home(self):
        ours, theirs, make = _clusters(1, 2, elastic=True, resize_backlog=2,
                                       resize_cooldown=2)
        reqs = _requests(8, 8, 4, 6)
        _submit_all((ours, theirs), reqs)
        t = _pump_until_done(ours, 8)
        _pump_until_done(theirs, 8)
        assert any(ev.startswith("promote:") for ev in ours.pool_history)
        burst = _requests(9, 10, 1, 1)
        _submit_all((ours, theirs), burst, now_s=1.0)
        _pump_until_done(ours, 18, t)
        _pump_until_done(theirs, 18, t)
        assert any(ev.startswith("demote:") for ev in ours.pool_history)
        assert len([sh for sh in ours.prefill if sh.home_pool == "prefill"]) == 2
        assert all(sh.home_pool == "decode" for sh in ours.shards)
        _assert_chains(ours, theirs, reqs + burst, make)

    def test_probation_exonerates_healthy_shard(self, monkeypatch):
        """A drained but healthy shard earns its way back: every tick takes
        1 ms on a clock the test advances, so each probe window closes
        healthy, ``exoneration_verdict`` corroborates, and the shard
        re-enters the router's candidate set, counted and journaled."""
        from ddlb_tpu_torch.serve import ServingCluster

        engines, _, make = _engines(2)
        _tick_clock(monkeypatch, engines, (0.001, 0.001))
        cluster = ServingCluster(engines, watch_ticks=2, probation_ticks=2,
                                 probe_interval=1)
        reqs = _requests(10, 6, 3, 5)
        for prompt, max_new in reqs:
            cluster.submit(prompt, max_new, now_s=0.0)
        cluster.pump(0.0)
        cluster.pump(0.01)
        cluster.drain_shard(1, 0.02)
        sh = cluster._all[1]
        assert cluster.queue_depths()[1] == -1 and sh.probation
        t, limit = 0.03, 400
        while cluster.counters["readmitted"] < 1:
            cluster.pump(t)
            t += 0.01
            limit -= 1
            assert limit > 0, "healthy shard never exonerated"
        assert any(ev.startswith("exonerate:1@") for ev in cluster.pool_history)
        assert not sh.excluded and not sh.probation
        assert 1 in cluster.router.live_shards() and cluster.queue_depths()[1] >= 0
        _pump_until_done(cluster, 6, t)
        assert len(cluster.completions) == 6
        for c in cluster.completions:
            np.testing.assert_array_equal(c.tokens, _solo(make, *reqs[c.request_id]))

    def test_probe_interval_paces_probe_ticks(self):
        from ddlb_tpu_torch.serve import ServingCluster

        engines, _, _ = _engines(2)
        cluster = ServingCluster(engines, watch_ticks=2, probation_ticks=3,
                                 probe_interval=5)
        for prompt, max_new in _requests(11, 4):
            cluster.submit(prompt, max_new, now_s=0.0)
        cluster.pump(0.0)
        cluster.drain_shard(1, 0.01)
        probed = cluster._all[1].engine
        calls = {"n": 0}
        orig_step = probed.step

        def counted_step():
            calls["n"] += 1
            return orig_step()

        probed.step = counted_step
        start = cluster._pump_count
        for i in range(10):
            cluster.pump(0.02 + 0.01 * i)
        assert calls["n"] == sum(1 for p in range(start + 1, cluster._pump_count + 1)
                                 if p % 5 == 0)

    def test_watch_drains_the_slow_shard(self, monkeypatch):
        """The straggler drill: shard 1's decode ticks take 50 ms (a stub,
        the JAX drill's hang of the same length) and shard 0's 1 ms, on a
        clock the test advances (the cluster module's ``perf_counter``),
        so the verdict cannot depend on the host's load: shard 1 breaks
        the 10 ms TPOT SLO and dominates shard 0, the watch indicts it,
        its work drains to shard 0 over the handoff path, and every
        request still lands on its solo chain."""
        from ddlb_tpu_torch.serve import ServingCluster

        engines, _, make = _engines(2)
        _tick_clock(monkeypatch, engines, (0.001, 0.05))
        cluster = ServingCluster(engines, watch_ticks=4, slo_tpot_ms=10.0)
        reqs = _requests(12, 8, 8, 12)
        for prompt, max_new in reqs:
            cluster.submit(prompt, max_new, now_s=0.0)
        _pump_until_done(cluster, 8)
        assert cluster.counters["shards_excluded"] == 1
        assert cluster.counters["drained"] > 0 and cluster.counters["handoffs"] > 0
        assert cluster.queue_depths()[1] == -1
        for c in cluster.completions:
            np.testing.assert_array_equal(c.tokens, _solo(make, *reqs[c.request_id]))


# -- the members through the runner ---------------------------------------------


def _cluster_row_config(member, **options):
    base = {"batch": 8, "vocab": 64, "n_heads": 8, "layers": 1, "rate": 200.0,
            "n_requests": 6, "out_mean": 3, "out_max": 5, "slo_ttft_ms": 4000.0,
            "slo_tpot_ms": 2000.0}
    base.update(options)
    return {"primitive": "serving_load", "impl_id": f"{member}_0",
            "base_implementation": member, "options": base, "m": 8, "n": 32, "k": 64,
            "dtype": "float32", "num_iterations": 1, "num_warmups": 0, "validate": True,
            "time_measurement_backend": "host_clock", "barrier_at_each_iteration": False}


MEMBER_OPTIONS = {"router": dict(dp=2, prefix_pop=2, prefix_len=8),
                  "disagg": dict(prefill_shards=1, decode_shards=1)}


@pytest.mark.parametrize("member", ["router", "disagg"])
def test_row_carries_exactly_the_jax_columns(member):
    """A row of each member through each runner: valid, with the same
    ``slo_*`` / ``serve_*`` keys and the same topology stamp and shard
    count; the disaggregated rows price their handoffs."""
    from ddlb_tpu.benchmark import benchmark_worker as jax_worker
    from ddlb_tpu_torch.benchmark import benchmark_worker

    config = _cluster_row_config(member, **MEMBER_OPTIONS[member])
    theirs = jax_worker(config)
    ours = benchmark_worker(dict(config, device="cpu"))
    for row in (theirs, ours):
        assert row["valid"] and not row["error"], row["error"]
        assert row["slo_completed"] == 6
    keys = [{k for k in row if k.startswith(("slo_", "serve_"))} for row in (theirs, ours)]
    assert keys[1] == keys[0]
    for key in ("serve_topology", "serve_shards", "serve_handoffs", "serve_rejected"):
        assert ours[key] == theirs[key], key
    if member == "disagg":
        assert ours["serve_handoff_bytes"] == theirs["serve_handoff_bytes"] > 0
        assert ours["serve_handoff_ms"] > 0
    else:
        assert ours["serve_affinity_hits"] > 0 and ours["serve_prefix_hits"] > 0
    assert ours["prewarm_prefills"] > 0 and ours["prewarm_ticks"] > 0


def test_config_entries_and_census_admission(tmp_path):
    """``scripts/config_serving_load.json``'s ``router`` and ``disagg``
    entries give valid rows (every request completed, each drain's ticks
    and prefills counted); a token bucket at the census rate of the CPU
    entry and a tiny one, and an elastic p2+d1, account exactly."""
    from ddlb_tpu_torch.cli.benchmark import load_config, run_benchmark

    cfg = load_config("scripts/config_serving_load.json")["benchmark"]
    impls = {k: v for k, v in cfg["implementations"].items() if k in ("router", "disagg")}
    cfg.update(device="cpu", output_csv=str(tmp_path / "cfg.csv"), num_warmups=0,
               num_iterations=1, implementations=impls)
    rows = run_benchmark(cfg)
    assert [r["base_implementation"] for r in rows] == ["router", "router", "disagg"]
    for row in rows:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
        assert row["slo_completed"] == 24 and row["serve_rejected"] == 0
        assert row["drains"] == 2 and row["drain_ticks"] > 0 and row["drain_prefills"] > 0
    assert rows[2]["serve_topology"] == "disagg:p1+d1" and rows[2]["serve_handoffs"] > 0
    small = dict(batch=4, vocab=64, n_heads=4, n_requests=12, out_mean=6, out_max=10,
                 rate=500.0)
    more = run_benchmark({
        "primitive": "serving_load", "m": 8, "n": 32, "k": 64, "dtype": "float32",
        "device": "cpu", "num_iterations": 1, "num_warmups": 0,
        "time_measurement_backend": "host_clock", "barrier_at_each_iteration": False,
        "output_csv": str(tmp_path / "more.csv"),
        "implementations": {
            "router": [dict(small, dp=2, admission="token_bucket"),
                       dict(small, dp=2, admission="token_bucket", admission_rate_tps=5.0,
                            admission_burst_s=1.0)],
            "disagg": [dict(small, prefill_shards=2, decode_shards=1, elastic=1,
                            resize_backlog=1, resize_cooldown=2)],
        },
    })
    for row in more:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
        assert row["slo_completed"] + row["serve_rejected"] == 12
    assert more[1]["serve_rejected"] > 0
    assert more[2]["serve_topology"].startswith("disagg:p2+d1")


@pytest.mark.parametrize("member", ["router", "disagg"])
def test_option_schema_equals_jax(member):
    from ddlb_tpu.primitives.registry import load_impl_class as jax_load
    from ddlb_tpu_torch.primitives.registry import load_impl_class

    assert load_impl_class("serving_load", member).option_schema() == \
        jax_load("serving_load", member).option_schema()
