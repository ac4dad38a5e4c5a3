"""``serving_load``'s ``router`` and ``disagg`` members on 2- and 4-rank
gloo worlds: the serving cluster's multi-controller drive.

Each engine runs on its own group of ranks (one rank an engine on the
2-rank world; two ranks an engine for ``router`` dp 2 and ``disagg`` p1+d1
on the 4-rank world, one for ``router`` dp 4; every engine on both ranks
for an elastic p2+d1, whose three engines do not divide two ranks), and
every rank takes the cluster's decisions from one shared view. Each world
is one spawn that runs every case of it through the sweep runner, with
rank 1's drain clock 100 ms ahead (``SKEW_S``, as
``test_torch_serving_load_multirank.py`` skews it); the two worlds start
together.

In the children the member's seeded weights are the JAX package's draws
carried by ``params_from_numpy``, and every call a rank makes on its
cluster (reset, submit, pump, drain) is logged. Then:

- every rank's row is valid, with the same ``serve_topology``;
- every rank holds the same ledger: completions with their tokens,
  shards, handoffs and clock stamps, rejections, counters and the pools'
  journal, drain by drain, so every rank took every decision alike;
- rank 0's log, replayed on the JAX package's single-controller cluster
  of JAX engines on ``(1, tp)`` meshes of the simulated devices, gives the
  same completions, token for token, the same counters and journal, and
  the completions and rejections partition the trace;
- one 2-rank case drains shard 1 mid-flight (``drain_shard`` on every
  rank after the first pump from the third on at which the shared view
  shows shard 1 holding work) and one runs elastic pools that resize.

Each world has a deadline, so a mismatch that hangs fails the test.
"""

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np
import pytest

import jax

from ddlb_tpu.models.decode import make_decode_fn as jax_make_decode_fn
from ddlb_tpu.models.serving import ContinuousBatchingEngine as JaxEngine
from ddlb_tpu.models.serving import Request as JaxRequest
from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
from ddlb_tpu.models.transformer import init_params as jax_init

#: the model of ``tests/test_torch_serving_cluster.py``'s ``WIDTH``
#: (vocab 64, d_model 64, 4 heads, d_ff 128, 2 layers, einsum attention),
#: float32, as the member's options and shape
MODEL = dict(vocab=64, n_heads=4, layers=2, attn_kernel="einsum")
SHAPE = dict(m=8, n=64, k=128)
SEED = 42
#: rank 1's head start on every drain's clock, seconds
SKEW_S = 0.1
#: seconds both worlds may take together; the test fails when it runs out
DEADLINE_S = 240
TRAFFIC = dict(batch=8, rate=200.0, n_requests=8, out_mean=3, out_max=5,
               slo_ttft_ms=4000.0, slo_tpot_ms=2000.0)

#: case -> (world, member, options, drain_shard from this pump on or None,
#: the topology stamp, engines a rank runs)
CASES = {
    "router_dp2": (2, "router", dict(dp=2, prefix_pop=2, prefix_len=4), None,
                   "router:dp=2", 1),
    "disagg_p1d1": (2, "disagg", dict(prefill_shards=1, decode_shards=1), None,
                    "disagg:p1+d1", 1),
    "router_drain": (2, "router", dict(dp=2, n_requests=10, out_mean=4, out_max=6), 3,
                     "router:dp=2:degraded=1", 1),
    "disagg_elastic": (2, "disagg", dict(prefill_shards=2, decode_shards=1, elastic=1,
                                         resize_backlog=1, resize_cooldown=2, batch=4,
                                         n_requests=12, out_mean=6, out_max=10, rate=500.0),
                       None, "disagg:p2+d1:elastic=", 3),
    "router_dp2_tp2": (4, "router", dict(dp=2, prefix_pop=2, prefix_len=4), None,
                       "router:dp=2", 1),
    "disagg_p1d1_tp2": (4, "disagg", dict(prefill_shards=1, decode_shards=1), None,
                        "disagg:p1+d1", 1),
    "router_dp4": (4, "router", dict(dp=4, cache_layout="paged", page_size=8), None,
                   "router:dp=4", 1),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _SkewedClock:
    """``time`` as the drain clock sees it on rank 1: ``perf_counter``
    returns ``SKEW_S`` less on the first reading after ``arm()``."""

    def __init__(self):
        self.armed = False

    def arm(self):
        self.armed = True

    def perf_counter(self):
        now = time.perf_counter()
        if self.armed:
            self.armed = False
            return now - SKEW_S
        return now

    def sleep(self, seconds):
        time.sleep(seconds)


def _row_config(member, options):
    return {"primitive": "serving_load", "impl_id": f"{member}_0",
            "base_implementation": member, "options": {**MODEL, **TRAFFIC, **options},
            **SHAPE, "dtype": "float32", "device": "cpu", "num_iterations": 1,
            "num_warmups": 0, "validate": True, "time_measurement_backend": "host_clock",
            "barrier_at_each_iteration": False}


def _rank_main(rank, world, port, cases, host_params, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from ddlb_tpu_torch.benchmark import benchmark_worker
    from ddlb_tpu_torch.models import transformer
    from ddlb_tpu_torch.primitives.serving_load import base, cluster_base
    from ddlb_tpu_torch.serve import cluster as cluster_module
    from ddlb_tpu_torch.workload import prefix_tokens

    # the JAX package's draws, carried over bit for bit
    transformer.init_params = lambda cfg, pp, n_experts, seed: transformer.params_from_numpy(
        host_params[n_experts], cfg, "cpu")
    clock = _SkewedClock()
    if rank == 1:
        base.time = clock
    state = {"log": [], "drains": [], "inject": None, "impl": None}
    Cluster, Load = cluster_module.ServingCluster, cluster_base.ClusterServingLoad
    submit, pump, drain_shard, reset = (Cluster.submit, Cluster.pump, Cluster.drain_shard,
                                        Cluster.reset)
    setup, drain = Load._input_setup, Load._drain

    def logged_reset(self):
        state["log"] = [("reset",)]
        return reset(self)

    def logged_submit(self, prompt, max_new, prefix_id=-1, now_s=0.0):
        state["log"].append(("submit", np.asarray(prompt).tolist(), int(max_new),
                             int(prefix_id), float(now_s)))
        return submit(self, prompt, max_new, prefix_id, now_s)

    def logged_pump(self, now_s):
        state["log"].append(("pump", float(now_s)))
        active = pump(self, now_s)
        # from the shared view, so every rank drains at the same pump
        shard = self._all[1]
        if (state["inject"] is not None and self._pump_count >= state["inject"]
                and not shard.excluded and shard.view.outstanding > 0):
            self.drain_shard(1, float(self._pump_count))
        return active

    def logged_drain_shard(self, shard, now_s):
        state["log"].append(("drain", int(shard), float(now_s)))
        return drain_shard(self, shard, now_s)

    def kept_setup(self):
        state["impl"] = self
        return setup(self)

    def recorded_drain(self):
        if rank == 1:
            clock.arm()
        drain(self)
        cl = self._cluster
        state["drains"].append((state["log"], {
            "completions": [(c.request_id, c.tokens.tolist(), c.shard, c.handoffs,
                             c.finished_by, c.first_s, c.finished_s) for c in cl.completions],
            "rejections": list(cl.rejections),
            "counters": dict(cl.counters),
            "pool_history": list(cl.pool_history),
        }))

    Cluster.submit, Cluster.pump, Cluster.drain_shard, Cluster.reset = (
        logged_submit, logged_pump, logged_drain_shard, logged_reset)
    Load._input_setup, Load._drain = kept_setup, recorded_drain
    out = {}
    try:
        for name, member, options, inject in cases:
            state.update(drains=[], inject=inject, impl=None)
            t0 = time.perf_counter()
            row = benchmark_worker(_row_config(member, options))
            impl = state["impl"]
            engine = impl._cluster.local_engines()[0]
            spec = impl.workload_spec()
            out[name] = {
                "row": {k: row.get(k) for k in ("valid", "error", "serve_topology",
                                                "slo_completed", "local_engines",
                                                "serve_rejected", "serve_resizes")},
                "drains": state["drains"],
                "setup": {
                    "options": dict(impl.options), "tp": impl._placement.tp,
                    "groups": impl._placement.groups,
                    "pools": impl._pool_sizes(), "max_batch": engine.B,
                    "max_len": engine.S_max,
                    "num_pages": engine.num_pages if engine.paged else None,
                    "prefix": prefix_tokens(spec, 0).tolist() if spec.prefix_pop else None,
                    "first_prompt": impl._trace[0].prompt.tolist(),
                    "n_requests": len(impl._trace),
                },
                "seconds": time.perf_counter() - t0,
            }
        # an exchange past the first round's buffer (its second round)
        from ddlb_tpu_torch.runtime import Runtime

        out["gather"] = Runtime("cpu").gather_objects((rank, np.arange(4000 + rank)))
        results.put((world, rank, "ok", out))
    except BaseException:
        results.put((world, rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds():
    """Both worlds, started together: ``{world: {rank: {case: result}}}``
    and the seconds they took."""
    host_params = {
        e: {k: np.asarray(v) for k, v in
            jax_init(JaxConfig(d_model=SHAPE["n"], d_ff=SHAPE["k"],
                               layers_per_stage=MODEL["layers"], vocab=MODEL["vocab"],
                               n_heads=MODEL["n_heads"]),
                     pp=1, n_experts=e, seed=SEED).items()}
        for e in (1, 2)
    }
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    t0 = time.perf_counter()
    for world in (2, 4):
        cases = [(name, member, options, inject)
                 for name, (w, member, options, inject, _, _) in CASES.items() if w == world]
        port = _free_port()
        procs += [ctx.Process(target=_rank_main,
                              args=(r, world, port, cases, host_params, results), daemon=True)
                  for r in range(world)]
    for p in procs:
        p.start()
    got = {2: {}, 4: {}}
    try:
        for _ in procs:
            remaining = DEADLINE_S - (time.perf_counter() - t0)
            world, rank, status, payload = results.get(timeout=max(remaining, 1.0))
            assert status == "ok", f"world {world}, rank {rank} failed:\n{payload}"
            got[world][rank] = payload
    except queue.Empty:
        raise AssertionError(f"the gloo worlds did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return got, time.perf_counter() - t0


def _by_rank(worlds, case):
    got, _ = worlds
    world = CASES[case][0]
    return [got[world][r][case] for r in range(world)]


@pytest.mark.parametrize("case", list(CASES))
def test_rows_valid_on_every_rank(worlds, case):
    """Each rank's row is valid and stamped alike; each rank runs the
    engines the placement gives it."""
    _, _, _, _, stamp, engines = CASES[case]
    for got in _by_rank(worlds, case):
        row = got["row"]
        assert row["valid"] and not row["error"], row["error"]
        assert row["serve_topology"].startswith(stamp), row["serve_topology"]
        assert row["local_engines"] == engines
        assert row["slo_completed"] + row["serve_rejected"] == got["setup"]["n_requests"]
    rows = [got["row"] for got in _by_rank(worlds, case)]
    assert all(row == rows[0] for row in rows)


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_one_ledger(worlds, case):
    """Drain by drain, every rank's completions (tokens, shard, handoffs,
    both clock stamps), rejections, counters and journal are rank 0's,
    though rank 1's clock runs ahead; the drain and the elastic cases
    acted."""
    ranks = _by_rank(worlds, case)
    drains = [[result for _, result in got["drains"]] for got in ranks]
    assert len(drains[0]) == 2
    for other in drains[1:]:
        assert other == drains[0]
    for result in drains[0]:
        if case == "router_drain":
            assert result["counters"]["shards_excluded"] == 1
            assert result["counters"]["drained"] > 0
            assert {c[2] for c in result["completions"] if c[3]} == {0}
        if case == "disagg_elastic":
            assert result["counters"]["resizes"] >= 1
            assert any(ev.startswith("promote:") for ev in result["pool_history"])
        if case.startswith("disagg"):
            assert result["counters"]["handoffs"] > 0


def _jax_cluster(setup):
    """The JAX package's cluster as the log's member built it: each JAX
    engine on a ``(1, tp)`` mesh of the simulated devices numbered as its
    group's ranks, the same weights, pools, knobs and prices."""
    from ddlb_tpu.perfmodel.cost import kv_bundle_bytes, kv_handoff_seconds
    from ddlb_tpu.perfmodel.specs import get_spec
    from ddlb_tpu.serve import PrefixAffinityRouter, ServingCluster

    o, tp = setup["options"], setup["tp"]
    n_pre, n_dec = setup["pools"]
    n_eng = n_pre + n_dec
    cfg = JaxConfig(vocab=o["vocab"], d_model=SHAPE["n"], n_heads=o["n_heads"],
                    n_kv_heads=o["n_kv_heads"], d_ff=SHAPE["k"],
                    layers_per_stage=o["layers"], mlp_kernel=o["mlp_kernel"],
                    kv_cache=o["kv_cache"], attn_kernel=o["attn_kernel"],
                    decode_kernel=o["decode_kernel"], cache_layout=o["cache_layout"],
                    page_size=o["page_size"])
    devices = jax.devices()
    engines, params = [], {}
    for e in range(n_eng):
        group = tuple(devices[r] for r in setup["groups"][e])
        mesh = jax.sharding.Mesh(np.asarray(group, dtype=object).reshape(1, tp), ("dp", "tp"))
        if group not in params:
            _, shardings = jax_make_decode_fn(mesh, cfg)
            host = jax_init(cfg, pp=1, n_experts=tp, seed=SEED)
            params[group] = {k: jax.device_put(v, shardings[k]) for k, v in host.items()}
        engine = JaxEngine(mesh, cfg, params[group], max_batch=setup["max_batch"],
                           max_len=setup["max_len"], num_pages=setup["num_pages"])
        if setup["prefix"] is not None:
            engine.set_shared_prefix(np.asarray(setup["prefix"], np.int32))
        engines.append(engine)

    def prewarm(engine):
        engine.submit(JaxRequest(np.asarray(setup["first_prompt"], np.int32), max_new=2))
        engine.admit_ready()
        while engine.active_slots() or engine.queue_depth:
            engine.step()
            engine.admit_ready()

    spec = get_spec("cpu-sim")
    return ServingCluster(
        engines[:n_dec], engines[n_dec:],
        router=PrefixAffinityRouter(n_dec, imbalance=float(o["affinity_imbalance"])),
        bundle_bytes=lambda t: kv_bundle_bytes(d_model=SHAPE["n"], n_heads=o["n_heads"],
                                               n_kv_heads=o["n_kv_heads"],
                                               layers=o["layers"], kv_cache=o["kv_cache"],
                                               tokens=t),
        handoff_seconds=lambda b: kv_handoff_seconds(b, spec),
        preempt_hol_ticks=o["preempt_hol_ticks"], elastic=bool(o["elastic"]),
        resize_backlog=int(o["resize_backlog"]), resize_cooldown=int(o["resize_cooldown"]),
        probe_interval=int(o["probe_interval"]),
        prewarm=prewarm if o["elastic"] else None,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_tokens_equal_the_jax_cluster(worlds, case):
    """Rank 0's calls, replayed on the JAX package's cluster: the same
    completions token for token, on the same shards after the same
    handoffs, the same rejections, counters and journal; completions and
    rejections partition the trace."""
    got = _by_rank(worlds, case)[0]
    jcl = _jax_cluster(got["setup"])
    n = got["setup"]["n_requests"]
    for log, result in got["drains"]:
        for call in log:
            if call[0] == "reset":
                jcl.reset()
            elif call[0] == "submit":
                jcl.submit(np.asarray(call[1], np.int32), call[2], call[3], now_s=call[4])
            elif call[0] == "pump":
                jcl.pump(call[1])
            else:
                jcl.drain_shard(call[1], call[2])
        want = sorted((c.request_id, np.asarray(c.tokens).tolist(), c.shard, c.handoffs,
                       c.finished_by) for c in jcl.completions)
        assert sorted(c[:5] for c in result["completions"]) == want
        assert result["rejections"] == list(jcl.rejections)
        assert result["counters"] == pytest.approx(jcl.counters)
        assert result["pool_history"] == list(jcl.pool_history)
        outcomes = [c[0] for c in result["completions"]] + result["rejections"]
        assert sorted(outcomes) == list(range(n))


@pytest.mark.parametrize("world", [2, 4])
def test_gather_objects_past_its_buffer(worlds, world):
    """``Runtime.gather_objects`` of parts larger than its first round's
    buffer: every rank holds every part, in rank order."""
    got, _ = worlds
    for rank in range(world):
        parts = got[world][rank]["gather"]
        assert [p[0] for p in parts] == list(range(world))
        for r, (_, values) in enumerate(parts):
            np.testing.assert_array_equal(values, np.arange(4000 + r))
