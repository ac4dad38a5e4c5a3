"""The port's continuous-batching engine features against the JAX
package's engine: the shared prefix, preemption, eviction, eos, unbucketed
prefill and the gauges.

Both engines run the same requests on the same parameters (carried bit for
bit, ``params_from_numpy``) on a (1, 1) mesh, driven by the same calls;
completions (tokens, slot, stop reason, admission and finish ticks) and
the counters are compared exactly: float32 at this width decides every
argmax far from a tie. Width: d_model 64, 4 heads of 16, d_ff 128, vocab
64, 2 layers, 4 slots, einsum prefill.
"""

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.models.serving import ContinuousBatchingEngine as JaxEngine
from ddlb_tpu.models.serving import Request as JaxRequest
from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
from ddlb_tpu.models.transformer import init_params as jax_init
from ddlb_tpu_torch.models import decode as tdec
from ddlb_tpu_torch.models import transformer as tmodel
from ddlb_tpu_torch.models.serving import ContinuousBatchingEngine, Request
from ddlb_tpu_torch.runtime import Runtime

WIDTH = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, layers_per_stage=2,
             attn_kernel="einsum")
SLOTS, S_MAX = 4, 48
LAYOUTS = {
    "contiguous": dict(),
    "paged": dict(cache_layout="paged", page_size=8),
    "paged-int8-pallas": dict(cache_layout="paged", page_size=8, kv_cache="int8",
                              n_kv_heads=2, decode_kernel="pallas"),
}
STATS = ("steps", "generated", "admissions", "lane_ticks_active", "prefix_hits",
         "prefill_tokens_saved", "preemptions", "kv_evicted_tokens", "pages_in_use",
         "peak_pages_in_use", "admissions_deferred")

_PARAMS = {}


def _params(layout):
    """(JAX config, port config, JAX params, port params), memoised."""
    if layout not in _PARAMS:
        kw = LAYOUTS[layout]
        jc, tc = JaxConfig(**WIDTH, **kw), tmodel.TransformerConfig(**WIDTH, **kw)
        jp = jax_init(jc, pp=1, n_experts=1, seed=0)
        tp_ = tmodel.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
        _PARAMS[layout] = jc, tc, jp, tp_
    return _PARAMS[layout]


def _engines(layout="contiguous", num_pages=None, **kw):
    """The JAX engine and the port's, built alike."""
    jc, tc, jp, tp_ = _params(layout)
    if num_pages is None and "cache_layout" in LAYOUTS[layout]:
        num_pages = 20
    mesh = jax.make_mesh((1, 1), ("dp", "tp"), devices=jax.devices()[:1])
    return (JaxEngine(mesh, jc, jp, max_batch=SLOTS, max_len=S_MAX, num_pages=num_pages, **kw),
            ContinuousBatchingEngine(Runtime("cpu").mesh(1, 1), tc, tp_, max_batch=SLOTS,
                                     max_len=S_MAX, num_pages=num_pages, **kw))


PREFIX = np.random.default_rng(9).integers(1, 64, 19).astype(np.int32)


def _workload(with_prefix=True):
    """Six requests; with ``with_prefix`` the even ones start with PREFIX."""
    rng = np.random.default_rng(5)
    out = []
    for i, (n, m) in enumerate(zip([12, 5, 17, 9, 20, 7], [6, 3, 8, 5, 2, 7])):
        body = rng.integers(1, 64, n).astype(np.int32)
        out.append((np.concatenate([PREFIX, body]) if with_prefix and i % 2 == 0 else body, m))
    return out


def _submit(engines, work):
    for prompt, m in work:
        engines[0].submit(JaxRequest(prompt, max_new=m))
        engines[1].submit(Request(prompt, max_new=m))


def _assert_same(jeng, teng):
    want, got = jeng.completions, teng.completions
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.request_index, g.slot, g.finished_by, g.admitted_at_step,
                g.finished_at_step) == (w.request_index, w.slot, w.finished_by,
                                        w.admitted_at_step, w.finished_at_step)
        np.testing.assert_array_equal(g.tokens, w.tokens)
    for field in STATS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


def _chains(completions):
    return {c.request_index: c.tokens.tolist() for c in completions}


@pytest.mark.parametrize("layout", list(LAYOUTS), ids=str)
def test_shared_prefix_matches_jax_and_the_plain_engine(layout):
    """With a prefix set, completions equal the JAX engine's and the port's
    own without a prefix (the chunked suffix prefill changes no token);
    prefix hits and the saved prefill tokens are counted."""
    engines = _engines(layout)
    for eng in engines:
        eng.set_shared_prefix(PREFIX)
    _submit(engines, _workload())
    for eng in engines:
        eng.run()
    _assert_same(*engines)
    assert engines[1].stats.prefix_hits == 3
    assert engines[1].stats.prefill_tokens_saved == 3 * PREFIX.size
    plain = _engines(layout)[1]
    for prompt, m in _workload():
        plain.submit(Request(prompt, max_new=m))
    plain.run()
    assert plain.stats.prefix_hits == 0
    assert _chains(plain.completions) == _chains(engines[1].completions)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_bucket_prefill_false_gives_the_same_chains(layout):
    buckets = _engines(layout)[1]
    exact = _engines(layout, bucket_prefill=False)
    for eng in (buckets, *exact):
        eng.set_shared_prefix(PREFIX)
    _submit(exact, _workload())
    for prompt, m in _workload():
        buckets.submit(Request(prompt, max_new=m))
    for eng in (buckets, *exact):
        eng.run()
    _assert_same(*exact)
    assert _chains(buckets.completions) == _chains(exact[1].completions)


@pytest.mark.parametrize("requeue", ["back", "front"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_preempt_resumes_the_same_chain_as_jax(layout, requeue):
    """Preempting a running request mid-generation requeues its remnant
    (back or front, as the JAX engine does: the queue heads agree); the
    remnant continues the chain it would have generated, and the engine's
    counters are JAX's."""
    engines = _engines(layout)
    _submit(engines, _workload(with_prefix=False))
    heads = []
    for eng in engines:
        eng.admit_ready()
        eng.step()
        eng.step()
        slot = eng.active_slots()[1]
        victim = eng.slot_request(slot)
        new_idx = eng.preempt(slot, requeue=requeue)
        heads.append((victim, new_idx, eng.queue_head(), eng.queue_depth))
        eng.run()
    assert heads[0] == heads[1]
    victim, new_idx, head, _ = heads[1]
    assert (head == new_idx) == (requeue == "front")
    _assert_same(*engines)
    teng = engines[1]
    assert teng.stats.preemptions == 1 and teng.stats.kv_evicted_tokens > 0
    baseline = _engines(layout)[1]
    for prompt, m in _workload(with_prefix=False):
        baseline.submit(Request(prompt, max_new=m))
    baseline.run()
    resumed = _chains(teng.completions)[new_idx]
    assert resumed == _chains(baseline.completions)[victim]


def test_paged_preemption_releases_its_pages():
    teng = _engines("paged")[1]
    teng.submit(Request(np.arange(1, 9, dtype=np.int32), max_new=10))
    teng.admit_ready()
    teng.step()
    in_use = teng.stats.pages_in_use
    assert in_use == 3
    teng.preempt(0)
    assert teng.stats.pages_in_use == 0 and sorted(teng._free_pages) == list(range(20))
    assert (teng.cache["table"] == 20).all()
    teng.run()
    assert teng.stats.pages_in_use == 0 and len(teng.completions) == 1
    with pytest.raises(ValueError, match="idle"):
        teng.preempt(0)
    with pytest.raises(ValueError, match="requeue"):
        teng.preempt(0, requeue="sideways")


def test_evict_and_drop_queue_return_the_remnants():
    """``evict`` folds the generated tokens into the remnant's prompt and
    hands it back; ``drop_queue`` empties the queue in FIFO order: both as
    the JAX engine's."""
    engines = _engines()
    _submit(engines, _workload(with_prefix=False))
    out = []
    for eng in engines:
        eng.admit_ready()
        eng.step()
        idx, remnant = eng.evict(eng.active_slots()[0])
        dropped = eng.drop_queue()
        out.append((idx, remnant.prompt.tolist(), remnant.max_new,
                    [(i, r.prompt.tolist(), r.max_new) for i, r in dropped],
                    eng.queue_depth, eng.stats.preemptions))
    assert out[0] == out[1]
    idx, prompt, max_new, dropped, depth, preemptions = out[1]
    work = _workload(with_prefix=False)
    assert len(prompt) == work[idx][0].size + 2 and max_new == work[idx][1] - 2
    assert [i for i, *_ in dropped] == [4, 5] and depth == 0 and preemptions == 1


def test_eos_stops_a_request():
    """A request that emits ``eos_id`` finishes there, by "eos", in both
    engines alike (eos is a token the greedy chains reach)."""
    probe = _engines()[1]
    for prompt, m in _workload(with_prefix=False):
        probe.submit(Request(prompt, max_new=m))
    probe.run()
    eos = int(max(probe.completions, key=lambda c: c.tokens.size).tokens[-3])
    engines = _engines(eos_id=eos)
    _submit(engines, _workload(with_prefix=False))
    for eng in engines:
        eng.run()
    _assert_same(*engines)
    stopped = [c for c in engines[1].completions if c.finished_by == "eos"]
    assert stopped and all(c.tokens[-1] == eos for c in stopped)


def test_gauges_match_jax():
    engines = _engines("paged")
    _submit(engines, _workload(with_prefix=False))
    seen = []
    for eng in engines:
        trail = []
        eng.admit_ready()
        for _ in range(4):
            trail.append((eng.queue_depth, eng.queue_head(), eng.active_slots(),
                          [eng.slot_request(s) for s in range(SLOTS)],
                          eng.outstanding_tokens(),
                          [eng.remaining_budget(s) for s in range(SLOTS)]))
            eng.step()
            eng.admit_ready()
        seen.append(trail)
    assert seen[0] == seen[1]


def test_prefix_survives_reset_and_none_clears():
    engines = _engines("paged")
    for eng in engines:
        eng.set_shared_prefix(PREFIX)
        eng.reset()
        assert eng.stats.pages_in_use == 2  # two full pages of 8, tp = 1
    _submit(engines, _workload())
    for eng in engines:
        eng.run()
    _assert_same(*engines)
    teng = engines[1]
    teng.set_shared_prefix(None)
    assert teng.stats.pages_in_use == 0 and teng._prefix_tokens is None
    with pytest.raises(ValueError, match="non-empty 1-D"):
        teng.set_shared_prefix(np.zeros((2, 3), np.int32))


def test_replaced_prefix_pages_return_after_their_last_slot():
    """A prefix replaced while a slot maps its pages keeps them until that
    slot finishes; then they return (no page is lost), as in JAX."""
    engines = _engines("paged")
    for eng in engines:
        eng.set_shared_prefix(PREFIX)
    _submit(engines, _workload()[:1])
    gauges = []
    for eng in engines:
        eng.admit_ready()
        eng.set_shared_prefix(PREFIX[:16][::-1].copy())
        during = eng.stats.pages_in_use
        eng.run()
        gauges.append((during, eng.stats.pages_in_use, len(eng._free_pages)))
    assert gauges[0] == gauges[1]
    during, after, free = gauges[1]
    assert during == 2 + 3 + 2 and after == 2 and free == 18
    _assert_same(*engines)


def test_pool_limits_with_a_prefix():
    teng = _engines("paged", num_pages=3)[1]
    with pytest.raises(ValueError, match="too small for the shared prefix"):
        teng.set_shared_prefix(np.arange(1, 33, dtype=np.int32))
    assert teng._prefix_tokens is None
    small = _engines("paged", num_pages=6)[1]
    small.submit(Request(np.arange(2, 21, dtype=np.int32), max_new=20))  # 5 pages
    small.set_shared_prefix(np.arange(1, 17, dtype=np.int32))  # pins 2, no match
    with pytest.raises(RuntimeError, match="can ever free"):
        small.admit_ready()
    with pytest.raises(ValueError, match="4 usable"):
        small.submit(Request(np.arange(2, 21, dtype=np.int32), max_new=20))


def test_chunked_suffix_logits_match_a_full_prefill():
    """The admission of a prefix hit (prefix rows seeded, the suffix as a
    verify chunk at ``start = P``) gives the first token's logits of a full
    prefill of the prompt, within 1e-5 (float32, another summation order)."""
    _, tc, _, tp_ = _params("contiguous")
    m = Runtime("cpu").mesh(1, 1)
    prompt = torch.from_numpy(_workload()[0][0][None])
    P = PREFIX.size
    full = tdec.make_prefill_fn(m, tc)(tp_, tdec.init_cache(tc, 1, prompt.shape[1], device="cpu"),
                                       prompt)[0]
    cache = tdec.init_cache(tc, 1, prompt.shape[1], device="cpu")
    _, cache = tdec.make_prefill_fn(m, tc)(tp_, cache, prompt[:, :P])
    chunk, _ = tdec.make_chunk_decode_fn(m, tc)(tp_, cache, prompt[:, P:], P)
    np.testing.assert_allclose(chunk[:, -1].numpy(), full.numpy(), rtol=0, atol=1e-5)
