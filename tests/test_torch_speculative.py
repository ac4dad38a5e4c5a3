"""The port's verify chunk and speculative decoding against the JAX
package's, at small width.

Width: d_model 64, 4 heads of 16, d_ff 128, vocab 64, 2 layers (the draft
1), batch 4, prompts of 12. The JAX side runs on one device of the CPU
simulation, the port at world 1 on the CPU; parameters and caches are
carried across bit for bit (``params_from_numpy``, ``cache_from_numpy``).

Tolerances. Chunk logits and cache contents: float32 rtol 0, atol 1e-5
(the same float32 math in other summation orders), bfloat16 4e-2 (the
bf16 roundings ``tests/test_torch_transformer_decode.py`` describes);
int8 payloads within one quantization step in float32, two in bfloat16,
and their scales within 1e-5 relative in float32, 2e-2 in bfloat16 (the
row maximum is a bf16 value, and a K/V value that rounds to the
neighbouring bf16 number moves it by up to two ulps, 1.6%; measured
1.3%).
Chunk against sequential decode steps of the port: atol 1e-5 in float32
(a batched projection sums in another order than t single rows). Tokens
exactly, except under the int8 cache, where the verify chunk's batched
projection may round a K/V value into the next int8 bucket (the JAX
package's own ``tests/test_speculative.py`` allows it): there a chain may
leave the greedy one only at a step whose top-2 logit gap is below 2e-2,
and only to the other of the two.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddlb_tpu.models.decode as jdec
from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
from ddlb_tpu.models.transformer import init_params as jax_init
from ddlb_tpu_torch.cli.benchmark import run_benchmark
from ddlb_tpu_torch.models import decode as tdec
from ddlb_tpu_torch.models import transformer as tmodel
from ddlb_tpu_torch.ops import decode_attention as da
from ddlb_tpu_torch.primitives.registry import load_impl_class
from ddlb_tpu_torch.runtime import Runtime

WIDTH = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, layers_per_stage=2,
             attn_kernel="einsum")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 4e-2}
B, S0 = 4, 12


def _pair(dtype="float32", seed=0, **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc = JaxConfig(**{**WIDTH, **kw}, dtype=JDT[dtype])
    tc = tmodel.TransformerConfig(**{**WIDTH, **kw}, dtype=TDT[dtype])
    jp = jax_init(jc, pp=1, n_experts=1, seed=seed)
    tp_ = tmodel.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    return jc, tc, jp, tp_


def _mesh():
    return jax.make_mesh((1, 1), ("dp", "tp"), devices=jax.devices()[:1])


def _tmesh():
    return Runtime("cpu").mesh(1, 1)


def _tokens(rows, cols, seed=3):
    return np.random.default_rng(seed).integers(0, 64, (rows, cols)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _assert_cache_close(tcache, jcache, dtype):
    f32 = dtype == "float32"
    for name in tcache:
        got, want = tcache[name], np.asarray(jcache[name])
        if got.dtype == torch.int8:
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= (1 if f32 else 2), (name, diff.max())
        elif name.endswith("_scale"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5 if f32 else 2e-2, atol=0)
        elif name == "table":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(_np(got), want.astype(np.float32), rtol=0,
                                       atol=LOGIT_ATOL[dtype])


def _paged_caches(jc, S_max, page_size=8):
    """A JAX page pool whose table maps each sequence's pages to shuffled
    pool pages (the last page of sequence 0 unmapped), and its copy."""
    mp = S_max // page_size
    num_pages = B * mp + 3
    jcache = jdec.init_paged_cache(jc, B, S_max, num_pages, _mesh())
    ids = np.random.default_rng(7).permutation(num_pages)[:B * mp].reshape(B, mp)
    ids[0, -1] = num_pages
    jcache["table"] = jnp.asarray(ids.astype(np.int32))
    return jcache


CHUNK_CASES = {
    "bf16-contiguous": dict(),
    "int8-contiguous": dict(kv_cache="int8", n_kv_heads=2, rope=True),
    "bf16-paged": dict(cache_layout="paged", page_size=8, attn_window=6),
    "int8-paged": dict(cache_layout="paged", page_size=8, kv_cache="int8", n_kv_heads=2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CHUNK_CASES), ids=str)
def test_chunk_matches_jax(case, dtype):
    """Prefill, then two chunks (t = 3 and t = 4) on the same seeded
    parameters and cache: logits and every cache leaf against JAX."""
    jc, tc, jp, tp_ = _pair(dtype, **CHUNK_CASES[case])
    S_max = 24
    toks = _tokens(B, S0 + 7)
    mesh = _mesh()
    if tc.cache_layout == "paged":
        jcache = _paged_caches(jc, S_max)
    else:
        jcache = jdec.init_cache(jc, B, S_max, mesh)
    tcache = tdec.cache_from_numpy({k: np.asarray(v) for k, v in jcache.items()})
    jprefill, _ = jdec.make_prefill_fn(mesh, jc)
    _, jcache = jax.jit(jprefill)(jp, jcache, jnp.asarray(toks[:, :S0]))
    _, tcache = tdec.make_prefill_fn(_tmesh(), tc)(tp_, tcache, torch.from_numpy(toks[:, :S0]))
    jchunk, _ = jdec.make_chunk_decode_fn(mesh, jc)
    tchunk = tdec.make_chunk_decode_fn(_tmesh(), tc)
    for start, t in ((S0, 3), (S0 + 3, 4)):
        block = toks[:, start:start + t]
        jl, jcache = jax.jit(jchunk)(jp, jcache, jnp.asarray(block), jnp.int32(start))
        tl, tcache = tchunk(tp_, tcache, torch.from_numpy(block), start)
        assert tl.shape == (B, t, 64)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL[dtype])
    _assert_cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("kw", [dict(), dict(kv_cache="int8", n_kv_heads=2, rope=True),
                                dict(cache_layout="paged", page_size=8)],
                         ids=["bf16", "int8-gqa-rope", "paged"])
def test_chunk_equals_sequential_decodes(kw):
    """One chunk of t = 4 gives the logits of four decode steps at the
    same positions (float32), and writes the same rows."""
    _, tc, _, tp_ = _pair(**kw)
    m, S_max, t = _tmesh(), 24, 4
    toks = _tokens(B, S0 + t, seed=5)

    def filled():
        if tc.cache_layout == "paged":
            cache = tdec.init_paged_cache(tc, B, S_max, B * 3, device="cpu")
            cache["table"] = torch.arange(B * 3, dtype=torch.int32).reshape(B, 3)
        else:
            cache = tdec.init_cache(tc, B, S_max, device="cpu")
        return tdec.make_prefill_fn(m, tc)(tp_, cache, torch.from_numpy(toks[:, :S0]))[1]

    lc, cc = tdec.make_chunk_decode_fn(m, tc)(tp_, filled(), torch.from_numpy(toks[:, S0:]), S0)
    decode, cs, steps = tdec.make_decode_fn(m, tc), filled(), []
    for j in range(t):
        lg, cs = decode(tp_, cs, torch.from_numpy(toks[:, S0 + j]), S0 + j)
        steps.append(lg)
    np.testing.assert_allclose(lc.numpy(), torch.stack(steps, 1).numpy(), rtol=0, atol=1e-5)
    for name in cc:
        if cc[name].dtype == torch.int8:
            assert (cc[name].int() - cs[name].int()).abs().max() <= 1, name
        else:
            np.testing.assert_allclose(cc[name].float().numpy(), cs[name].float().numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_chunk_rejects_vector_start():
    _, tc, _, tp_ = _pair()
    chunk = tdec.make_chunk_decode_fn(_tmesh(), tc)
    cache = tdec.init_cache(tc, B, S0 + 2, device="cpu")
    with pytest.raises(ValueError, match="scalar start"):
        chunk(tp_, cache, torch.zeros((B, 2), dtype=torch.int32),
              torch.zeros(B, dtype=torch.int32))


def test_chunk_guards():
    _, tc, _, _ = _pair()
    with pytest.raises(ValueError, match="attention='gathered' only"):
        tdec.make_chunk_decode_fn(_tmesh(), replace(tc, attention="ring"))
    with pytest.raises(ValueError, match="block router"):
        tdec.make_chunk_decode_fn(_tmesh(), replace(tc, router="topk"))


def test_contiguous_chunk_past_the_cache_raises():
    """Where JAX's block write clamps its start onto live rows, the port's
    raises (``cache_write``'s docstring)."""
    _, tc, _, tp_ = _pair()
    cache = tdec.init_cache(tc, B, S0 + 2, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        tdec.make_chunk_decode_fn(_tmesh(), tc)(
            tp_, cache, torch.zeros((B, 3), dtype=torch.int32), S0)


def test_paged_chunk_write_drops_past_the_table_and_on_the_sentinel():
    """A chunk's rows go through the table: rows past it and rows on an
    unmapped page leave the pool as it was (JAX ``mode='drop'``)."""
    tc = tmodel.TransformerConfig(**WIDTH, cache_layout="paged", page_size=4)
    cache = tdec.init_paged_cache(tc, 2, 8, num_pages=3, device="cpu")
    cache["table"] = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)  # 3: unmapped
    k = torch.arange(1, 13, dtype=torch.float32).reshape(2, 6, 1, 1).expand(2, 6, 4, 16)
    tdec.cache_write(cache, 0, 3, k.contiguous(), k.contiguous(), False)
    # sequence 0: rows 3..7 (row 8 is past the table); sequence 1: rows 3
    # (page 2) only, rows 4..7 sit on the unmapped page
    assert cache["k"][0, 0, 3].eq(1).all()
    assert [int(cache["k"][0, 1, r, 0, 0]) for r in range(4)] == [2, 3, 4, 5]
    assert cache["k"][0, 2, 3].eq(7).all()
    assert int(cache["k"][0].ne(0).any(-1).any(-1).sum()) == 6


# -- speculative decoding ---------------------------------------------------------


def _jax_speculate(jc, jc_d, jp, jpd, prompt, n_new, k, with_stats=False):
    mesh = _mesh()
    spec, _ = jdec.make_speculate_fn(mesh, jc, jc_d, n_new=n_new, spec_k=k,
                                     with_stats=with_stats)
    Bp, S = prompt.shape
    return jax.jit(spec)(jp, jpd, jdec.init_cache(jc, Bp, S + n_new + k, mesh),
                         jdec.init_cache(jc_d, Bp, S + n_new + k, mesh),
                         jnp.asarray(prompt))


def _port_speculate(tc, tc_d, tp_, tpd, prompt, n_new, k, with_stats=False):
    spec = tdec.make_speculate_fn(_tmesh(), tc, tc_d, n_new=n_new, spec_k=k,
                                  with_stats=with_stats)
    Bp, S = prompt.shape
    return spec(tp_, tpd, tdec.init_cache(tc, Bp, S + n_new + k, device="cpu"),
                tdec.init_cache(tc_d, Bp, S + n_new + k, device="cpu"),
                torch.from_numpy(prompt))


def _port_greedy(tc, tp_, prompt, n_new):
    return tdec.make_generate_fn(_tmesh(), tc, n_new=n_new)(
        tp_, tdec.init_cache(tc, prompt.shape[0], prompt.shape[1] + n_new, device="cpu"),
        torch.from_numpy(prompt)).numpy()


def _draft(draft, kw, target):
    """(JAX draft config, port draft config, JAX draft params, port draft
    params): the target itself, or a 1-layer model from another seed."""
    if draft == "identical":
        return target
    return _pair(seed=1, **{**kw, "layers_per_stage": 1})


@pytest.mark.parametrize("n_new,k", [(1, 4), (2, 4), (3, 2), (12, 3)])
@pytest.mark.parametrize("draft", ["identical", "random"])
def test_speculate_equals_jax_and_greedy(draft, n_new, k):
    jc, tc, jp, tp_ = target = _pair()
    jc_d, tc_d, jpd, tpd = _draft(draft, {}, target)
    prompt = _tokens(B, S0, seed=11)
    got = _port_speculate(tc, tc_d, tp_, tpd, prompt, n_new, k).numpy()
    np.testing.assert_array_equal(got, _port_greedy(tc, tp_, prompt, n_new))
    np.testing.assert_array_equal(
        got, np.asarray(_jax_speculate(jc, jc_d, jp, jpd, prompt, n_new, k)))


@pytest.mark.parametrize("kw", [dict(n_kv_heads=2, rope=True), dict(attn_window=4),
                                dict(decode_kernel="pallas", n_kv_heads=2)],
                         ids=["gqa-rope", "window", "pallas"])
def test_speculate_levers_equal_greedy(kw):
    """The serving levers compose: tokens equal the port's greedy chain
    and JAX's speculative chain (the pallas draft steps on K11's plain
    version, the verify chunk on einsum)."""
    jc, tc, jp, tp_ = target = _pair(**kw)
    jc_d, tc_d, jpd, tpd = _draft("random", kw, target)
    prompt = _tokens(B, S0, seed=12)
    da.reset_launches()
    got = _port_speculate(tc, tc_d, tp_, tpd, prompt, 8, 3).numpy()
    np.testing.assert_array_equal(got, _port_greedy(tc, tp_, prompt, 8))
    np.testing.assert_array_equal(
        got, np.asarray(_jax_speculate(jc, jc_d, jp, jpd, prompt, 8, 3)))
    assert not any(da.LAUNCHES.values())


def _assert_chain_up_to_ties(got, want, params, cfg, prompt, tie_tol):
    """``got`` equals the greedy chain ``want`` but where a row leaves it at
    a step whose top-2 logit gap (the oracle on the agreed prefix) is
    below ``tie_tol``, to one of the two near-tied tokens."""
    S = prompt.shape[1]
    for i in np.argwhere((got[:, S:] != want[:, S:]).any(axis=1))[:, 0]:
        t = int(np.argmax(got[i, S:] != want[i, S:]))
        logits = tdec.reference_logits(params, torch.from_numpy(want[:, :S + t].copy()),
                                       cfg, tp=1, dp=1).numpy()[i]
        order = np.argsort(logits)
        gap = float(logits[order[-1]] - logits[order[-2]])
        assert gap < tie_tol, (i, t, gap)
        assert got[i, S + t] in order[-2:], (i, t)


def test_speculate_int8_cache_exact_up_to_ties():
    kw = dict(kv_cache="int8")
    jc, tc, jp, tp_ = target = _pair(**kw)
    jc_d, tc_d, jpd, tpd = _draft("random", kw, target)
    prompt = _tokens(B, S0, seed=13)
    got = _port_speculate(tc, tc_d, tp_, tpd, prompt, 12, 3).numpy()
    want = _port_greedy(tc, tp_, prompt, 12)
    _assert_chain_up_to_ties(got, want, tp_, tc, prompt, tie_tol=2e-2)
    theirs = np.asarray(_jax_speculate(jc, jc_d, jp, jpd, prompt, 12, 3))
    _assert_chain_up_to_ties(got, theirs, tp_, tc, prompt, tie_tol=2e-2)


@pytest.mark.parametrize("draft", ["identical", "random"])
def test_stats_invariants_match_jax(draft):
    """``rounds + accepted == n_new - 1``; an identical draft accepts
    everything in ``ceil((n_new - 1) / (k + 1))`` rounds (a last round
    overshooting) at a rate of exactly 1.0; the counters are JAX's."""
    n_new, k = 12, 4
    jc, tc, jp, tp_ = target = _pair()
    jc_d, tc_d, jpd, tpd = _draft(draft, {}, target)
    prompt = _tokens(B, S0, seed=14)
    toks, st = _port_speculate(tc, tc_d, tp_, tpd, prompt, n_new, k, with_stats=True)
    jt, js = _jax_speculate(jc, jc_d, jp, jpd, prompt, n_new, k, with_stats=True)
    assert st == {name: int(v) for name, v in js.items()}
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    assert st["rounds"] >= 1 and st["rounds"] + st["accepted"] == n_new - 1
    assert 0 <= st["accepted"] <= st["proposals"] <= st["rounds"] * k
    if draft == "identical":
        assert st["rounds"] == -(-(n_new - 1) // (k + 1))
        assert st["accepted"] == st["proposals"]


def test_speculate_rejects_small_caches_and_bad_arguments():
    _, tc, _, tp_ = _pair()
    m = _tmesh()
    spec = tdec.make_speculate_fn(m, tc, tc, n_new=4, spec_k=4)
    prompt = torch.from_numpy(_tokens(B, S0))
    small = tdec.init_cache(tc, B, S0 + 4, device="cpu")  # missing + spec_k
    big = tdec.init_cache(tc, B, S0 + 8, device="cpu")
    with pytest.raises(ValueError, match="target cache holds 16 positions < prompt 12 "
                                         r"\+ n_new 4 \+ spec_k 4"):
        spec(tp_, tp_, small, big, prompt)
    with pytest.raises(ValueError, match="draft cache holds"):
        spec(tp_, tp_, big, small, prompt)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        tdec.make_speculate_fn(m, tc, tc, n_new=4, spec_k=0)
    with pytest.raises(ValueError, match="n_new must be >= 1"):
        tdec.make_speculate_fn(m, tc, tc, n_new=0)
    with pytest.raises(ValueError, match="draft vocab 32 != target vocab 64"):
        tdec.make_speculate_fn(m, tc, replace(tc, vocab=32), n_new=4)


# -- phase=speculate ---------------------------------------------------------------

M, N, K = 16, 64, 64
COMMON = dict(batch=8, vocab=64, n_heads=8, layers=2, n_new=6, spec_k=2,
              draft_layers=1, attn_kernel="einsum")


def _rows(impls, dtype="float32"):
    return run_benchmark({
        "primitive": "transformer_decode", "m": M, "n": N, "k": K, "dtype": dtype,
        "device": "cpu", "num_iterations": 1, "num_warmups": 1,
        "output_csv": None, "implementations": impls,
    })


def test_speculate_rows_validate(tmp_path, monkeypatch):
    """spmd and compute_only, float32 and bfloat16, and the levers (int8
    GQA cache, the pallas draft, flash prefill): every row valid with the
    acceptance columns, ``rounds + accepted == n_new - 1``."""
    monkeypatch.chdir(tmp_path)
    rows = _rows({
        "spmd": [dict(phase="speculate", **COMMON),
                 dict(phase="speculate", **{**COMMON, "attn_kernel": "flash"},
                      kv_cache="int8", n_kv_heads=2, decode_kernel="pallas")],
        "compute_only": [dict(phase="speculate", **COMMON)],
    })
    rows += _rows({"spmd": [dict(phase="speculate", **COMMON)]}, dtype="bfloat16")
    assert len(rows) == 4
    for row in rows:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
        assert 0.0 <= row["spec_accept_rate"] <= 1.0
        accepted = round(row["spec_accept_rate"] * row["spec_proposals"])
        assert row["spec_rounds"] + accepted == COMMON["n_new"] - 1
        assert row["hbm_bytes"] > 0


def test_speculate_tokens_equal_the_generate_row():
    """The member's measured call returns the generate member's tokens."""
    cls = load_impl_class("transformer_decode", "spmd")
    spec = cls(M, N, K, dtype="float32", device="cpu", phase="speculate", **COMMON)
    opts = {key: v for key, v in COMMON.items() if key not in ("spec_k", "draft_layers")}
    gen = cls(M, N, K, dtype="float32", device="cpu", phase="generate", **opts)
    np.testing.assert_array_equal(spec.run().numpy(), gen.run().numpy())
    assert spec.validate(spec.run())


def test_compiled_refuses_speculate():
    cls = load_impl_class("transformer_decode", "compiled")
    with pytest.raises(ValueError, match="spmd/compute_only"):
        cls(M, N, K, dtype="float32", device="cpu", phase="speculate", batch=8,
            vocab=64, n_heads=8)


def test_speculate_counts_match_jax():
    """flops(), hbm_bytes() and the byte census's speculate entry are the
    JAX package's."""
    from types import SimpleNamespace

    from ddlb_tpu.primitives.transformer_decode.base import TransformerDecode as JaxTD
    from ddlb_tpu.utils.hbm_budget import decode_budget as jax_budget
    from ddlb_tpu_torch.utils import hbm_budget

    for opts in (dict(COMMON), dict(COMMON, spec_k=5, kv_cache="int8", n_kv_heads=4)):
        ours = load_impl_class("transformer_decode", "spmd")(
            M, N, K, dtype="float32", device="cpu", phase="speculate", **opts)
        theirs = SimpleNamespace(options=dict(ours.options), m=M, n=N, k=K, seed=ours.seed)
        assert ours.flops() == JaxTD.flops(theirs)
        assert ours.hbm_bytes() == pytest.approx(JaxTD.hbm_bytes(theirs), rel=1e-12)
    kw = dict(ctx=8192, d_model=2048, d_ff=8192, vocab=16384, n_heads=16, batch=8,
              phase="speculate", n_new=64, spec_k=4, draft_layers=2, layers=2,
              kv_cache="int8", n_kv_heads=4)
    theirs = jax_budget(**kw).components
    ours = hbm_budget.decode_budget(**kw)
    for name in ours:
        assert ours[name] == pytest.approx(theirs[name], rel=1e-12)
