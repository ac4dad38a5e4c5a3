"""The port's serving path against the JAX package's, at small width.

The JAX parameters (``init_params``) and caches are carried into the port
bit for bit (``params_from_numpy``, ``cache_from_numpy``); the JAX side
runs on one device of the CPU simulation (its Pallas kernels in interpret
mode, as on the CPU by itself), the port at world 1 on the CPU (its
kernel wrappers take their plain versions). Width: d_model 64, 4 heads of
16, d_ff 128, vocab 64, 2 layers, batch 4-8, prompts of 12-32.

Tolerances. float32: logits and cache contents at rtol 0, atol 1e-5
(the same float32 math in other summation orders; measured ~1e-6), int8
payloads within one quantization step and their scales at 1e-5 relative
(a second layer's k/v carry the first layer's ~1e-6 float32 skew, which
can flip a round() bucket, as the JAX package notes at its base.py:431),
tokens exactly (ties are measure-zero for seeded weights). bfloat16: the two compute the same
function with bf16 roundings in other places: XLA's CPU backend fuses
elementwise chains in float32, and the port rounds two products to bf16
where the JAX package keeps float32 (the first MLP product before the
activation, the attention output projection before its tp sum). Logits
and cache values within 4e-2 (5 bf16 ulps at magnitudes below 4; measured
up to 0.024), int8 payloads within 2 quantization steps and their scales
within 1%.

The int8 MLP modes (``mlp_kernel=int8|int8_weights``): the int8 leaves and
their scales bit for bit; logits in float32 within the family's 1e-4, in
bfloat16 within its 2e-2 times 2.5, the JAX family's rule for an int8 MLP
in half precision (a half-precision difference upstream of the MLP can
move a value across a quantization boundary; measured up to 0.032).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddlb_tpu.models.decode as jdec
from ddlb_tpu.models.serving import (
    ContinuousBatchingEngine as JaxEngine,
    Request as JaxRequest,
)
from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
from ddlb_tpu.models.transformer import init_params as jax_init
from ddlb_tpu_torch.cli.benchmark import run_benchmark
from ddlb_tpu_torch.models import decode as tdec
from ddlb_tpu_torch.models import transformer as tmodel
from ddlb_tpu_torch.models.serving import ContinuousBatchingEngine, Request
from ddlb_tpu_torch.ops import decode_attention as da
from ddlb_tpu_torch.ops import flash_attention as fa
from ddlb_tpu_torch.primitives.registry import load_impl_class
from ddlb_tpu_torch.runtime import Runtime

WIDTH = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, layers_per_stage=2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGIT_ATOL = {"float32": 1e-5, "bfloat16": 4e-2}

#: model options of the parity cases (the serving levers one by one,
#: then together)
CONFIGS = {
    "mha-flash": dict(),
    "mha-einsum": dict(attn_kernel="einsum"),
    "gqa-int8": dict(n_kv_heads=2, kv_cache="int8"),
    "rope-window": dict(rope=True, attn_window=5),
    "pallas": dict(decode_kernel="pallas"),
    "everything": dict(n_kv_heads=2, kv_cache="int8", rope=True, attn_window=6,
                       decode_kernel="pallas", attn_kernel="einsum"),
}


def _mesh(dp=1, tp=1):
    return jax.make_mesh((dp, tp), ("dp", "tp"), devices=jax.devices()[:dp * tp])


def _pair(dtype="float32", tp=1, **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc = JaxConfig(**WIDTH, dtype=JDT[dtype], **kw)
    tc = tmodel.TransformerConfig(**WIDTH, dtype=TDT[dtype], **kw)
    jp = jax_init(jc, pp=1, n_experts=tp, seed=0)
    tp_ = tmodel.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tc, "cpu")
    return jc, tc, jp, tp_


def _tokens(B, S, seed=3):
    return np.random.default_rng(seed).integers(0, 64, (B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x).astype(np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# -- parameters and the small pieces --------------------------------------------


@pytest.mark.parametrize("gqa", [False, True])
def test_init_params_match_jax_bit_for_bit(gqa):
    kw = dict(n_kv_heads=2) if gqa else {}
    jc, tc, jp, carried = _pair(tp=2, **kw)
    ours = tmodel.init_params(tc, pp=1, n_experts=2, seed=0)
    assert sorted(ours) == sorted(jp)
    for name in ours:
        assert torch.equal(ours[name], carried[name]), name


def test_params_from_numpy_keeps_bf16_bits():
    _, tc, jp, tp_ = _pair("bfloat16")
    for name, arr in jp.items():
        host = np.asarray(arr)
        assert tp_[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp_[name].view(torch.int16).numpy(), host.view(np.int16)
        )


def test_shard_params_follows_param_specs():
    _, tc, _, full = _pair(tp=2, n_kv_heads=2)
    for r in range(2):
        mine = tmodel.shard_params(full, tc, 2, r)
        assert torch.equal(mine["w_o"], full["w_o"][:, :, r * 32:(r + 1) * 32])
        assert torch.equal(mine["w_q"], full["w_q"][..., r * 32:(r + 1) * 32])
        assert torch.equal(mine["w_kv"], full["w_kv"][..., r * 16:(r + 1) * 16])
        assert torch.equal(mine["moe_w1"][:, :, 0], full["moe_w1"][:, :, r])
        assert torch.equal(mine["embed"], full["embed"])


@pytest.mark.parametrize(
    "fn", [tdec.init_cache, tdec.init_paged_cache, tmodel.params_from_numpy],
    ids=lambda f: f.__name__,
)
def test_model_entry_points_default_to_the_card(fn):
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_engine_keeps_its_caches_beside_the_params():
    tc = tmodel.TransformerConfig(**WIDTH, cache_layout="paged", page_size=8)
    eng = ContinuousBatchingEngine(Runtime("cpu").mesh(1, 1), tc,
                                   tmodel.init_params(tc, 1, 1), max_batch=2,
                                   max_len=16)
    assert {t.device.type for t in eng.cache.values()} == {"cpu"}


def test_rope_and_norm_match_jax():
    from ddlb_tpu.models.transformer import _rms_norm, apply_rope

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None]
    np.testing.assert_allclose(
        tmodel.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=0, atol=1e-5,
    )
    scale = rng.normal(1, 0.1, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(_rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=0, atol=1e-6,
    )


def test_example_tokens_match_jax():
    from ddlb_tpu.models.transformer import example_tokens

    for got, want in zip(tmodel.example_tokens(4, 9, 64, seed=5),
                         example_tokens(4, 9, 64, seed=5)):
        np.testing.assert_array_equal(got, np.asarray(want))


# -- prefill, decode, generate, the oracle ----------------------------------------


def _assert_cache_close(tcache, jcache, dtype):
    f32 = dtype == "float32"
    for name in tcache:
        got, want = tcache[name], np.asarray(jcache[name])
        if got.dtype == torch.int8:
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= (1 if f32 else 2), (name, diff.max())
        elif name.endswith("_scale"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5 if f32 else 1e-2, atol=0)
        else:
            np.testing.assert_allclose(_np(got), want.astype(np.float32), rtol=0,
                                       atol=LOGIT_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", list(CONFIGS), ids=str)
def test_prefill_and_decode_match_jax(config, dtype):
    jc, tc, jp, tp_ = _pair(dtype, **CONFIGS[config])
    B, S, S_max = 4, 16, 24
    toks = _tokens(B, S + 2)
    mesh, tm = _mesh(), Runtime("cpu").mesh(1, 1)

    jcache = jdec.init_cache(jc, B, S_max, mesh)
    jprefill, _ = jdec.make_prefill_fn(mesh, jc)
    jdecode, _ = jdec.make_decode_fn(mesh, jc)
    jl, jcache = jax.jit(jprefill)(jp, jcache, jnp.asarray(toks[:, :S]))
    tcache = tdec.init_cache(tc, B, S_max, tm, "cpu")
    tl, tcache = tdec.make_prefill_fn(tm, tc)(tp_, tcache, torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL[dtype])
    _assert_cache_close(tcache, jcache, dtype)

    # two scalar-position steps
    tdecode = tdec.make_decode_fn(tm, tc)
    for p in (S, S + 1):
        jl, jcache = jax.jit(jdecode)(jp, jcache, jnp.asarray(toks[:, p]), jnp.int32(p))
        tl, tcache = tdecode(tp_, tcache, torch.from_numpy(toks[:, p]), p)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL[dtype])
    _assert_cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("config", ["mha-einsum", "pallas", "everything"])
def test_ragged_decode_matches_jax(config):
    """Per-sequence positions, one of them parked at S_max (its write
    drops), on a cache carried from JAX."""
    jc, tc, jp, tp_ = _pair(**CONFIGS[config])
    B, S_max = 4, 24
    mesh, tm = _mesh(), Runtime("cpu").mesh(1, 1)
    jcache = jdec.init_cache(jc, B, S_max, mesh)
    jprefill, _ = jdec.make_prefill_fn(mesh, jc)
    _, jcache = jax.jit(jprefill)(jp, jcache, jnp.asarray(_tokens(B, 16)))
    tcache = tdec.cache_from_numpy({k: np.asarray(v) for k, v in jcache.items()})
    pos = np.array([3, 15, S_max, 9], np.int32)
    tok = _tokens(1, B, seed=8)[0]
    jdecode, _ = jdec.make_decode_fn(mesh, jc, ragged=True)
    jl, jcache = jax.jit(jdecode)(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, tcache = tdec.make_decode_fn(tm, tc, ragged=True)(
        tp_, tcache, torch.from_numpy(tok), torch.from_numpy(pos)
    )
    rows = [0, 1, 3]  # the parked lane's logits are ignored by every caller
    np.testing.assert_allclose(_np(tl)[rows], _np(jl)[rows], rtol=0, atol=1e-5)
    _assert_cache_close(tcache, jcache, "float32")


def test_paged_ragged_decode_matches_jax():
    """The paged step (K12's plain version) on a pool and table carried
    from JAX: sentinel tails, a parked all-sentinel lane."""
    jc, tc, jp, tp_ = _pair(cache_layout="paged", page_size=8, decode_kernel="pallas",
                            n_kv_heads=2, kv_cache="int8")
    B, S_max, P = 4, 32, 11
    mesh, tm = _mesh(), Runtime("cpu").mesh(1, 1)
    rng = np.random.default_rng(2)
    jcache = jdec.init_paged_cache(jc, B, S_max, P, mesh)
    table = np.full((B, S_max // 8), P, np.int32)
    table[0, :2], table[1, :3], table[3, :1] = [4, 7], [0, 9, 2], [10]
    jcache["table"] = jnp.asarray(table)
    for name in ("k", "v"):
        q, s = jdec._quantize_kv(jnp.asarray(rng.normal(0, 1, jcache[name].shape[:-1] + (16,)), jnp.float32))
        jcache[name], jcache[f"{name}_scale"] = q, s
    tcache = tdec.cache_from_numpy({k: np.asarray(v) for k, v in jcache.items()})
    pos = np.array([12, 20, S_max, 5], np.int32)
    tok = _tokens(1, B, seed=9)[0]
    jdecode, _ = jdec.make_decode_fn(mesh, jc, ragged=True)
    jl, jcache = jax.jit(jdecode)(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, tcache = tdec.make_decode_fn(tm, tc, ragged=True)(
        tp_, tcache, torch.from_numpy(tok), torch.from_numpy(pos)
    )
    np.testing.assert_allclose(_np(tl)[[0, 1, 3]], _np(jl)[[0, 1, 3]], rtol=0, atol=1e-5)
    _assert_cache_close(tcache, jcache, "float32")


@pytest.mark.parametrize("config", ["mha-flash", "gqa-int8", "everything"])
def test_generate_matches_jax(config):
    jc, tc, jp, tp_ = _pair(**CONFIGS[config])
    B, S0, n_new = 4, 12, 6
    prompt = _tokens(B, S0, seed=11)
    mesh, tm = _mesh(), Runtime("cpu").mesh(1, 1)
    jgen, _ = jdec.make_generate_fn(mesh, jc, n_new=n_new)
    want = np.asarray(jax.jit(jgen)(jp, jdec.init_cache(jc, B, S0 + n_new, mesh),
                                    jnp.asarray(prompt)))
    got = tdec.make_generate_fn(tm, tc, n_new=n_new)(
        tp_, tdec.init_cache(tc, B, S0 + n_new, tm, "cpu"), torch.from_numpy(prompt)
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["mha-flash", "gqa-int8", "rope-window"])
def test_reference_logits_match_jax(config, dtype):
    jc, tc, jp, tp_ = _pair(dtype, tp=2, **CONFIGS[config])
    toks = _tokens(8, 20)
    want = jdec.reference_logits(jp, toks, jc, tp=2, dp=2)
    got = tdec.reference_logits(tp_, torch.from_numpy(toks), tc, tp=2, dp=2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=LOGIT_ATOL[dtype])


def test_oracle_chunks_are_exact(monkeypatch):
    """Query chunking only splits rows: a tiny chunk budget gives the same
    attention as one block."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 13, 4, 16)).astype(np.float32))
               for _ in range(3))
    whole = tdec.oracle_attention(q, k[:, :, :2], v[:, :, :2], window=5)
    monkeypatch.setattr(tdec, "ORACLE_CHUNK_BYTES", 2 * 4 * 3 * 13 * 4)
    np.testing.assert_allclose(
        tdec.oracle_attention(q, k[:, :, :2], v[:, :, :2], window=5).numpy(),
        whole.numpy(), rtol=0, atol=1e-6,
    )


def test_expert_assignment_agrees_at_tp2():
    """Sequence i of a dp shard uses expert i // (B / (dp * tp)) on the JAX
    cache path at (dp 2, tp 2), the JAX oracle, and the port's oracle."""
    jc, tc, jp, tp_ = _pair(tp=2)
    toks = _tokens(8, 13)
    mesh = _mesh(2, 2)
    jprefill, sh = jdec.make_prefill_fn(mesh, jc)
    jdecode, _ = jdec.make_decode_fn(mesh, jc)
    params = {k: jax.device_put(v, sh[k]) for k, v in jp.items()}
    cache = jdec.init_cache(jc, 8, 13, mesh)
    _, cache = jax.jit(jprefill)(params, cache, jnp.asarray(toks[:, :12]))
    step, _ = jax.jit(jdecode)(params, cache, jnp.asarray(toks[:, 12]), jnp.int32(12))
    ours = tdec.reference_logits(tp_, torch.from_numpy(toks), tc, tp=2, dp=2)
    theirs = jdec.reference_logits(jp, toks, jc, tp=2, dp=2)
    np.testing.assert_allclose(ours.numpy(), _np(theirs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), _np(step), rtol=0, atol=1e-4)


# -- drop and fill ------------------------------------------------------------------


def test_ragged_write_past_the_cache_drops():
    tc = tmodel.TransformerConfig(**WIDTH)
    cache = tdec.init_cache(tc, 3, 8, device="cpu")
    k = torch.ones((3, 1, 4, 16))
    tdec.cache_write(cache, 1, torch.tensor([2, 8, 100], dtype=torch.int32), k, 2 * k, False)
    assert cache["k"][1, 0, 2].eq(1).all() and cache["v"][1, 0, 2].eq(2).all()
    assert cache["k"][1, 1:].eq(0).all() and cache["k"][0].eq(0).all()
    with pytest.raises(ValueError, match="do not fit"):
        tdec.cache_write(cache, 0, 8, k, k, False)


def test_paged_write_on_the_sentinel_drops_even_beside_a_kept_lane():
    """A parked lane's clamped coordinates coincide with a kept lane's
    target (last page, row 0): the kept write lands, the parked one drops."""
    tc = tmodel.TransformerConfig(**WIDTH, cache_layout="paged", page_size=4)
    cache = tdec.init_paged_cache(tc, 3, 8, num_pages=3, device="cpu")
    cache["table"][0] = torch.tensor([2, 3], dtype=torch.int32)  # page 2, unmapped
    k = torch.arange(1, 4, dtype=torch.float32)[:, None, None, None].expand(3, 1, 4, 16)
    pos = torch.tensor([0, 8, 4], dtype=torch.int32)  # kept, parked, unmapped
    tdec.cache_write(cache, 0, pos, k.contiguous(), k.contiguous(), False)
    assert cache["k"][0, 2, 0].eq(1).all()
    written = cache["k"][0].ne(0).any(-1).any(-1)
    assert int(written.sum()) == 1
    view = tdec.cache_read(cache, "k", 0, torch.float32)
    assert view[0, 0].eq(1).all() and view[0, 4:].eq(0).all() and view[1:].eq(0).all()


# -- the engine ---------------------------------------------------------------------


ENGINE_CASES = {
    "contiguous": dict(),
    "paged": dict(cache_layout="paged", page_size=8),
    "paged-half-pool": dict(cache_layout="paged", page_size=8, pool_frac=0.5),
    "paged-pallas-int8": dict(cache_layout="paged", page_size=8, pool_frac=0.5,
                              decode_kernel="pallas", kv_cache="int8", n_kv_heads=2),
}


def _workload():
    rng = np.random.default_rng(5)
    lengths, news = [12, 5, 17, 9, 20, 7], [6, 3, 8, 5, 2, 7]
    return [(rng.integers(1, 64, n).astype(np.int32), m) for n, m in zip(lengths, news)]


@pytest.mark.parametrize("case", list(ENGINE_CASES), ids=str)
def test_engine_completions_match_jax(case):
    opts = dict(ENGINE_CASES[case])
    frac = opts.pop("pool_frac", 1.0)
    jc, tc, jp, tp_ = _pair(attn_kernel="einsum", **opts)
    B, S_max = 4, 32
    num_pages = int(frac * B * S_max // 8) if "cache_layout" in opts else None
    jeng = JaxEngine(_mesh(), jc, jp, max_batch=B, max_len=S_max, num_pages=num_pages)
    teng = ContinuousBatchingEngine(Runtime("cpu").mesh(1, 1), tc, tp_, max_batch=B,
                                    max_len=S_max, num_pages=num_pages)
    for prompt, mn in _workload():
        jeng.submit(JaxRequest(prompt, max_new=mn))
        teng.submit(Request(prompt, max_new=mn))
    want, got = jeng.run(), teng.run()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g.request_index, g.slot, g.finished_by, g.admitted_at_step,
                g.finished_at_step) == (w.request_index, w.slot, w.finished_by,
                                        w.admitted_at_step, w.finished_at_step)
        np.testing.assert_array_equal(g.tokens, w.tokens)
    for field in ("steps", "generated", "admissions", "lane_ticks_active",
                  "peak_pages_in_use", "admissions_deferred"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


def test_engine_rejects_what_it_cannot_serve():
    tc = tmodel.TransformerConfig(**WIDTH, cache_layout="paged", page_size=8)
    params = tmodel.init_params(tc, 1, 1)
    eng = ContinuousBatchingEngine(Runtime("cpu").mesh(1, 1), tc, params, max_batch=2,
                                   max_len=16, num_pages=1)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(np.ones(10, np.int32), max_new=7))
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(np.ones(10, np.int32), max_new=2))
    with pytest.raises(ValueError, match="divisible by page_size"):
        ContinuousBatchingEngine(Runtime("cpu").mesh(1, 1), tc, params, max_batch=2, max_len=12)


# -- the primitive ------------------------------------------------------------------

M, N, K = 16, 64, 128
COMMON = dict(batch=8, vocab=64, n_heads=4, layers=2)


def _row_config(impls, **extra):
    return {
        "primitive": "transformer_decode", "m": M, "n": N, "k": K,
        "dtype": "float32", "device": "cpu", "num_iterations": 2,
        "num_warmups": 1, "output_csv": None, "implementations": impls,
        **extra,
    }


def test_every_phase_through_the_runner(tmp_path):
    """Every phase's row valid, with the serve engine's columns; the
    kernel wrappers (plain on the CPU) launch nothing."""
    impls = {
        "spmd": [
            dict(phase=["decode", "prefill"], decode_kernel=["einsum", "pallas"], **COMMON),
            dict(phase="generate", n_new=4, **COMMON),
            dict(phase="serve", n_new=5, n_requests=6, attn_kernel="einsum", **COMMON),
            dict(phase="serve", n_new=5, n_requests=6, cache_layout="paged",
                 page_size=16, page_pool_frac=0.5, decode_kernel="pallas",
                 kv_cache="int8", n_kv_heads=2, **COMMON),
        ],
        "compute_only": [dict(phase="decode", **COMMON)],
    }
    da.reset_launches()
    fa.reset_launches()
    rows = run_benchmark(_row_config(impls, output_csv=str(tmp_path / "td.csv")))
    assert len(rows) == 8
    for row in rows:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
        assert row["platform"] == "cpu" and row["Throughput (TFLOPS)"] > 0
        assert np.isfinite(row["hbm_bytes"]) and row["hbm_bytes"] > 0
    serve = [r for r in rows if "phase=serve" in r["option"]]
    assert len(serve) == 2
    for row in serve:
        assert 0 < row["serve_occupancy"] <= 1 and row["serve_prefix_hits"] == 0
        assert row["serve_generated"] == sum(1 + (i + 3) % 5 for i in range(6))
        assert row["serve_steps"] > 0
    assert "serve_peak_pages" in serve[1] and serve[1]["serve_pages_capacity"] > 0
    assert "serve_peak_pages" not in serve[0]
    assert not any(da.LAUNCHES.values()) and not any(fa.LAUNCHES.values())


def test_extra_row_fields_failure_keeps_the_times(monkeypatch):
    from ddlb_tpu_torch.primitives.transformer_decode import spmd

    def broken(self):
        raise RuntimeError("no stats")

    monkeypatch.setattr(spmd.SPMDTransformerDecode, "extra_row_fields", broken)
    (row,) = run_benchmark(_row_config({"spmd": [dict(COMMON)]}))
    assert row["valid"]
    assert "extra_row_fields failed: RuntimeError: no stats" in row["error"]
    assert np.isfinite(row["median time (ms)"])


def test_decode_iterations_are_identical():
    """The measured step writes its row in place at m, the same values each
    time: every iteration decodes the same position."""
    prim = load_impl_class("transformer_decode", "spmd")(
        M, N, K, dtype="float32", device="cpu", **COMMON
    )
    a, b = prim.run(), prim.run()
    assert torch.equal(a, b)
    assert prim.validate(b)


@pytest.mark.parametrize(
    "options,match",
    [
        (dict(dp=3, tp=2), "devices"),
        (dict(dp=1), "both dp and tp"),
        (dict(n_heads=5), "divisible by n_heads"),
        (dict(n_kv_heads=3), "not divisible by n_kv_heads"),
        (dict(phase="decode", cache_layout="paged"), "serving engine's pool"),
        (dict(page_size=64), "no effect"),
        (dict(page_pool_frac=0.5), "no effect"),
        (dict(phase="speculate"), "not yet ported"),
        (dict(mlp_kernel="int8", phase="speculate"), "not yet ported"),
        (dict(mlp_kernel="int8_weights", phase="speculate"), "not yet ported"),
        (dict(phase="bogus"), "not in allowed values"),
        (dict(page_pool_frac=2.0), "outside allowed range"),
        (dict(nope=1), "Unknown option"),
    ],
)
def test_option_errors(options, match):
    cls = load_impl_class("transformer_decode", "spmd")
    with pytest.raises(ValueError, match=match):
        cls(M, N, K, dtype="float32", device="cpu", **{**COMMON, **options})


def test_int8_mlp_rows_through_the_runner():
    """Both int8 MLP modes, decode and prefill, valid; the experts' int8
    GEMMs take K7's plain version on the CPU and launch nothing."""
    from ddlb_tpu_torch.ops import quantized_matmul as qm

    before = qm.LAUNCHES
    rows = run_benchmark(_row_config({"spmd": [dict(
        phase=["decode", "prefill"], mlp_kernel=["int8", "int8_weights"],
        **COMMON)]}, dtype="bfloat16"))
    assert len(rows) == 4
    for row in rows:
        assert row["valid"] and not row["error"], (row["option"], row["error"])
    assert qm.LAUNCHES == before


def test_dtype_and_compute_only_errors():
    with pytest.raises(ValueError, match="floating dtype"):
        load_impl_class("transformer_decode", "spmd")(
            M, N, K, dtype="int32", device="cpu", **COMMON)
    with pytest.raises(ValueError, match="1x1 mesh"):
        load_impl_class("transformer_decode", "compute_only")(
            M, N, K, dtype="float32", device="cpu", dp=1, tp=1, **COMMON)


@pytest.mark.parametrize(
    "opts",
    [
        dict(phase="decode"),
        dict(phase="prefill", attn_kernel="einsum", n_kv_heads=4),
        dict(phase="generate", kv_cache="int8", validate=False),
        dict(phase="serve", attn_kernel="einsum", layers=2),
    ],
    ids=lambda o: o["phase"],
)
def test_decode_budget_matches_jax_census(opts):
    """The weights and KV-cache components of the byte census, the two
    that ``hbm_bytes()`` reads, are the JAX package's at the serving
    path's full width (the JAX census's activation and slack terms, which
    size its memory gate, take options the port's census has no use
    for)."""
    from ddlb_tpu.utils.hbm_budget import decode_budget as jax_budget
    from ddlb_tpu_torch.utils import hbm_budget

    kw = dict(ctx=8192, d_model=2048, d_ff=8192, vocab=16384, n_heads=16,
              batch=8, **opts)
    theirs = jax_budget(**kw).components
    ours = hbm_budget.decode_budget(**{
        key: value for key, value in kw.items()
        if key not in ("attn_kernel", "validate")
    })
    assert set(ours) == {"weights", "kv_cache"}
    for name in ours:
        assert ours[name] == pytest.approx(theirs[name], rel=1e-12)


def test_counts_match_jax():
    """flops() and hbm_bytes() are the JAX family's census, option for
    option (its methods run on a stand-in holding the same options)."""
    from types import SimpleNamespace

    from ddlb_tpu.primitives.transformer_decode.base import TransformerDecode as JaxTD

    for opts in (dict(phase="decode"), dict(phase="prefill", n_kv_heads=2),
                 dict(phase="generate", n_new=5, kv_cache="int8"),
                 dict(phase="serve", n_new=5, n_requests=6)):
        ours = load_impl_class("transformer_decode", "spmd")(
            M, N, K, dtype="float32", device="cpu", **COMMON, **opts)
        theirs = SimpleNamespace(options=dict(ours.options), m=M, n=N, k=K,
                                 seed=ours.seed)
        theirs._serve_workload = lambda t=theirs: JaxTD._serve_workload(t)
        assert ours.flops() == JaxTD.flops(theirs)
        assert ours.hbm_bytes() == pytest.approx(JaxTD.hbm_bytes(theirs), rel=1e-12)


# -- the int8 MLP modes ----------------------------------------------------------

INT8_ATOL = {"float32": 1e-4, "bfloat16": 2e-2 * 2.5}


def test_init_params_int8_weights_match_jax_bit_for_bit():
    """The int8 expert weights and their float32 scales, drawn and
    quantized by the port, are the JAX package's leaves."""
    jc, tc, jp, carried = _pair("bfloat16", tp=2, mlp_kernel="int8_weights")
    ours = tmodel.init_params(tc, pp=1, n_experts=2, seed=0)
    assert sorted(ours) == sorted(jp)
    for name in ("moe_w1", "moe_w2"):
        assert ours[name].dtype == carried[name].dtype == torch.int8
        assert ours[f"{name}_scale"].dtype == torch.float32
        assert ours[f"{name}_scale"].shape == (1, 2, 2, 1, ours[name].shape[-1])
    for name in ours:
        assert torch.equal(ours[name], carried[name]), name
    for r in range(2):
        mine = tmodel.shard_params(carried, tc, 2, r)
        for name in ("moe_w1", "moe_w2", "moe_w1_scale", "moe_w2_scale"):
            assert torch.equal(mine[name][:, :, 0], carried[name][:, :, r]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_kernel", ["int8", "int8_weights"])
def test_int8_mlp_prefill_and_decode_match_jax(mlp_kernel, dtype):
    jc, tc, jp, tp_ = _pair(dtype, mlp_kernel=mlp_kernel)
    B, S, S_max = 4, 16, 24
    toks = _tokens(B, S + 1)
    mesh, tm = _mesh(), Runtime("cpu").mesh(1, 1)
    jcache = jdec.init_cache(jc, B, S_max, mesh)
    jprefill, _ = jdec.make_prefill_fn(mesh, jc)
    jdecode, _ = jdec.make_decode_fn(mesh, jc)
    jl, jcache = jax.jit(jprefill)(jp, jcache, jnp.asarray(toks[:, :S]))
    tcache = tdec.init_cache(tc, B, S_max, tm, "cpu")
    tl, tcache = tdec.make_prefill_fn(tm, tc)(tp_, tcache, torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=INT8_ATOL[dtype])
    jl, _ = jax.jit(jdecode)(jp, jcache, jnp.asarray(toks[:, S]), jnp.int32(S))
    tl, _ = tdec.make_decode_fn(tm, tc)(tp_, tcache, torch.from_numpy(toks[:, S]), S)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=INT8_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_kernel", ["int8", "int8_weights"])
def test_int8_mlp_reference_logits_match_jax(mlp_kernel, dtype):
    """The oracle over a (2, 2) routing: every expert's scales travel."""
    jc, tc, jp, tp_ = _pair(dtype, tp=2, mlp_kernel=mlp_kernel)
    toks = _tokens(8, 20)
    want = jdec.reference_logits(jp, toks, jc, tp=2, dp=2)
    got = tdec.reference_logits(tp_, torch.from_numpy(toks), tc, tp=2, dp=2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=INT8_ATOL[dtype])


def test_int8_weights_needs_its_scales():
    tc = tmodel.TransformerConfig(**WIDTH, mlp_kernel="int8_weights")
    params = tmodel.init_params(tc, pp=1, n_experts=1)
    x = torch.zeros((3, WIDTH["d_model"]))
    with pytest.raises(ValueError, match="w1_scale, w2_scale"):
        tmodel.moe_ffn(x, params["moe_w1"][0, 0, 0], params["moe_w2"][0, 0, 0],
                       "int8_weights", torch.float32)
