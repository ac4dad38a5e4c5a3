"""Sampling in the port's ``make_generate_fn`` against the JAX package's.

The top-k / top-p restriction is compared exactly: the port's
``restrict_logits`` masks the same tokens as the JAX package's ``_restrict``
(taken from its ``make_generate_fn`` closure) on the same float32 logits.
The draws themselves come from a ``torch.Generator`` where the JAX package
folds a PRNG key, so they cannot equal JAX's bit for bit; they are checked
by property: ``temperature=0`` is the greedy chain, a generator seeded alike
repeats its draws, and every drawn token lies in the set the restriction
keeps at its step (the logits of that step from the teacher-forced oracle
on the drawn prefix, which agree with the cache path's to ~1e-6, far from
any restriction threshold on these seeded draws).

Width: d_model 64, 4 heads of 16, d_ff 128, vocab 64, 2 layers, batch 4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddlb_tpu.models.decode as jdec
from ddlb_tpu.models.transformer import TransformerConfig as JaxConfig
from ddlb_tpu_torch.models import decode as tdec
from ddlb_tpu_torch.models import transformer as tmodel
from ddlb_tpu_torch.runtime import Runtime

WIDTH = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, layers_per_stage=2,
             attn_kernel="einsum")
B, S0, N_NEW = 4, 10, 6


def _jax_restrict(top_k, top_p):
    """The JAX package's ``_restrict`` closure of ``make_generate_fn``."""
    mesh = jax.make_mesh((1, 1), ("dp", "tp"), devices=jax.devices()[:1])
    generate, _ = jdec.make_generate_fn(mesh, JaxConfig(**WIDTH), n_new=1,
                                        temperature=1.0, top_k=top_k, top_p=top_p)
    cells = dict(zip(generate.__code__.co_freevars, generate.__closure__))
    sample = cells["sample"].cell_contents
    inner = dict(zip(sample.__code__.co_freevars, sample.__closure__))
    return inner["_restrict"].cell_contents


def _logits(seed, shape=(6, 64), scale=3.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (5, 1.0), (64, 1.0), (0, 0.5),
                                          (0, 0.9), (0, 1e-6), (8, 0.7), (3, 0.99)])
def test_restrict_mask_equals_jax(top_k, top_p):
    restrict = _jax_restrict(top_k, top_p)
    for seed in range(3):
        x = _logits(seed)
        want = np.isfinite(np.asarray(restrict(jnp.asarray(x))))
        got = torch.isfinite(tdec.restrict_logits(torch.from_numpy(x), top_k, top_p)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.any(axis=-1).all()  # never empty


def test_restrict_keeps_values_and_ties():
    """Kept logits are unchanged, and a tie at the k-th value keeps all."""
    x = torch.tensor([[3.0, 1.0, 3.0, 2.0, 0.5]])
    out = tdec.restrict_logits(x, top_k=2)
    assert torch.equal(torch.isfinite(out), torch.tensor([[True, False, True, False, False]]))
    assert torch.equal(out[torch.isfinite(out)], torch.tensor([3.0, 3.0]))
    assert torch.equal(tdec.restrict_logits(x), x)


def _setup(**kw):
    tc = tmodel.TransformerConfig(**WIDTH, **kw)
    params = tmodel.init_params(tc, pp=1, n_experts=1, seed=0)
    prompt = torch.from_numpy(
        np.random.default_rng(4).integers(0, 64, (B, S0)).astype(np.int32))
    return tc, params, prompt, Runtime("cpu").mesh(1, 1)


def _generate(tc, params, prompt, mesh, generator=None, **sampling):
    gen = tdec.make_generate_fn(mesh, tc, n_new=N_NEW, **sampling)
    return gen(params, tdec.init_cache(tc, B, S0 + N_NEW, device="cpu"), prompt,
               generator=generator)


def test_temperature_zero_is_greedy():
    tc, params, prompt, mesh = _setup()
    greedy = _generate(tc, params, prompt, mesh)
    for sampling in (dict(temperature=0.0, top_k=3), dict(temperature=0.0, top_p=0.5)):
        assert torch.equal(_generate(tc, params, prompt, mesh, **sampling), greedy)
    # top_k = 1 keeps only the argmax: any temperature draws the greedy chain
    assert torch.equal(
        _generate(tc, params, prompt, mesh, torch.Generator().manual_seed(3),
                  temperature=2.0, top_k=1),
        greedy)


def test_seeded_generator_repeats_its_draws():
    tc, params, prompt, mesh = _setup()
    runs = [_generate(tc, params, prompt, mesh, torch.Generator().manual_seed(seed),
                      temperature=1.5)
            for seed in (11, 11, 12)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0][:, :S0], prompt)


@pytest.mark.parametrize("sampling", [dict(temperature=1.3, top_k=4),
                                      dict(temperature=0.7, top_p=0.6),
                                      dict(temperature=2.0, top_k=10, top_p=0.8)],
                         ids=["top_k", "top_p", "both"])
def test_every_draw_lies_in_the_kept_set(sampling):
    tc, params, prompt, mesh = _setup(kv_cache="int8", n_kv_heads=2)
    top_k, top_p = sampling.get("top_k", 0), sampling.get("top_p", 1.0)
    for seed in range(3):
        out = _generate(tc, params, prompt, mesh, torch.Generator().manual_seed(seed),
                        **sampling)
        for t in range(N_NEW):
            logits = tdec.reference_logits(params, out[:, :S0 + t], tc, tp=1, dp=1)
            kept = torch.isfinite(
                tdec.restrict_logits(logits / sampling["temperature"], top_k, top_p))
            drawn = out[:, S0 + t].long()
            assert kept[torch.arange(B), drawn].all(), (seed, t)


def test_sampling_arguments_checked():
    tc, params, prompt, mesh = _setup()
    for bad, match in ((dict(top_p=0.0), "top_p must be in"),
                       (dict(top_p=1.5), "top_p must be in"),
                       (dict(top_k=-1), "top_k must be in"),
                       (dict(top_k=65), "top_k must be in")):
        with pytest.raises(ValueError, match=match):
            tdec.make_generate_fn(mesh, tc, n_new=2, **bad)
    with pytest.raises(ValueError, match="n_new must be >= 1"):
        tdec.make_generate_fn(mesh, tc, n_new=0)
    with pytest.raises(ValueError, match="sampling needs a torch.Generator"):
        _generate(tc, params, prompt, mesh, temperature=1.0)
