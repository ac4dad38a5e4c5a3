"""The port's pipeline schedule tables and stage-stack layout against the
JAX package, on the CPU.

- ``build_schedule``: every table (``kind``, ``mb``, ``chunk``,
  ``act_slot``, ``in_slot``, ``fwd_land``, ``bwd_land``), ``busy``,
  ``ticks``, ``act_slots`` and ``land_slots``, and so ``bubble_fraction``
  and ``peak_stash``, equal to the JAX package's exactly (integers: no
  tolerance) over schedule in {gpipe, 1f1b, interleaved}, d in {1, 2, 4,
  8}, microbatches in {1, 2, 4, 8, 16, 32} and virtual in {1, 2, 4} (1f1b
  only at virtual 1, interleaved only above it), and the same errors for
  the arguments the JAX package refuses;
- ``hops_due``: a tick's hop is due exactly when something lands at the
  next tick;
- ``models.pipeline.arrange_stage_stack`` equal to the JAX package's
  element for element (a permutation: no tolerance), leaves classified by
  name even where a replicated leaf's leading size equals the chain's
  depth, and an unknown leaf refused by both.
"""

import numpy as np
import pytest
import torch

from ddlb_tpu.models import pipeline as JP
from ddlb_tpu.models import transformer as J
from ddlb_tpu.utils import pipeline_schedule as JS
from ddlb_tpu_torch.models import pipeline as TP
from ddlb_tpu_torch.models import transformer as T
from ddlb_tpu_torch.utils import pipeline_schedule as TS

GRID = [
    (schedule, d, mb, v)
    for schedule in TS.SCHEDULES
    for d in (1, 2, 4, 8)
    for mb in (1, 2, 4, 8, 16, 32)
    for v in (1, 2, 4)
    if not (schedule == "1f1b" and v != 1) and not (schedule == "interleaved" and v < 2)
]


@pytest.mark.parametrize("schedule,d,mb,v", GRID, ids=lambda x: str(x))
def test_tables_equal_the_jax_packages(schedule, d, mb, v):
    got = TS.build_schedule(schedule, d, mb, v)
    want = JS.build_schedule(schedule, d, mb, v)
    for name in TS.TABLES + ("busy",):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    for name in ("schedule", "n_devices", "n_stages", "virtual", "microbatches", "ticks",
                 "act_slots", "land_slots", "bubble_fraction", "peak_stash"):
        assert getattr(got, name) == getattr(want, name), name


def test_grid_covers_every_valid_case():
    assert len(GRID) == 4 * 6 * (3 + 1 + 2)


@pytest.mark.parametrize(
    "schedule,v,match",
    [
        ("zigzag", 1, "unknown schedule 'zigzag'"),
        ("1f1b", 2, "1f1b is the virtual=1 schedule; use 'interleaved'"),
        ("interleaved", 1, "schedule='interleaved' needs virtual >= 2"),
    ],
)
def test_refusals_match_the_jax_packages(schedule, v, match):
    for build in (TS.build_schedule, JS.build_schedule):
        with pytest.raises(ValueError, match=match):
            build(schedule, 2, 4, v)


@pytest.mark.parametrize("schedule,d,mb,v", [("gpipe", 4, 8, 1), ("1f1b", 4, 8, 1),
                                             ("interleaved", 2, 4, 2), ("gpipe", 3, 5, 2)])
def test_hops_are_due_where_something_lands(schedule, d, mb, v):
    tables = TS.build_schedule(schedule, d, mb, v)
    for landing in (tables.fwd_land, tables.bwd_land):
        due = TS.hops_due(landing)
        assert due.shape == (tables.ticks,) and not due[-1]
        for t in range(tables.ticks - 1):
            assert due[t] == bool((landing[t + 1] >= 0).any())


def test_one_f_one_b_keeps_the_stash_shallow():
    """The memory story: at equal ticks and bubble gpipe stashes every
    microbatch, 1f1b at most the pipeline's depth; at virtual 2 the
    interleaved stash stays below the equal-depth gpipe's."""
    gpipe, ofob = (TS.build_schedule(s, 4, 16) for s in ("gpipe", "1f1b"))
    assert gpipe.ticks == ofob.ticks and gpipe.bubble_fraction == ofob.bubble_fraction
    assert gpipe.peak_stash == 16 and ofob.peak_stash <= 4
    inter, gpipe2 = (TS.build_schedule(s, 4, 16, 2) for s in ("interleaved", "gpipe"))
    assert gpipe2.peak_stash == 32 and inter.peak_stash < gpipe2.peak_stash


CONFIGS = {
    "mha": {},
    "gqa": {"n_kv_heads": 1},
    "ring": {"attention": "ring"},
    "int8_weights": {"mlp_kernel": "int8_weights"},
}


@pytest.mark.parametrize("pp,v", [(1, 2), (2, 2), (2, 3), (4, 2)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_arrange_stage_stack_equals_the_jax_packages(name, pp, v):
    opts = dict(vocab=pp * v, d_model=16, n_heads=2, d_ff=32, **CONFIGS[name])
    # vocab == pp * v: embed and head have the chain's depth as a leading or
    # trailing size and still must stay in place
    jcfg, cfg = J.TransformerConfig(**opts), T.TransformerConfig(**opts)
    params = {k: np.asarray(x) for k, x in J.init_params(jcfg, pp * v, n_experts=1, seed=3).items()}
    want = JP.arrange_stage_stack(params, pp, v, cfg=jcfg)
    tparams = T.params_from_numpy(params, cfg, device="cpu")
    for arranged in (TP.arrange_stage_stack(tparams, pp, v, cfg),
                     TP.arrange_stage_stack(tparams, pp, v)):
        assert set(arranged) == set(want)
        for leaf, x in want.items():
            got = arranged[leaf]
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 else got.numpy(),
                np.asarray(x), err_msg=leaf)
    assert np.array_equal(params["embed"], want["embed"])


def test_arrange_stage_stack_refuses_an_unknown_leaf():
    cfg = T.TransformerConfig()
    params = T.init_params(cfg, 4, n_experts=1)
    params["bogus"] = torch.zeros(4, 3)
    for arrange, c in ((TP.arrange_stage_stack, cfg), (JP.arrange_stage_stack, None)):
        host = {k: x.numpy() for k, x in params.items()} if arrange is JP.arrange_stage_stack \
            else params
        with pytest.raises(ValueError, match=r"missing from the spec table: \['bogus'\]"):
            arrange(host, 2, 2, c)
    # a leaf another configuration has, given a cfg without it
    with pytest.raises(ValueError, match="moe_w1_scale"):
        TP.arrange_stage_stack({**T.init_params(cfg, 2, 1),
                                "moe_w1_scale": torch.ones(2, 1, 1, 1, 64)}, 1, 2, cfg)
