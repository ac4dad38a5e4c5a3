"""The ``cuda`` and ``overlap`` members of ``dp_allreduce`` and
``ep_alltoall`` at world 1, against the JAX members (``pallas``,
``overlap``) on a one-device mesh of the CPU simulation; their option and
shape rules; and ``scripts/config_dp_allreduce.json`` and
``config_ep_alltoall.json`` as they are through the port's CLI on the CPU.

At world 1 every collective is the identity, so these pin the local
arithmetic and the options (``test_torch_multirank.py`` runs every member
at d = 2). Tolerances: float32 at 1e-5; bfloat16 within one bf16 ulp (both
sides keep float32 sums and round once).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.options import OptionsManager
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port
from torch_parity import assert_within_bf16_ulps, to_numpy

REPO = Path(__file__).resolve().parent.parent
M, N, K = 64, 32, 48

DP_OVERLAP = [
    {"algorithm": "default"},
    {"algorithm": "coll_pipeline", "s": 4},
    {"algorithm": "coll_pipeline", "s": 8},
    {"algorithm": "p2p_pipeline", "direction": "unidirectional"},
    {"algorithm": "p2p_pipeline", "direction": "bidirectional"},
    {"algorithm": "chunked", "chunk_count": 2},
    {"algorithm": "chunked", "chunk_count": 4},
    {"algorithm": "chunked", "chunk_count": 8},
]
EP_OVERLAP = [
    {"algorithm": "default"},
    {"algorithm": "coll_pipeline", "s": 2},
    {"algorithm": "coll_pipeline", "s": 4},
    {"algorithm": "chunked", "chunk_count": 2},
    {"algorithm": "chunked", "chunk_count": 4},
    {"algorithm": "chunked", "chunk_count": 8},
]
#: (family, port member, options, JAX member)
PAIRS = (
    [("dp_allreduce", "overlap", o, "overlap") for o in DP_OVERLAP]
    + [("ep_alltoall", "overlap", o, "overlap") for o in EP_OVERLAP]
    + [("dp_allreduce", "cuda", {"algorithm": a}, "pallas")
       for a in ("xla_collective", "ring_rdma")]
    + [("ep_alltoall", "cuda", {"algorithm": a}, "pallas")
       for a in ("xla_collective", "a2a_rdma")]
)


def _one_device_mesh():
    return jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,ours,options,theirs", PAIRS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_member_matches_jax_at_world_one(family, ours, options, theirs, dtype):
    impl = load_port(family, ours)(M, N, K, dtype=dtype, device="cpu", **options)
    ref = load_jax(family, theirs)(M, N, K, dtype=dtype, mesh=_one_device_mesh(), **options)
    got, want = impl.run(), ref.run()
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got, want)
    assert impl.validate(got)


@pytest.mark.parametrize("family,options", [("dp_allreduce", o) for o in DP_OVERLAP[:5]]
                         + [("ep_alltoall", o) for o in EP_OVERLAP[:3]])
def test_overlap_integer_operands_exact(family, options):
    impl = load_port(family, "overlap")(M, N, K, dtype="int32", device="cpu", **options)
    got = impl.run()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), impl._expected_full())


def _bare(family, name, m, d, **options):
    """A member with its options parsed and ``d`` partitions, for the shape
    checks alone (the port's world here is 1)."""
    cls = load_port(family, name)
    impl = object.__new__(cls)
    impl.m, impl.n, impl.k, impl.num_partitions, impl.dtype = m, N, K * d, d, "float32"
    impl._options_manager = OptionsManager(*cls.option_schema())
    impl.options = impl._options_manager.parse(options)
    return impl


@pytest.mark.parametrize(
    "family,name,m,options,match",
    [
        ("dp_allreduce", "overlap", 100, {"algorithm": "coll_pipeline", "s": 8},
         "m=100 must be divisible by s=8 for coll_pipeline"),
        ("dp_allreduce", "overlap", 96, {"algorithm": "chunked", "chunk_count": 8},
         "m=96 must be divisible by partitions\\*chunk_count=64 for the chunked engine"),
        ("dp_allreduce", "overlap", 100, {"algorithm": "p2p_pipeline"},
         "m=100 must be divisible by 8 for p2p_pipeline \\(unidirectional\\)"),
        ("dp_allreduce", "overlap", 72,
         {"algorithm": "p2p_pipeline", "direction": "bidirectional"},
         "m=72 must be divisible by 16 for p2p_pipeline \\(bidirectional\\)"),
        ("ep_alltoall", "overlap", 128, {"algorithm": "coll_pipeline", "s": 4},
         "m=128 must be divisible by d\\^2\\*s=256 for coll_pipeline"),
        ("ep_alltoall", "overlap", 128, {"algorithm": "chunked", "chunk_count": 4},
         "m=128 must be divisible by d\\^2\\*chunk_count=256 for the chunked engine"),
        ("ep_alltoall", "cuda", 72, {"algorithm": "a2a_rdma"},
         "m=72 must be divisible by partitions\\^2=64"),
        ("dp_allreduce", "cuda", 100, {"algorithm": "ring_rdma"},
         "m=100 must be divisible by partitions=8 for algorithm=ring_rdma"),
    ],
)
def test_shape_pins_match_jax(family, name, m, options, match):
    """At d = 8 (the JAX world here) both packages refuse the same shapes
    with the same message."""
    jax_name = {"cuda": "pallas"}.get(name, name)
    with pytest.raises(ValueError, match=match):
        load_jax(family, jax_name)(m, N, K * 8, **options)
    with pytest.raises(ValueError, match=match):
        _bare(family, name, m, 8, **options)._check_shapes()


@pytest.mark.parametrize("family", ["dp_allreduce", "ep_alltoall"])
@pytest.mark.parametrize(
    "options,match",
    [
        ({"algorithm": "bogus"}, "not in allowed values"),
        ({"s": 0}, "outside allowed range"),
        ({"chunk_count": 0}, "outside allowed range"),
        ({"nope": 1}, "Unknown option"),
    ],
)
def test_overlap_option_rejections_match_jax(family, options, match):
    with pytest.raises(ValueError, match=match):
        load_jax(family, "overlap")(M, N, K, **options)
    with pytest.raises(ValueError, match=match):
        load_port(family, "overlap")(M, N, K, device="cpu", **options)


@pytest.mark.parametrize(
    "family,options,match",
    [
        ("dp_allreduce", {"detect_races": False},
         "\\['detect_races'\\] have no effect with algorithm='xla_collective'"),
        ("ep_alltoall", {"algorithm": "xla_collective", "detect_races": True},
         "\\['detect_races'\\] have no effect with algorithm='xla_collective'"),
        ("ep_alltoall", {"algorithm": "bogus"}, "not in allowed values"),
        ("dp_allreduce", {"algorithm": "a2a_rdma"}, "not in allowed values"),
    ],
)
def test_cuda_member_dead_options_match_jax(family, options, match):
    with pytest.raises(ValueError, match=match):
        load_jax(family, "pallas")(M, N, K, **options)
    with pytest.raises(ValueError, match=match):
        load_port(family, "cuda")(M, N, K, device="cpu", **options)


@pytest.mark.parametrize("family,algorithm", [("dp_allreduce", "ring_rdma"),
                                              ("ep_alltoall", "a2a_rdma")])
def test_cuda_member_rejects_the_race_detector_tiles_and_dtypes(family, algorithm):
    with pytest.raises(ValueError, match="race detector and has no CUDA counterpart"):
        load_port(family, "cuda")(M, N, K, device="cpu", algorithm=algorithm,
                                  detect_races=True)
    for option in ("block_m", "block_n", "block_k"):
        with pytest.raises(ValueError, match="TPU tiles and are not ported"):
            load_port(family, "cuda")(M, N, K, device="cpu", **{option: 128})
    with pytest.raises(ValueError, match="K1 matmul takes"):
        load_port(family, "cuda")(M, N, K, dtype="int32", device="cpu", algorithm=algorithm)
    impl = load_port(family, "cuda")(M, N, K, device="cpu", algorithm=algorithm,
                                     detect_races=False)
    assert impl.validate(impl.run())


def test_a2a_rdma_needs_16_byte_rows():
    with pytest.raises(ValueError, match="16-byte units"):
        load_port("ep_alltoall", "cuda")(M, 4, K, device="cpu", algorithm="a2a_rdma")
    load_port("ep_alltoall", "cuda")(M, 4, K, device="cpu")  # K1 takes any width


@pytest.mark.parametrize("config,families_rows", [
    ("config_dp_allreduce.json", {"compute_only": 2, "pytorch": 2, "overlap": 7, "cuda": 2}),
    ("config_ep_alltoall.json", {"compute_only": 2, "pytorch": 1, "overlap": 6}),
])
def test_sweep_config_runs_on_the_cpu(config, families_rows, tmp_path):
    """The config as it is, through the port's CLI (``jax_spmd`` and
    ``pallas`` run as ``pytorch`` and ``cuda``) at a small shape: every row
    valid but the ``jax_spmd_hier``, ``jax_spmd_striped`` and
    ``xla_gspmd`` rows, which stay 'not yet ported' error rows."""
    cfg = json.loads((REPO / "scripts" / config).read_text())["benchmark"]
    cfg.update(m=[64], n=[32], k=[48], num_iterations=2, num_warmups=1, device="cpu",
               output_csv=str(tmp_path / "rows.csv"))
    path = tmp_path / config
    path.write_text(json.dumps({"benchmark": cfg}))
    rows = port_cli.run_benchmark(port_cli.load_config(str(path)))
    unported = ("xla_gspmd", "jax_spmd_hier", "jax_spmd_striped")
    counts = {}
    for row in rows:
        base = row["base_implementation"]
        if base in unported:
            assert "not yet ported" in row["error"] and not row["valid"]
            continue
        assert row["valid"] and not row["error"] and row["unit"] == "TFLOPS", row
        counts[base] = counts.get(base, 0) + 1
    assert counts == families_rows
    assert len(rows) == sum(families_rows.values()) + 4
