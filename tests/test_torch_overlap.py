"""The overlap members and the cuda members' ring_rdma algorithm of both
tensor-parallel families at world 1, against the JAX members on a
one-device mesh of the CPU simulation; their option rules; and the repo's
two GEMM sweep configs through the port's CLI on the CPU.

At world 1 every collective is the identity, so these pin the local
arithmetic and the options (``test_torch_multirank.py`` runs every member
at d = 2 against the JAX members on a two-device mesh). Tolerances:
float32 at 1e-5; bfloat16 within one bf16 ulp (both sides keep float32
sums and round once: the ``p2p_pipeline`` accumulator of tp_rowwise too).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ddlb_tpu.primitives.registry import load_impl_class as load_jax
from ddlb_tpu_torch.cli import benchmark as port_cli
from ddlb_tpu_torch.primitives.registry import load_impl_class as load_port
from torch_parity import assert_within_bf16_ulps, to_numpy

REPO = Path(__file__).resolve().parent.parent
M, N, K = 64, 32, 48

OVERLAP_OPTIONS = [
    {"algorithm": "default"},
    {"algorithm": "coll_pipeline", "s": 4},
    {"algorithm": "coll_pipeline", "s": 8},
    {"algorithm": "p2p_pipeline", "direction": "unidirectional"},
    {"algorithm": "p2p_pipeline", "direction": "bidirectional"},
    {"algorithm": "chunked", "chunk_count": 2},
    {"algorithm": "chunked", "chunk_count": 4},
    {"algorithm": "chunked", "chunk_count": 8},
]
#: (port member, options, JAX member)
PAIRS = [("overlap", o, "overlap") for o in OVERLAP_OPTIONS] + [
    ("cuda", {"algorithm": "ring_rdma"}, "pallas"),
    ("cuda", {"algorithm": "xla_collective"}, "pallas"),
]


def _one_device_mesh():
    return jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
@pytest.mark.parametrize("ours,options,theirs", PAIRS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_member_matches_jax_at_world_one(ours, options, theirs, family, dtype):
    impl = load_port(family, ours)(M, N, K, dtype=dtype, device="cpu", **options)
    ref = load_jax(family, theirs)(M, N, K, dtype=dtype, mesh=_one_device_mesh(),
                                   **options)
    got, want = impl.run(), ref.run()
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got, want)
    assert impl.validate(got)


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
@pytest.mark.parametrize("options", OVERLAP_OPTIONS[:5])
def test_overlap_integer_operands_exact(family, options):
    impl = load_port(family, "overlap")(M, N, K, dtype="int32", device="cpu", **options)
    got = impl.run()
    a, b = impl._host_operands()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)


def _bare(family, name, m, d, **options):
    """A member with its options parsed and ``d`` partitions, for the shape
    checks alone (the port's world here is 1)."""
    cls = load_port(family, name)
    impl = object.__new__(cls)
    impl.m, impl.n, impl.k, impl.num_partitions, impl.dtype = m, N, K * d, d, "float32"
    from ddlb_tpu_torch.options import OptionsManager

    impl._options_manager = OptionsManager(*cls.option_schema())
    impl.options = impl._options_manager.parse(options)
    return impl


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
@pytest.mark.parametrize(
    "m,options,match",
    [
        (96, {"algorithm": "coll_pipeline", "s": 8},
         "m=96 must be divisible by partitions\\*s=64 for coll_pipeline"),
        (96, {"algorithm": "chunked", "chunk_count": 8},
         "m=96 must be divisible by partitions\\*chunk_count=64 for the chunked engine"),
        (72, {"algorithm": "p2p_pipeline", "direction": "bidirectional"},
         "m=72 must be divisible by 2\\*partitions=16 for bidirectional p2p_pipeline"),
    ],
)
def test_overlap_shape_pins_match_jax(family, m, options, match):
    """At d = 8 (the JAX world here) both packages refuse the same shapes
    with the same message."""
    with pytest.raises(ValueError, match=match):
        load_jax(family, "overlap")(m, N, K * 8, **options)
    with pytest.raises(ValueError, match=match):
        _bare(family, "overlap", m, 8, **options)._check_shapes()


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
@pytest.mark.parametrize(
    "options,match",
    [
        ({"algorithm": "bogus"}, "not in allowed values"),
        ({"s": 0}, "outside allowed range"),
        ({"direction": "sideways"}, "not in allowed values"),
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
        ("tp_columnwise", {"algorithm": "ring_rdma", "order": "AG_after"},
         "\\['order'\\] have no effect with algorithm='ring_rdma'"),
        ("tp_columnwise", {"detect_races": False},
         "\\['detect_races'\\] have no effect with algorithm='xla_collective'"),
        ("tp_rowwise", {"algorithm": "xla_collective", "detect_races": True},
         "\\['detect_races'\\] have no effect with algorithm='xla_collective'"),
    ],
)
def test_cuda_member_dead_options_match_jax(family, options, match):
    with pytest.raises(ValueError, match=match):
        load_jax(family, "pallas")(M, N, K, **options)
    with pytest.raises(ValueError, match=match):
        load_port(family, "cuda")(M, N, K, device="cpu", **options)


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
def test_cuda_member_rejects_the_race_detector(family):
    with pytest.raises(ValueError, match="race detector and has no CUDA counterpart"):
        load_port(family, "cuda")(M, N, K, device="cpu", algorithm="ring_rdma",
                                  detect_races=True)
    impl = load_port(family, "cuda")(M, N, K, device="cpu", algorithm="ring_rdma",
                                     detect_races=False)
    assert impl.validate(impl.run())


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
@pytest.mark.parametrize("option", ["block_m", "block_n", "block_k", "tune"])
def test_cuda_member_rejects_tpu_tiles(family, option):
    value = True if option == "tune" else 128
    with pytest.raises(ValueError, match="TPU tiles and are not ported"):
        load_port(family, "cuda")(M, N, K, device="cpu", **{option: value})


@pytest.mark.parametrize("family", ["tp_columnwise", "tp_rowwise"])
def test_cuda_member_rejects_dtypes_k2_k3_lack(family):
    with pytest.raises(ValueError, match="K1 matmul takes"):
        load_port(family, "cuda")(M, N, K, dtype="int32", device="cpu",
                                  algorithm="ring_rdma")


@pytest.mark.parametrize("family", ["dp_allreduce", "ep_alltoall"])
def test_overlap_of_dp_and_ep_not_yet_ported(family):
    """The dp and ep ``overlap`` members are ported now (their tests are in
    ``test_torch_dp_ep_members.py``); those families' GSPMD member is too,
    as ``compiled`` (``test_torch_compiled.py``)."""
    assert load_port(family, "overlap").primitive_name == family
    with pytest.raises(ValueError, match="counterpart is 'compiled'"):
        load_port(family, "xla_gspmd")
    assert load_port(family, "compiled").primitive_name == family


#: the JAX package's member names in the sweep configs -> the port's
_PORT_NAMES = {"jax_spmd": "pytorch", "pallas": "cuda", "xla_gspmd": "compiled"}


@pytest.mark.parametrize("config", ["config.json", "config_tp_rowwise.json"])
def test_sweep_config_members_run_on_the_cpu(config, tmp_path):
    """The config's member lists (with the port's names, plus
    ``cuda;algorithm=ring_rdma``) expand and run through the port's CLI at
    a small shape: every row valid, ``xla_gspmd``'s as ``compiled``."""
    cfg = json.loads((REPO / "scripts" / config).read_text())["benchmark"]
    impls = {_PORT_NAMES.get(name, name): blocks
             for name, blocks in cfg["implementations"].items()}
    impls["cuda"] = [{"algorithm": ["ring_rdma", "xla_collective"]}]
    cfg.update(m=[64], n=[32], k=[48], num_iterations=2, num_warmups=1,
               device="cpu", implementations=impls,
               output_csv=str(tmp_path / "rows.csv"))
    path = tmp_path / config
    path.write_text(json.dumps({"benchmark": cfg}))
    rows = port_cli.run_benchmark(port_cli.load_config(str(path)))
    expected = sum(
        len(port_cli.generate_config_combinations({name: blocks})[name])
        for name, blocks in impls.items()
    )
    assert len(rows) == expected
    for row in rows:
        assert row["valid"] and not row["error"], row
    assert sum(r["base_implementation"] == "compiled" for r in rows) == 1
    overlap = [r["option"] for r in rows if r["base_implementation"] == "overlap"]
    assert len(overlap) == {"config.json": 8, "config_tp_rowwise.json": 6}[config]
