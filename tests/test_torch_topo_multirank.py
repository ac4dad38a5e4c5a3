"""The topology compositions and the transport axis on 4-rank gloo worlds.

Two worlds of four ranks run at once, each started with ``spawn`` and held
to a deadline:

- ``DDLB_TPU_SIM_SLICES=2``: two nodes of two ranks, so the between-node
  phases carry real traffic and ``transport=dcn`` lays the ring out as
  ``[0, 2, 1, 3]``. Every op x composition of the three composed families
  runs there, and under ``transport=ici`` and ``dcn``: the four GEMM
  families' ``pytorch``, ``overlap`` (``p2p_pipeline``, ``chunked``) and
  ``compiled`` members, the ``collectives`` family's ``pytorch`` and
  ``compiled`` members for every op, ``cp_ring_attention``'s ``ulysses``
  and ``ring``, and ``pp_pipeline``'s ``pytorch``, ``schedules`` and
  ``compiled``.
- no knob: one node whose torus is (2, 2), so ``striped`` runs two true
  stripes over different 2-rank groups.

Each rank returns its float32 output, its validation, its wire bytes and
its ``composition``; the parent holds the output to the JAX twin's global
array on a 4-device mesh of the CPU simulation with the same node layout
(the runtime narrowed to four devices, its slice ids set): exact for the
gathers, all-to-alls and ring hops of the collectives family, within
``validation_atol`` where a sum or a GEMM is involved, and within 1e-5
for attention and the pipeline (the tolerance of their own parity tests).
A rank at ring position ``p`` holds row block ``p`` (a sequence block of
attention; the pipeline's stage ``p``, whose weight gradients are rows
``[p*v, (p+1)*v)`` of the JAX member's).
"""

import contextlib
import os
import traceback

import numpy as np

from ddlb_tpu_torch.primitives.base import validation_atol
from torch_parity import finish_world, join_world, start_world

WORLD = 4
DEADLINE_S = 240
#: the collectives payload [m, k] (m % (d^2) and the stripes' splits exact)
COLL_M, COLL_K = 64, 16
#: the GEMM families' shape (ep: 4 tokens a routing group, two stripes)
M, N, K = 64, 16, 32
OPS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
TRANSPORTS = ("ici", "dcn")
#: cp_ring_attention at seq 64, 4 heads of 16; pp_pipeline's stages compose (k = n)
ATTN_SHAPE, PP_SHAPE = (64, 64, 16), (32, 32, 32)

#: (family, port member, options, expected composition or None)
NODES_CASES = (
    [("collectives", "pytorch_hier", {"op": op, "composition": c}, c)
     for op in OPS for c in ("flat", "hierarchical")]
    + [("collectives", "pytorch_hier", {"op": "all_reduce", "composition": "auto"},
        "hierarchical"),
       ("collectives", "pytorch_striped", {}, "striped")]
    + [(fam, "pytorch_hier", {"composition": c}, {"auto": "hierarchical"}.get(c, c))
       for fam in ("dp_allreduce", "ep_alltoall") for c in ("flat", "hierarchical", "auto")]
    + [(fam, "pytorch_striped", {}, "striped") for fam in ("dp_allreduce", "ep_alltoall")]
    + [(fam, member, {**opts, "transport": t}, None)
       for fam in ("tp_columnwise", "tp_rowwise", "dp_allreduce", "ep_alltoall")
       for member, opts in (("pytorch", {}),
                            ("overlap", {"algorithm": "p2p_pipeline"}),
                            ("overlap", {"algorithm": "chunked", "chunk_count": 2}),
                            ("compiled", {}))
       if not (fam == "ep_alltoall" and opts.get("algorithm") == "p2p_pipeline")
       for t in TRANSPORTS]
    + [("collectives", member, {"op": op, "transport": t}, None)
       for member in ("pytorch", "compiled") for op in OPS + ("ppermute",)
       for t in TRANSPORTS]
    + [("cp_ring_attention", name, {**opts, "transport": t}, None)
       for name, opts in (("ulysses", {"compute": "einsum"}), ("ring", {}))
       for t in TRANSPORTS]
    + [("pp_pipeline", name, {**opts, "transport": t}, None)
       for name, opts in (("pytorch", {"microbatches": 2}),
                          ("schedules", {"schedule": "1f1b", "microbatches": 4}),
                          ("compiled", {}))
       for t in TRANSPORTS]
)
#: one node, torus (2, 2): two stripes; hierarchical degenerates to one ring
TORUS_CASES = (
    [("collectives", "pytorch_striped", {}, "striped"),
     ("collectives", "pytorch_hier", {"op": "all_to_all"}, "hierarchical"),
     ("collectives", "pytorch_hier", {"op": "all_reduce", "composition": "auto"}, "flat")]
    + [(fam, name, {}, comp) for fam in ("dp_allreduce", "ep_alltoall")
       for name, comp in (("pytorch_striped", "striped"), ("pytorch_hier", "hierarchical"))]
)
#: the port's member -> its JAX twin
JAX_NAMES = {"pytorch": "jax_spmd", "compiled": "xla_gspmd", "overlap": "overlap",
             "pytorch_hier": "jax_spmd_hier", "pytorch_striped": "jax_spmd_striped"}


def shape_of(family):
    return {"collectives": (COLL_M, 8, COLL_K), "cp_ring_attention": ATTN_SHAPE,
            "pp_pipeline": PP_SHAPE}.get(family, (M, N, K))


def parts_of(result):
    """A member's output as a list of float32 host arrays (``schedules``
    returns the chain's output and its stage gradients)."""
    parts = result if isinstance(result, tuple) else (result,)
    return [p.float().numpy() if hasattr(p, "float") else np.asarray(p, np.float32)
            for p in parts]


def _rank_main(rank, port, results, slices, cases):
    join_world(rank, WORLD, port)
    if slices:
        os.environ["DDLB_TPU_SIM_SLICES"] = str(slices)
    import torch.distributed as dist

    from ddlb_tpu_torch.primitives.registry import load_impl_class

    try:
        out = []
        for family, name, opts, _ in cases:
            impl = load_impl_class(family, name)(*shape_of(family), dtype="float32",
                                                 device="cpu", **opts)
            result = impl.run()
            wire = impl.wire_bytes() if hasattr(impl, "wire_bytes") else None
            out.append((parts_of(result), impl.validate(result), wire,
                        impl.extra_row_fields().get("composition"), impl.rank))
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def jax_world(slices):
    """The JAX runtime narrowed to four devices in ``slices`` nodes, so a
    member's transport, hybrid and torus meshes span the port's world."""
    from ddlb_tpu.runtime import Runtime as JaxRuntime

    rt = JaxRuntime()
    saved = rt.devices, rt.num_devices, rt.slice_ids, rt.num_slices
    rt.devices, rt.num_devices = saved[0][:WORLD], WORLD
    rt.slice_ids = tuple(i // (WORLD // slices) for i in range(WORLD))
    rt.num_slices = slices
    try:
        yield
    finally:
        rt.devices, rt.num_devices, rt.slice_ids, rt.num_slices = saved


def jax_twins(cases, slices):
    """Each case's JAX twin: (global float32 result, wire bytes)."""
    from ddlb_tpu.primitives.registry import load_impl_class as load_jax

    twins = []
    with jax_world(slices):
        for family, name, opts, _ in cases:
            impl = load_jax(family, JAX_NAMES.get(name, name))(
                *shape_of(family), dtype="float32", **opts)
            wire = impl.wire_bytes() if hasattr(impl, "wire_bytes") else None
            twins.append((parts_of(impl.run()), wire))
    return twins


def replicated(family, opts):
    return family in ("tp_columnwise", "dp_allreduce", "pp_pipeline") or opts.get(
        "op", "all_reduce" if family == "collectives" else None) in ("all_gather", "all_reduce")


def check_world(got, cases, twins, order):
    for i, ((family, name, opts, comp), (full, wire)) in enumerate(zip(cases, twins)):
        what = f"{family} {name} {opts}"
        exact = family == "collectives" and opts.get("op") in (
            "all_gather", "all_to_all", "ppermute")
        atol = 0.0 if exact else validation_atol("float32", shape_of(family)[2])
        if family in ("cp_ring_attention", "pp_pipeline"):
            atol = 1e-5
        for rank, rows in got.items():
            result, valid, ours_wire, ours_comp, position = rows[i]
            ring = order if opts.get("transport") == "dcn" else tuple(range(WORLD))
            assert position == ring.index(rank), (what, rank, position)
            assert valid, (what, rank)
            assert ours_comp == comp, (what, ours_comp)
            if ours_wire is not None:
                assert ours_wire == wire, (what, ours_wire, wire)
            assert len(result) == len(full), what
            for part, (ours, want) in enumerate(zip(result, full)):
                if part or not replicated(family, opts):  # a block a position
                    rows_a_rank = want.shape[0] // WORLD
                    want = want[position * rows_a_rank:(position + 1) * rows_a_rank]
                np.testing.assert_allclose(ours, want, rtol=0, atol=atol,
                                           err_msg=f"{what} rank {rank} part {part}")


def test_four_rank_worlds_match_jax():
    nodes = start_world(_rank_main, WORLD, 2, NODES_CASES)
    torus = start_world(_rank_main, WORLD, 0, TORUS_CASES)
    nodes_twins, torus_twins = jax_twins(NODES_CASES, 2), jax_twins(TORUS_CASES, 1)
    got_nodes = finish_world(nodes, DEADLINE_S)
    got_torus = finish_world(torus, DEADLINE_S)
    check_world(got_nodes, NODES_CASES, nodes_twins, (0, 2, 1, 3))
    check_world(got_torus, TORUS_CASES, torus_twins, (0, 1, 2, 3))
