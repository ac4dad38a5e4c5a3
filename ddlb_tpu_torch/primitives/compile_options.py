"""Sweepable compiler options of the ``compiled`` members, and the compile.

The port of the JAX package's ``primitives/xla_options.py``. There the
compiler slot (``xla_gspmd``) is a global program under ``jax.jit`` with
in/out shardings: GSPMD picks the collectives and XLA's scheduler
overlaps them. Here the same global program is written on ``DTensor``s
(``torch.distributed.tensor``): inputs come in the placements of the JAX
member's ``in_shardings``, the result is redistributed to its
``out_shardings``, DTensor's sharding propagation picks the collectives,
and ``torch.compile(..., fullgraph=True)`` hands the program to
Inductor, which schedules them.

The option names and values are the JAX package's, so a config's
``option`` column and sweeps read the same. Their Inductor counterparts
(``build_compile_options``):

- ``latency_hiding_scheduler`` -> ``reorder_for_compute_comm_overlap``,
  Inductor's pass that moves collectives to overlap compute;
- ``collective_matmul``: ``force`` -> ``_micro_pipeline_tp=True`` (async
  tensor parallelism: an all-gather feeding a matmul, or a matmul feeding
  a reduce-scatter, replaced by symmetric memory's fused operator, which
  decomposes it into per-rank steps), with symmetric memory enabled for
  the mesh's groups (``enable_symmetric_memory``: the pass skips every
  other group); ``off`` -> False; ``auto`` leaves Inductor's default,
  which is off in the torch releases this package runs on. Under
  ``force`` the row's ``async_tp_fused`` column counts the fused
  operators the pass put in the member's graphs: ``tp_rowwise``'s
  GEMM -> reduce-scatter matches; ``tp_columnwise``'s program gathers
  the product after the GEMM, which no pattern of the pass covers, so
  ``force`` changes nothing there;
- ``async_collective_fusion=True`` is what Inductor always does: the
  functional collectives are issued asynchronously and waited for at
  their first use. ``False`` has no counterpart and raises.

On the CPU (the gloo test worlds) no option is passed, as the JAX package
passes none off the TPU.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch._inductor.custom_graph_pass import CustomGraphPass
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_map

from ddlb_tpu_torch.ops.accum import torch_matmul
from ddlb_tpu_torch.runtime import placements

GSPMD_DEFAULT_OPTIONS: Dict[str, Any] = {
    "latency_hiding_scheduler": True,
    "async_collective_fusion": True,
    "collective_matmul": "auto",
}

GSPMD_ALLOWED_VALUES: Dict[str, Any] = {
    "latency_hiding_scheduler": [True, False],
    "async_collective_fusion": [True, False],
    "collective_matmul": ["auto", "force", "off"],
}


def build_compile_options(
    options: Dict[str, Any], platform: str
) -> Optional[Dict[str, Any]]:
    """The option dict as Inductor settings (``torch.compile(options=...)``
    keys), with ``emulate_precision_casts`` on; None off the card.
    ``async_collective_fusion=False`` raises on every platform: Inductor
    always issues its collectives asynchronously."""
    if not options["async_collective_fusion"]:
        raise ValueError(
            "async_collective_fusion=False has no counterpart in "
            "ddlb_tpu_torch: Inductor always issues collectives "
            "asynchronously and waits for them at their first use"
        )
    if platform != "cuda":
        return None
    out: Dict[str, Any] = {
        "reorder_for_compute_comm_overlap": bool(options["latency_hiding_scheduler"]),
        # round where the program casts, as eager PyTorch and XLA do:
        # without it Inductor keeps a fused bf16 intermediate in float32
        "emulate_precision_casts": True,
    }
    cm = options["collective_matmul"]
    if cm == "force":
        out["_micro_pipeline_tp"] = True
    elif cm == "off":
        out["_micro_pipeline_tp"] = False
    return out


def enable_symmetric_memory(mesh) -> None:
    """Symmetric memory enabled for every group of ``mesh``. Inductor's
    async-TP pass leaves a collective alone unless
    ``is_symm_mem_enabled_for_group`` holds for its group, and only
    ``enable_symm_mem_for_group`` makes it hold (``rendezvous``, which
    ``Runtime.peer_buffer`` calls, does not); that function is deprecated
    with a FutureWarning, which is silenced here."""
    import warnings

    from torch.distributed import _symmetric_memory as symm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for dim in range(mesh.ndim):
            symm.enable_symm_mem_for_group(mesh.get_group(dim).group_name)


class FusedOpCount(CustomGraphPass):
    """A post-grad pass (Inductor runs it after the async-TP pass) that
    adds to ``count`` the symmetric-memory fused operators
    (``symm_mem.fused_*``) in each graph. Its ``uuid`` is None, so
    Inductor bypasses its graph cache and the pass sees every compile."""

    def __init__(self) -> None:
        self.count = 0

    def __call__(self, graph) -> None:
        self.count += sum(str(n.target).startswith("symm_mem.fused_") for n in graph.nodes)

    def uuid(self):
        return None


def local(x):
    """``x`` with every DTensor in it (a tensor, tuple or dict) replaced by
    this rank's shard."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, x)


def mm_dtype_rule(a, b, out_dtype):
    """``aten.mm.dtype`` (``torch.mm(a, b, out_dtype=...)``, the float32
    product of ``ops.accum.float32_product`` on the card) sharded as
    ``aten.mm`` is, per mesh dimension: both replicated; rows of ``a``
    sharded; columns of ``b`` sharded; or the contraction sharded, giving
    a partial sum."""
    return [
        ([Replicate()], [Replicate(), Replicate(), None]),
        ([Shard(0)], [Shard(0), Replicate(), None]),
        ([Shard(1)], [Replicate(), Shard(1), None]),
        ([Partial()], [Shard(1), Shard(0), None]),
    ]


def roll_rule(x, shifts, dims=()):
    """``aten.roll`` sharded per mesh dimension: replicated, or sharded
    along a dimension it does not roll (rolling along a sharded one
    gathers it first, as newer DTensor releases do)."""
    rolled = {d % x.ndim for d in dims} if dims else set(range(x.ndim))
    return [([Replicate()], [Replicate(), None, None])] + [
        ([Shard(i)], [Shard(i), None, None]) for i in range(x.ndim) if i not in rolled
    ]


#: ops the members run that some torch releases give no DTensor rule
_RULES = ((torch.ops.aten.mm.dtype, mm_dtype_rule), (torch.ops.aten.roll.default, roll_rule))


def _has_rule(op) -> bool:
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, name, {}) for name in (
        "op_strategy_funcs", "op_single_dim_strategy_funcs", "op_to_rules"))


def register_missing_rules() -> None:
    """Register ``_RULES``' sharding rules for the ops this torch's DTensor
    has none for (``aten.mm.dtype`` everywhere so far, ``aten.roll``
    before torch 2.13), with DTensor's public ``register_sharding``; a
    registered rule counts as one, so a second call registers nothing."""
    from torch.distributed.tensor.experimental import register_sharding

    for op, rule in _RULES:
        if not _has_rule(op):
            register_sharding(op)(rule)


class CompiledOptionsMixin:
    """The compiler-knob surface of a ``compiled`` member (the JAX
    package's ``GSPMDOptionsMixin``).

    ``_compile(fn, mesh)`` replaces ``jax.jit``: it compiles the global program
    ``fn`` with ``fullgraph=True`` (a graph break raises, and the row
    becomes an error row; nothing falls back to eager), with the Inductor
    settings kept on ``self.inductor_options``. The program is traced on
    its first call, which the runner makes in a warm-up
    (``compiles_on_first_call``). Each call runs under DTensor's implicit
    replication, so a plain tensor made inside the program (a mask, a
    position range; the same on every rank) counts as replicated.
    """

    DEFAULT_OPTIONS = dict(GSPMD_DEFAULT_OPTIONS)
    ALLOWED_VALUES = dict(GSPMD_ALLOWED_VALUES)

    #: the first call traces and compiles: the runner needs a warm-up
    compiles_on_first_call = True
    #: seconds of the first ``run()`` (tracing, compiling and one run) and
    #: the graphs Dynamo captured in it; None before it
    compile_s = None
    dynamo_graphs = None
    #: under ``collective_matmul=force``, the fused operators Inductor's
    #: async-TP pass put in the member's graphs; None when the pass is off
    async_tp_fused = None

    def run(self):
        if self.compile_s is not None:
            return super().run()
        stats = torch._dynamo.utils.counters["stats"]
        graphs, t0 = stats["unique_graphs"], time.perf_counter()
        out = super().run()
        self.runtime.synchronize()
        self.compile_s = time.perf_counter() - t0
        self.dynamo_graphs = stats["unique_graphs"] - graphs
        return out

    def extra_row_fields(self) -> Dict[str, Any]:
        """The family's columns, the first call's seconds and graph
        count (``compile_s``, ``dynamo_graphs``) and ``async_tp_fused``."""
        return {**super().extra_row_fields(), "compile_s": self.compile_s,
                "dynamo_graphs": self.dynamo_graphs,
                "async_tp_fused": self.async_tp_fused}

    def _compile(self, fn: Callable, mesh) -> Callable:
        """``fn``, a program over ``mesh``, compiled, returning what it
        returns (DTensors included); ``fn`` itself is kept in
        ``self.programs``, so that the collectives DTensor picks can be
        counted on the eager program (``CommDebugMode`` cannot wrap a
        compiled call). Dynamo's caches are cleared first: every member's
        program is traced anew, and no member's shapes count towards
        another's recompile limit. With async TP on, symmetric memory is
        enabled for ``mesh``'s groups and a ``FusedOpCount`` pass counts
        what the pass fused into ``async_tp_fused``."""
        self.programs = getattr(self, "programs", []) + [fn]
        self.inductor_options = build_compile_options(
            self.options, self.runtime.platform
        )
        settings = self.inductor_options
        if settings and settings.get("_micro_pipeline_tp"):
            if mesh.size() > 1:
                enable_symmetric_memory(mesh)
            if self.async_tp_fused is None:
                self._fused = FusedOpCount()
                self.async_tp_fused = 0
            settings = {**settings, "post_grad_custom_post_pass": self._fused}
        torch._dynamo.reset()
        register_missing_rules()
        compiled = torch.compile(fn, fullgraph=True, options=settings)

        def call(*args):
            with implicit_replication():
                out = compiled(*args)
            if self.async_tp_fused is not None:
                self.async_tp_fused = self._fused.count
            return out

        return call

    def _compile_gemm(self, a_axes: dict, b_axes: dict, out) -> None:
        """The GEMM families' step: ``self.a``/``self.b`` (this rank's
        shards) become DTensors over a 'tp' mesh of the world, sharded as
        ``a_axes``/``b_axes`` (``{'tp': dim}``, or ``{}`` for replicated),
        and ``self._fn`` is the compiled global product redistributed to
        the placement ``out``, returning this rank's shard of it.

        The mesh is in rank order (a ``DeviceMesh`` over a permuted ring
        still gathers in rank order), so under a reordered ring
        (``Runtime.order_ring``) the blocks are permuted around the
        program as around an NCCL call: a row-sharded result is asked of
        ``A``'s rows taken in rank order (at set-up), and a product of
        row-sharded ``A`` comes back with its row blocks in rank order,
        permuted into position order."""
        rt = self.runtime
        if out == Shard(0):
            self.a = rt.blocks_by_rank(self.a)
        gathered = a_axes.get("tp") == 0
        mesh = rt.device_mesh(("tp",), (self.num_partitions,))
        self.a = DTensor.from_local(self.a, mesh, placements(mesh, a_axes),
                                    run_check=False)
        self.b = DTensor.from_local(self.b, mesh, placements(mesh, b_axes),
                                    run_check=False)

        def step(a, b):
            return torch_matmul(a, b).redistribute(mesh, [out])

        compiled = self._compile(step, mesh)
        if gathered:
            self._fn = lambda a, b: rt.blocks_by_position(local(compiled(a, b)))
        else:
            self._fn = lambda a, b: local(compiled(a, b))
