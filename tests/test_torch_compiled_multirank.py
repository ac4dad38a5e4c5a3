"""The ``compiled`` members on a 2-rank gloo world (spawned, never forked:
the parent has JAX and torch threads; with a deadline), against the JAX
package's ``xla_gspmd`` members on two devices of the CPU simulation
(``test_torch_compiled``'s twins), under the tolerances of
``test_torch_compiled.py``: the GEMM families in float32 and bfloat16
within ``validation_atol``, the collectives bit for bit,
``transformer_step`` at (dp 1, tp 2, pp 1) and (dp 2, tp 1, pp 1) (the
loss, and each rank's shard of the parameters after one AdamW step) and
``transformer_decode`` at (dp 1, tp 2) and (dp 2, tp 1) (decode and
prefill logits); the collectives DTensor issues for each GEMM and wire
program, counted with ``CommDebugMode`` on the eager program; and what
Inductor's async-TP pass fuses in the tp programs under the card's
settings (``ASYNC_TP``).
"""

import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import pytest

from test_torch_compiled import (
    DECODE, DECODE_SHAPE, GEMM_FAMILIES, K, M, N, OPS, STEP, STEP_SHAPE, adam_atol,
    decode_twin, gemm_twin, rows_of, step_twin,
)
from ddlb_tpu_torch.primitives.base import validation_atol

WORLD = 2
DEADLINE_S = 400

#: the collective DTensor issues for each program on gloo at d = 2
#: (``CommDebugMode``'s op names); gloo has no DTensor all-to-all, so a
#: ``Shard(1) -> Shard(0)`` is an all-gather and a chunk, and the roll is an
#: all-gather on every backend
COMMS = {
    "tp_columnwise": {"all_gather_into_tensor": 1},
    "tp_rowwise": {"reduce_scatter_tensor": 1},
    "dp_allreduce": {"all_reduce": 1},
    "ep_alltoall": {"all_gather_into_tensor": 2},
    "all_gather": {"all_gather_into_tensor": 1},
    "all_reduce": {"all_reduce": 1},
    "reduce_scatter": {"reduce_scatter_tensor": 1},
    "all_to_all": {"all_gather_into_tensor": 1},
    "ppermute": {"all_gather_into_tensor": 1},
}

#: the model members' (dp, tp) layouts over the world (pp 1): the
#: head-sharded one, and the data-parallel one the four-card (2, 2) rows
#: also shard over
LAYOUTS = ((1, WORLD), (WORLD, 1))

#: (family, ``collective_matmul``) -> the fused operators Inductor's async-TP
#: pass puts in the graph under the card's settings: the rowwise GEMM feeds
#: its reduce-scatter (one ``fused_matmul_reduce_scatter``); the columnwise
#: program gathers after its GEMM, which no pattern covers; None with the
#: pass off
ASYNC_TP = {
    ("tp_rowwise", "force"): 1,
    ("tp_columnwise", "force"): 0,
    ("tp_rowwise", "auto"): None,
    ("tp_rowwise", "off"): None,
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, results):
    """One rank: the GEMM families and the collectives in float32 and
    bfloat16 with the collectives their eager programs issue, the training
    step at (1, 2, 1) and the serving step at (1, 2)."""
    os.environ.update(
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
        MASTER_ADDR="localhost", MASTER_PORT=str(port),
    )
    from torch.distributed.tensor.debug import CommDebugMode

    from ddlb_tpu_torch.primitives.registry import load_impl_class
    from ddlb_tpu_torch.runtime import shutdown

    def counted(impl):
        with CommDebugMode() as comm:
            impl.programs[0](*impl._call_args)
        return {str(op).split(".")[-1]: n for op, n in comm.get_comm_counts().items()}

    try:
        out = {}
        cases = [(f, None) for f in GEMM_FAMILIES] + [("collectives", op) for op in OPS]
        for family, op in cases:
            for dtype in ("float32", "bfloat16"):
                opts = {"op": op} if op else {}
                impl = load_impl_class(family, "compiled")(
                    M, 8 if op else N, K, dtype=dtype, device="cpu", **opts)
                result = impl.run()
                out[(family, op, dtype)] = (result.float().numpy(), impl.validate(result),
                                            counted(impl) if dtype == "float32" else None)
        for dp, tp in LAYOUTS:
            impl = load_impl_class("transformer_step", "compiled")(
                *STEP_SHAPE, dtype="float32", device="cpu", mode="train", dp=dp, tp=tp, pp=1,
                **STEP)
            params, _, loss = impl.run()
            out[("step", dp)] = ({n: p.numpy() for n, p in params.items()}, float(loss),
                                 impl.validate((params, None, loss)))
            for phase in ("decode", "prefill"):
                impl = load_impl_class("transformer_decode", "compiled")(
                    *DECODE_SHAPE, dtype="float32", device="cpu", phase=phase, dp=dp, tp=tp,
                    **DECODE)
                result = impl.run()
                out[(phase, dp)] = (result.numpy(), impl.validate(result))

        # the tp programs under the card's Inductor settings, async TP
        # included: the pass is gated on NCCL being present, and symmetric
        # memory's fused operators have no CPU kernel, so they run their
        # reference (the plain product and collective) here
        import torch
        from torch.distributed import _symmetric_memory as symm
        from ddlb_tpu_torch.primitives import compile_options

        for op in ("fused_matmul_reduce_scatter", "fused_all_gather_matmul"):
            torch.library.impl(f"symm_mem::{op}", "CPU")(getattr(symm, f"_{op}_fallback"))
        card = compile_options.build_compile_options
        compile_options.build_compile_options = lambda options, platform: card(options, "cuda")
        torch.distributed.is_nccl_available = lambda: True
        for family, cm in ASYNC_TP:
            impl = load_impl_class(family, "compiled")(
                M, N, K, dtype="float32", device="cpu", collective_matmul=cm)
            result = impl.run()
            out[(family, cm)] = (result.numpy(), impl.validate(result), impl.async_tp_fused)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shutdown()


def test_two_rank_gloo_world():
    from ddlb_tpu_torch.models.transformer import TransformerConfig, param_axes

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        # drain before joining: a child blocks on exit until its queue
        # items are consumed
        for _ in range(WORLD):
            rank, status, payload = results.get(timeout=DEADLINE_S)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {WORLD}-rank world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * WORLD

    cases = [(f, None) for f in GEMM_FAMILIES] + [("collectives", op) for op in OPS]
    for family, op in cases:
        for dtype in ("float32", "bfloat16"):
            full = gemm_twin(family, dtype, WORLD, op)
            for rank in range(WORLD):
                output, valid, comms = got[rank][(family, op, dtype)]
                want = rows_of(family, op, rank, WORLD, full)
                assert valid, (rank, family, op, dtype)
                if op:
                    np.testing.assert_array_equal(output, want, err_msg=f"{op} {dtype}")
                else:
                    np.testing.assert_allclose(output, want, rtol=0,
                                               atol=validation_atol(dtype, K),
                                               err_msg=f"rank {rank} {family} {dtype}")
                if comms is not None:
                    assert comms == COMMS[op or family], (family, op, comms)

    for (family, cm), fused in ASYNC_TP.items():
        full = gemm_twin(family, "float32", WORLD, None)
        for rank in range(WORLD):
            output, valid, got_fused = got[rank][(family, cm)]
            assert valid and got_fused == fused, (rank, family, cm, got_fused)
            np.testing.assert_allclose(output, rows_of(family, None, rank, WORLD, full),
                                       rtol=0, atol=validation_atol("float32", K),
                                       err_msg=f"rank {rank} {family} {cm}")

    for dp, tp in LAYOUTS:
        want_loss, init, want = step_twin("train", "float32", dp, tp, 1)
        axes = param_axes(TransformerConfig(), want)
        for rank in range(WORLD):
            params, loss, valid = got[rank][("step", dp)]
            assert valid and loss == pytest.approx(want_loss, abs=1e-4), (dp, tp, rank)
            for name, full in want.items():
                part, tol = full, adam_atol(init[name], full)
                if tp > 1 and "tp" in axes[name]:
                    dim = axes[name]["tp"]
                    cut = range(rank * full.shape[dim] // tp, (rank + 1) * full.shape[dim] // tp)
                    part, tol = np.take(part, cut, axis=dim), np.take(tol, cut, axis=dim)
                err = np.abs(params[name] - part)
                assert np.all(err <= tol), (dp, tp, rank, name, float(err.max()))

        for phase in ("decode", "prefill"):
            want = decode_twin(phase, dp, tp)
            rows = want.shape[0] // dp
            for rank in range(WORLD):
                logits, valid = got[rank][(phase, dp)]
                assert valid, (dp, tp, rank, phase)
                mine = want[rank * rows:(rank + 1) * rows] if dp > 1 else want
                np.testing.assert_allclose(logits, mine, rtol=0, atol=1e-4,
                                           err_msg=f"{phase} at dp {dp}, tp {tp}")
