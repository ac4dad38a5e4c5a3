"""Training-schedule chain: GPipe, 1F1B and interleaved 1F1B.

The counterpart of the JAX package's ``pp_pipeline/schedules.py``: each
microbatch goes forward through the chain and then back (the cotangent of
``L = sum(y)``), so a backward tick does the two products of a real one,
``dW_c += x^T g`` (float32) and ``g_out = g W_c^T``, about twice a forward
tick. The schedule is the host tables of ``utils/pipeline_schedule.py``:
at tick ``t`` rank ``p`` reads its row ``tables[t, p]`` and runs one of
idle, forward or backward on the microbatch, chunk and slots it names.

With ``virtual`` chunks a rank (Megatron's interleaved placement) rank
``p``'s chunk ``c`` is global stage ``c*d + p``: stage ``s -> s+1`` is
still rank ``p -> p+1``, and the weights are laid out device-major,
``[p*v + c]``. Activations hop to the next rank, cotangents to the
previous one, both in one ``batch_isend_irecv`` a tick
(``Runtime.ring_exchange``). A ring hops on a tick only when something
lands somewhere on the next one, which the tables alone decide, so every
rank posts the same hops. At the end the last stage's collected output (on rank
``d - 1``) is broadcast to every rank.

``run()`` returns ``(y, dW)``: the chain's ``[m, n]`` output and this
rank's float32 stage gradients ``[v, k, n]``. Validation holds ``y`` to
the chain oracle and each stage's gradient to ``_expected_grads`` at
``validation_atol(dtype, m) * S``. ``tables.bubble_fraction`` and
``tables.peak_stash`` are the schedule's idle share and its stash
(O(microbatches) for GPipe, O(depth) for 1F1B), the stash allocated at
that size.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ddlb_tpu_torch.ops.accum import accum_matmul
from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import matmul_precision_scope, torch_matmul, validation_atol
from ddlb_tpu_torch.primitives.pp_pipeline.base import PPPipeline
from ddlb_tpu_torch.utils.pipeline_schedule import (
    KIND_BWD,
    KIND_FWD,
    SCHEDULES,
    TABLES,
    build_schedule,
    hops_due,
)

log = logging.getLogger(__name__)

#: the one set of stage gradients kept per process, by (seed, m, k, n,
#: stages, microbatches, dtype)
_GRADS_MEMO: Dict[tuple, np.ndarray] = {}


class SchedulePPPipeline(PPPipeline):
    #: comm and compute pipelined: the cost model takes max(compute, comm)
    COST_SCHEDULE = "overlap"

    DEFAULT_OPTIONS = {"schedule": "1f1b", "microbatches": 4, "virtual": 1}
    ALLOWED_VALUES = {
        "schedule": list(SCHEDULES),
        "microbatches": (1, None),
        "virtual": (1, 8),
    }

    def wire_bytes(self) -> float:
        """The training schedule's wire (the JAX member's census, :69):
        both rings (forward ``[rows, k]``, backward ``[rows, n]``) on every
        tick of the tables, idle arms included, and the final all-reduce
        of the collected ``[mb, rows, n]`` output."""
        d = self.num_partitions
        if d <= 1:
            return 0.0
        mb = self.options["microbatches"]
        rows = self.m // mb
        isz = wire_itemsize(self.dtype)
        tables = build_schedule(self.options["schedule"], d, mb, self.num_stages // d)
        hops = tables.ticks * rows * (self.k + self.n) * isz
        collect = 2.0 * (mb * rows * self.n * isz) * (d - 1) / d
        return float(hops + collect)

    def _check_shapes(self) -> None:
        super()._check_shapes()
        mb = self.options["microbatches"]
        if self.m % mb != 0:
            raise ValueError(f"m={self.m} must be divisible by microbatches={mb}")

    @property
    def num_stages(self) -> int:
        # the chain is virtual times deeper than the ring
        return self.num_partitions * self.options["virtual"]

    def _input_setup(self) -> None:
        d, p, runtime = self.num_partitions, self.rank, self.runtime
        v, mb = self.options["virtual"], self.options["microbatches"]
        self.tables = tables = build_schedule(self.options["schedule"], d, mb, v)
        rows, k, n, S = self.m // mb, self.k, self.n, self.num_stages
        a_host, w_host = self._host_chain_operands()
        self.a = self._place(a_host)
        # this rank's chunks, device-major: chunk c is global stage c*d + p
        self.w = self._place(w_host[[c * d + p for c in range(v)]])
        mine = {name: getattr(tables, name)[:, p].tolist() for name in TABLES}
        fwd_due, bwd_due = hops_due(tables.fwd_land), hops_due(tables.bwd_land)

        def step(a: torch.Tensor, w: torch.Tensor):
            dt, dev = a.dtype, a.device
            act = torch.empty((tables.act_slots, rows, k), dtype=dt, device=dev)
            fland = torch.empty((tables.land_slots, rows, k), dtype=dt, device=dev)
            bland = torch.empty((tables.land_slots, rows, n), dtype=dt, device=dev)
            dw = torch.zeros((v, k, n), dtype=torch.float32, device=dev)
            coll = torch.zeros((mb, rows, n), dtype=dt, device=dev)
            zeros = torch.zeros((rows, n), dtype=dt, device=dev)  # k == n
            ones = torch.ones((rows, n), dtype=dt, device=dev)
            fwd_arr = bwd_arr = zeros
            for t in range(tables.ticks):
                # 1) land last tick's arrivals
                if mine["fwd_land"][t] >= 0:
                    fland[mine["fwd_land"][t]] = fwd_arr
                if mine["bwd_land"][t] >= 0:
                    bland[mine["bwd_land"][t]] = bwd_arr
                kind, i, c = mine["kind"][t], mine["mb"][t], mine["chunk"][t]
                aslot, islot = mine["act_slot"][t], mine["in_slot"][t]
                s = c * d + p
                send_f = send_b = zeros
                if kind == KIND_FWD:
                    x_in = a[i * rows:(i + 1) * rows] if s == 0 else fland[islot]
                    act[aslot] = x_in
                    y = torch_matmul(x_in, w[c])
                    if s == S - 1:
                        coll[i] = y  # the last stage collects and sends nothing
                    else:
                        send_f = y
                elif kind == KIND_BWD:
                    g = ones if s == S - 1 else bland[islot]
                    dw[c] += accum_matmul(act[aslot].t(), g)
                    if s > 0:
                        send_b = torch_matmul(g, w[c].t())
                # 2) the hops, both rings at once, where something lands
                # next tick
                got_f, got_b = runtime.ring_exchange(send_f if fwd_due[t] else None,
                                                     send_b if bwd_due[t] else None)
                fwd_arr = fwd_arr if got_f is None else got_f
                bwd_arr = bwd_arr if got_b is None else got_b
            # the output where the last stage lives, then on every rank
            return runtime.broadcast(coll, d - 1).reshape(self.m, n), dw

        self._fn = step

    def _expected_grads(self) -> np.ndarray:
        """The stage gradients of ``L = sum(y)``, microbatch by microbatch,
        in stage order ``[S, k, n]`` float32 (JAX :249-268), from the
        float32 draws as the JAX oracle takes them (not rounded to the row's
        dtype), on this device (TF32 off); memoised."""
        mb = self.options["microbatches"]
        key = (self.seed, self.m, self.k, self.n, self.num_stages, mb, self.dtype)
        if key not in _GRADS_MEMO:
            _GRADS_MEMO.clear()
            a, w = (torch.from_numpy(x).to(self.device, torch.float32)
                    for x in self._host_chain_operands())
            rows, S = self.m // mb, self.num_stages
            dw = torch.zeros((S, self.k, self.n), dtype=torch.float32, device=a.device)
            with torch.no_grad(), matmul_precision_scope("float32"):
                for i in range(mb):
                    x = a[i * rows:(i + 1) * rows]
                    xs = []
                    for s in range(S):
                        xs.append(x)
                        x = x @ w[s]
                    g = torch.ones((rows, self.n), dtype=torch.float32, device=a.device)
                    for s in range(S - 1, -1, -1):
                        dw[s] += xs[s].t() @ g
                        g = g @ w[s].t()
            _GRADS_MEMO[key] = dw.cpu().numpy()
            del a, w, dw, xs
        return _GRADS_MEMO[key]

    def validate(self, result) -> bool:
        if result is None:
            return False
        y, dw = result
        ok = super().validate(y)
        d, v = self.num_partitions, self.options["virtual"]
        got = dw.cpu().numpy()
        want = self._expected_grads()
        atol = validation_atol(self.dtype, self.m) * self.num_stages
        for c in range(v):
            s = c * d + self.rank
            err = float(np.max(np.abs(got[c] - want[s])))
            if not err <= atol:
                log.warning("schedule grad validation FAILED rank %d stage %d: "
                            "max|err|=%.3e > atol=%.3e", self.rank, s, err, atol)
                ok = False
        return ok
