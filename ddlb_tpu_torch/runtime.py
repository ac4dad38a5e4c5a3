"""Process runtime: rank, device binding, process group and barrier.

The PyTorch counterpart of the JAX package's ``Runtime``. One process
drives one device. Rank, local rank and world size come from the
``torchrun`` environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``; a plain
``python`` launch is rank 0 of a world of 1). ``device="cuda"`` binds
``cuda:{local_rank}``, ``device="cpu"`` the host. When the world has more
than one rank the default process group is opened once per process: NCCL
on the card, gloo on the CPU, rendezvous through ``MASTER_ADDR`` /
``MASTER_PORT`` (``env://``). At world 1 no group exists and every
collective below is the identity: the all-gather and reduce-scatter of
rows, the sum all-reduce, the ring hop (``batch_isend_irecv``), and the
row and head/sequence all-to-alls (``all_to_all_single``).
``Runtime.mesh(dp, tp)`` places the rank in a ``(dp, tp)`` mesh
(``Mesh``) whose tp sub-group carries the serving model's sum and
all-gather.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

DEVICES = ("cuda", "cpu")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value.strip() else default


def env_rank() -> int:
    """This process's rank as the launcher set it (0 without one)."""
    return _env_int("RANK", 0)


def _collective(new_name: str, old_name: str):
    """The collective under its current name where this torch has it
    (``all_gather_single``/``reduce_scatter_single``, torch >= 2.13),
    else the older spelling, which newer releases deprecate with a
    warning on every call."""
    return getattr(dist, new_name, None) or getattr(dist, old_name)


class Runtime:
    """One rank's view of the world: its device and its peers."""

    def __init__(self, device: str = "cuda") -> None:
        if device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
        self.rank = env_rank()
        self.local_rank = _env_int("LOCAL_RANK", 0)
        self.world_size = _env_int("WORLD_SIZE", 1)
        if not 0 <= self.rank < self.world_size:
            raise ValueError(
                f"RANK={self.rank} outside WORLD_SIZE={self.world_size}"
            )
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available; pass device='cpu' (CLI: "
                    "--device cpu) to run on the host"
                )
            self.device = torch.device("cuda", self.local_rank)
            torch.cuda.set_device(self.device)
            self.device_kind = torch.cuda.get_device_name(self.device)
        else:
            self.device = torch.device("cpu")
            self.device_kind = "cpu"
        self.platform = self.device.type
        if self.world_size > 1 and not dist.is_initialized():
            dist.init_process_group(
                backend="nccl" if self.platform == "cuda" else "gloo",
                init_method="env://",
                rank=self.rank,
                world_size=self.world_size,
            )

    # the row's num_processes column (one device per process here)
    @property
    def num_processes(self) -> int:
        return self.world_size

    def synchronize(self) -> None:
        """Wait until every kernel queued on this rank's device is done."""
        if self.platform == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        """A one-element ``all_reduce`` plus a device sync: every rank's
        queued work is done and every rank has arrived."""
        if self.world_size > 1:
            token = torch.ones(1, device=self.device)
            dist.all_reduce(token)
        self.synchronize()

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along dim 0, in rank order."""
        if self.world_size == 1:
            return x
        out = torch.empty(
            (self.world_size * x.shape[0], *x.shape[1:]),
            dtype=x.dtype,
            device=x.device,
        )
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x.contiguous()
        )
        return out

    def reduce_scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over ranks; rank r keeps row block r of the sum."""
        if self.world_size == 1:
            return x
        if x.shape[0] % self.world_size:
            raise ValueError(
                f"{x.shape[0]} rows do not split over {self.world_size} ranks"
            )
        out = torch.empty(
            (x.shape[0] // self.world_size, *x.shape[1:]),
            dtype=x.dtype,
            device=x.device,
        )
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, x.contiguous()
        )
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over ranks; every rank gets the whole sum."""
        if self.world_size == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x)
        return x

    def all_to_all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Row block j of ``x`` (``d`` equal blocks along dim 0) goes to
        rank j; block i of the result came from rank i (the tiled
        ``all_to_all`` with split and concat axis 0)."""
        d = self.world_size
        if d == 1:
            return x
        if x.shape[0] % d:
            raise ValueError(f"{x.shape[0]} rows do not split over {d} ranks")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous())
        return out

    def ring_shift(self, *tensors: torch.Tensor):
        """Post one ring hop of each tensor: send to rank ``(r+1) % d``,
        receive the same shape from rank ``(r-1) % d``.

        Returns ``(received, handles)``; the received tensors are valid
        once every handle's ``wait()`` has returned, so the caller can
        compute between the two. Every rank posts the same sends and
        receives in the same order, in one ``batch_isend_irecv``, with one
        tag per tensor. At world 1 the tensors themselves come back and
        there is nothing to wait for.
        """
        d = self.world_size
        if d == 1:
            return tensors, []
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("ring_shift sends contiguous tensors only")
        nxt, prv = (self.rank + 1) % d, (self.rank - 1) % d
        received = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for tag, (t, buf) in enumerate(zip(tensors, received)):
            ops.append(dist.P2POp(dist.isend, t, nxt, tag=tag))
            ops.append(dist.P2POp(dist.irecv, buf, prv, tag=tag))
        return received, dist.batch_isend_irecv(ops)

    def all_to_all_heads_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``[m/d, h, dh]`` sequence-sharded -> ``[m, h/d, dh]``
        head-sharded: head group j goes to rank j, and the sequence blocks
        arrive in rank order (the tiled ``all_to_all`` with split axis 1,
        concat axis 0)."""
        d = self.world_size
        if d == 1:
            return x
        s, h, dh = x.shape
        if h % d:
            raise ValueError(f"{h} heads do not split over {d} ranks")
        send = x.reshape(s, d, h // d, dh).transpose(0, 1).contiguous()
        out = torch.empty_like(send)  # [d, s, h/d, dh], block i from rank i
        dist.all_to_all_single(out, send)
        return out.reshape(d * s, h // d, dh)

    def all_to_all_seq_heads(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``all_to_all_heads_seq``: ``[m, h/d, dh]`` ->
        ``[m/d, h, dh]``."""
        d = self.world_size
        if d == 1:
            return x
        m, hd, dh = x.shape
        if m % d:
            raise ValueError(f"{m} rows do not split over {d} ranks")
        out = torch.empty((d, m // d, hd, dh), dtype=x.dtype, device=x.device)
        dist.all_to_all_single(out, x.contiguous())
        return out.transpose(0, 1).reshape(m // d, d * hd, dh)

    def mesh(self, dp: int, tp: int) -> "Mesh":
        """This rank's place in a ``(dp, tp)`` mesh (see ``Mesh``)."""
        return Mesh(self, dp, tp)

    def max_over_ranks(self, values: np.ndarray) -> np.ndarray:
        """Elementwise maximum of a float vector over ranks."""
        if self.world_size == 1:
            return values
        t = torch.as_tensor(values, dtype=torch.float64).to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.cpu().numpy()

    def all_ranks(self, flag: bool) -> bool:
        """True only when ``flag`` is true on every rank."""
        if self.world_size == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32).to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())


#: the tp process groups, created once per process and mesh shape:
#: ``(world, dp, tp) -> [group of dp row 0, group of dp row 1, ...]``
_TP_GROUPS: dict = {}


class Mesh:
    """A ``(dp, tp)`` mesh over the ranks, the JAX package's
    ``('dp', 'tp')`` device mesh: rank ``r`` sits at ``(r // tp, r % tp)``.

    ``dp * tp`` is the world size, or 1: a ``(1, 1)`` mesh is local to
    each rank (the ``compute_only`` members), whatever the world. The
    collectives run over this rank's tp group. Every rank creates every
    tp group, in the same order, the first time a mesh of this shape is
    asked for (``dist.new_group`` is collective); a tp group that is the
    whole world is the default group, and at tp = 1 both collectives are
    the identity.
    """

    def __init__(self, runtime: Runtime, dp: int, tp: int) -> None:
        if dp < 1 or tp < 1:
            raise ValueError(f"mesh axes must be >= 1, got dp={dp}, tp={tp}")
        self.dp, self.tp = int(dp), int(tp)
        if dp * tp == 1:
            self.dp_rank = self.tp_rank = 0
            self.tp_group = None
            return
        if dp * tp != runtime.world_size:
            raise ValueError(
                f"dp*tp = {dp * tp} != world size {runtime.world_size}"
            )
        self.dp_rank, self.tp_rank = divmod(runtime.rank, tp)
        self.tp_group = None
        if 1 < tp < dp * tp:
            key = (runtime.world_size, dp, tp)
            if key not in _TP_GROUPS:
                _TP_GROUPS[key] = [
                    dist.new_group(ranks=[d * tp + t for t in range(tp)])
                    for d in range(dp)
                ]
            self.tp_group = _TP_GROUPS[key][self.dp_rank]

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over this rank's tp group (the ``psum`` over 'tp')."""
        if self.tp == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.tp_group)
        return x

    def tp_all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate the tp group's ``x`` along dim 0 in tp order (the
        tiled ``all_gather`` over 'tp')."""
        if self.tp == 1:
            return x
        out = torch.empty(
            (self.tp * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device
        )
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x.contiguous(), group=self.tp_group
        )
        return out
