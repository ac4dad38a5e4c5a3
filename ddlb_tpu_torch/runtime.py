"""Process runtime: rank, device binding, process group and barrier.

The PyTorch counterpart of the JAX package's ``Runtime``. One process
drives one device. Rank, local rank, world size and the ranks a node
holds come from the ``torchrun`` environment (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``; a plain ``python`` launch is rank 0
of a world of 1). ``device="cuda"`` binds ``cuda:{local_rank}``,
``device="cpu"`` the host. When the world has more than one rank the
default process group is opened once per process: NCCL on the card, gloo
on the CPU, rendezvous through ``MASTER_ADDR`` / ``MASTER_PORT``
(``env://``). At world 1 no group exists and every collective below is
the identity: the all-gather and reduce-scatter of rows, the sum
all-reduce, the ring hop (``batch_isend_irecv``, by one rank or by
``offset``), and the row and head/sequence all-to-alls
(``all_to_all_single``). ``Runtime.peer_buffer`` allocates card memory
that every rank can address (``PeerBuffer``, symmetric memory over
NVLink), for the hand-written ring and all-to-all kernels.
``Runtime.mesh(dp, tp, pp)`` places the rank in a ``(dp, tp, pp)`` mesh
(``Mesh``) whose per-axis groups carry the serving model's sum and
all-gather and the training step's collectives, some of them
differentiable.
"""

from __future__ import annotations

import itertools
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
        #: ranks on this rank's node (``torchrun``'s ``LOCAL_WORLD_SIZE``;
        #: the whole world when the launcher does not say)
        self.local_world_size = _env_int("LOCAL_WORLD_SIZE", self.world_size)
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

    def all_gather_rows(self, x: torch.Tensor, async_op: bool = False):
        """Concatenate every rank's ``x`` along dim 0, in rank order. With
        ``async_op`` returns ``(out, handles)``: ``out`` is valid once every
        handle's ``wait()`` has returned (as ``ring_shift``)."""
        if self.world_size == 1:
            return (x, []) if async_op else x
        out = torch.empty(
            (self.world_size * x.shape[0], *x.shape[1:]),
            dtype=x.dtype,
            device=x.device,
        )
        work = _collective("all_gather_single", "all_gather_into_tensor")(
            out, x.contiguous(), async_op=async_op
        )
        return (out, [work]) if async_op else out

    def reduce_scatter_rows(self, x: torch.Tensor, async_op: bool = False):
        """Sum ``x`` over ranks; rank r keeps row block r of the sum. With
        ``async_op`` returns ``(out, handles)``, as ``all_gather_rows``."""
        if self.world_size == 1:
            return (x, []) if async_op else x
        if x.shape[0] % self.world_size:
            raise ValueError(
                f"{x.shape[0]} rows do not split over {self.world_size} ranks"
            )
        out = torch.empty(
            (x.shape[0] // self.world_size, *x.shape[1:]),
            dtype=x.dtype,
            device=x.device,
        )
        work = _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, x.contiguous(), async_op=async_op
        )
        return (out, [work]) if async_op else out

    def all_reduce(self, x: torch.Tensor, async_op: bool = False):
        """Sum ``x`` over ranks, in place where ``x`` is contiguous; every
        rank gets the whole sum. With ``async_op`` returns ``(sum,
        handles)``, as ``all_gather_rows``."""
        if self.world_size == 1:
            return (x, []) if async_op else x
        x = x.contiguous()
        work = dist.all_reduce(x, async_op=async_op)
        return (x, [work]) if async_op else x

    def all_to_all_rows(self, x: torch.Tensor, async_op: bool = False):
        """Row block j of ``x`` (``d`` equal blocks along dim 0) goes to
        rank j; block i of the result came from rank i (the tiled
        ``all_to_all`` with split and concat axis 0). With ``async_op``
        returns ``(out, handles)``, as ``all_gather_rows``."""
        d = self.world_size
        if d == 1:
            return (x, []) if async_op else x
        if x.shape[0] % d:
            raise ValueError(f"{x.shape[0]} rows do not split over {d} ranks")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        work = dist.all_to_all_single(out, x.contiguous(), async_op=async_op)
        return (out, [work]) if async_op else out

    def ring_shift(self, *tensors: torch.Tensor, reverse: bool = False,
                   tag: int = 0, offset: int = 1):
        """Post one ring hop of each tensor: send to rank ``(r+offset) % d``,
        receive the same shape from rank ``(r-offset) % d`` (the other way
        round with ``reverse``); ``offset`` 1 is the neighbour hop, ``t`` the
        shift-by-``t`` exchange of an all-to-all.

        Returns ``(received, handles)``; the received tensors are valid
        once every handle's ``wait()`` has returned, so the caller can
        compute between the two. Every rank posts the same sends and
        receives in the same order, in one ``batch_isend_irecv``, with one
        tag per tensor counted from ``tag`` (two hops in flight at once,
        such as the two directions of a bidirectional ring, take distinct
        tags). At world 1, or when ``offset`` is a multiple of the world
        size, the tensors themselves come back and there is nothing to wait
        for.
        """
        d = self.world_size
        if d == 1 or offset % d == 0:
            return tensors, []
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("ring_shift sends contiguous tensors only")
        nxt, prv = (self.rank + offset) % d, (self.rank - offset) % d
        if reverse:
            nxt, prv = prv, nxt
        received = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for i, (t, buf) in enumerate(zip(tensors, received)):
            ops.append(dist.P2POp(dist.isend, t, nxt, tag=tag + i))
            ops.append(dist.P2POp(dist.irecv, buf, prv, tag=tag + i))
        return received, dist.batch_isend_irecv(ops)

    def peer_buffer(self, nbytes: int) -> "PeerBuffer":
        """``nbytes`` of zeroed card memory that every rank can address
        (see ``PeerBuffer``). Collective: every rank asks for the same
        size, in the same order."""
        return PeerBuffer(self, nbytes)

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

    def mesh(self, dp: int, tp: int, pp: int = 1) -> "Mesh":
        """This rank's place in a ``(dp, tp, pp)`` mesh (see ``Mesh``)."""
        return Mesh(self, dp, tp, pp)

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


class PeerBuffer:
    """A byte buffer on each rank's card that every rank of the world can
    address: the peer memory of the hand-written ring kernels (K2-K5) and
    the all-to-all kernel (K6), which store into a peer's buffer over NVLink
    and signal it through flag words there.

    ``local`` is this rank's ``[nbytes]`` uint8 tensor, zeroed; ``ptrs[i]``
    is rank ``i``'s buffer as this process addresses it. At world 1 it is an
    ordinary allocation and ``ptrs`` holds its own address. Across ranks it
    is symmetric memory (``torch.distributed._symmetric_memory``: ``empty``
    then the collective ``rendezvous`` over the world group), zeroed and
    synchronised before the rendezvous so that no peer signals into it
    before it is clear. Allocate once per member, at set-up: the
    rendezvous is collective, and the buffer lives as long as this object.
    Card only; the CPU has no peer memory (the plain versions ride
    ``Runtime.ring_shift`` there).
    """

    def __init__(self, runtime: "Runtime", nbytes: int) -> None:
        if runtime.platform != "cuda":
            raise ValueError("peer memory exists on the card only")
        self.rank, self.world = runtime.rank, runtime.world_size
        if self.world == 1:
            self.local = torch.zeros(nbytes, dtype=torch.uint8, device=runtime.device)
            self.ptrs = (self.local.data_ptr(),)
            return
        from torch.distributed import _symmetric_memory as symm

        self.local = symm.empty(nbytes, dtype=torch.uint8, device=runtime.device)
        self.local.zero_()
        torch.cuda.synchronize(runtime.device)
        self._handle = symm.rendezvous(self.local, dist.group.WORLD)
        offset = int(getattr(self._handle, "offset", 0))
        self.ptrs = tuple(int(p) + offset for p in self._handle.buffer_ptrs)
        if self.ptrs[self.rank] != self.local.data_ptr():
            raise RuntimeError(
                "symmetric memory: this rank's peer pointer "
                f"{self.ptrs[self.rank]:#x} is not its tensor's "
                f"{self.local.data_ptr():#x}"
            )
        dist.barrier()


#: the process groups of each mesh shape, created once per process:
#: ``(world, dp, tp, pp) -> {axis: {coordinates of the other axes: group}}``
_GROUPS: dict = {}

#: the axes of a mesh, slowest first (the rank order of ``jax.make_mesh``)
AXES = ("dp", "tp", "pp")


class Mesh:
    """A ``(dp, tp, pp)`` mesh over the ranks, the JAX package's
    ``('dp', 'tp', 'pp')`` device mesh: pp varies fastest, so rank ``r``
    sits at ``dp_rank = r // (tp * pp)``, ``tp_rank = r // pp % tp``,
    ``pp_rank = r % pp`` (the row-major order in which ``jax.make_mesh``
    lays out the devices).

    ``dp * tp * pp`` is the world size, or 1: a ``(1, 1, 1)`` mesh is local
    to each rank (the ``compute_only`` members), whatever the world. The
    collectives of an axis run over this rank's group along it: the ranks
    that differ from it in that coordinate only. Every rank creates every
    group, in the same order, the first time a mesh of this shape is asked
    for (``dist.new_group`` is collective); a group that is the whole world
    is the default group, and on an axis of size 1 every collective is the
    identity.

    Besides the plain collectives (``axis_sum``, ``tp_all_gather_rows``,
    ``pp_shift``) the mesh offers the differentiable ones the
    training step goes through (``tp_all_gather``, ``tp_reduce_scatter``,
    ``tp_all_to_all``, ``tp_ring_shift``): small autograd Functions whose
    backward is the transposed collective.
    """

    def __init__(self, runtime: Runtime, dp: int, tp: int, pp: int = 1) -> None:
        if dp < 1 or tp < 1 or pp < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got dp={dp}, tp={tp}, pp={pp}"
            )
        self.dp, self.tp, self.pp = int(dp), int(tp), int(pp)
        self.sizes = {"dp": self.dp, "tp": self.tp, "pp": self.pp}
        self.groups = {axis: None for axis in AXES}
        self.world = dp * tp * pp
        if self.world == 1:
            self.dp_rank = self.tp_rank = self.pp_rank = 0
            self.tp_group = None
            return
        if self.world != runtime.world_size:
            raise ValueError(
                f"dp*tp*pp = {self.world} != world size {runtime.world_size}"
            )
        self.dp_rank, rest = divmod(runtime.rank, tp * pp)
        self.tp_rank, self.pp_rank = divmod(rest, pp)
        key = (runtime.world_size, self.dp, self.tp, self.pp)
        if key not in _GROUPS:
            _GROUPS[key] = self._new_groups()
        coords = self.coords()
        for axis in AXES:
            if 1 < self.sizes[axis] < self.world:
                other = tuple(c for a, c in coords.items() if a != axis)
                self.groups[axis] = _GROUPS[key][axis][other]
        self.tp_group = self.groups["tp"]

    def coords(self) -> dict:
        return {"dp": self.dp_rank, "tp": self.tp_rank, "pp": self.pp_rank}

    def rank_at(self, dp: int, tp: int, pp: int) -> int:
        """The global rank at mesh coordinates ``(dp, tp, pp)``."""
        return (dp * self.tp + tp) * self.pp + pp

    def _new_groups(self) -> dict:
        """Every group along every axis of size between 1 and the world,
        created in the same order on every rank."""
        out = {}
        for axis in AXES:
            out[axis] = {}
            if not 1 < self.sizes[axis] < self.world:
                continue
            others = [a for a in AXES if a != axis]
            for other in itertools.product(*(range(self.sizes[a]) for a in others)):
                members = []
                for i in range(self.sizes[axis]):
                    at = dict(zip(others, other), **{axis: i})
                    members.append(self.rank_at(at["dp"], at["tp"], at["pp"]))
                out[axis][other] = dist.new_group(ranks=members)
        return out

    def _neighbours(self, axis: str):
        """Global ranks of the next and the previous rank along ``axis``."""
        at = self.coords()
        n = self.sizes[axis]
        nxt = dict(at, **{axis: (at[axis] + 1) % n})
        prv = dict(at, **{axis: (at[axis] - 1) % n})
        return (self.rank_at(nxt["dp"], nxt["tp"], nxt["pp"]),
                self.rank_at(prv["dp"], prv["tp"], prv["pp"]))

    # -- plain collectives -------------------------------------------------------

    def axis_sum(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        """Sum ``x`` over the named axes (the ``psum``), one all-reduce per
        axis of size > 1, in place where ``x`` is contiguous: pass a tensor
        the caller owns. Returns the sum."""
        for axis in axes:
            if self.sizes[axis] > 1:
                x = x.contiguous()
                dist.all_reduce(x, group=self.groups[axis])
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

    def tp_reduce_scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        if x.shape[0] % self.tp:
            raise ValueError(f"{x.shape[0]} rows do not split over tp={self.tp}")
        out = torch.empty(
            (x.shape[0] // self.tp, *x.shape[1:]), dtype=x.dtype, device=x.device
        )
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, x.contiguous(), group=self.tp_group
        )
        return out

    def _tp_all_to_all_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        if x.shape[0] % self.tp:
            raise ValueError(f"{x.shape[0]} rows do not split over tp={self.tp}")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=self.tp_group)
        return out

    def shift(self, axis: str, *tensors: torch.Tensor, reverse: bool = False):
        """One ring hop along ``axis``: each tensor goes to the next rank
        (the previous with ``reverse``) and the same shapes come back from
        the other side, in one ``batch_isend_irecv`` posted in the same
        order on every rank; waits for them. The identity on an axis of
        size 1."""
        if self.sizes[axis] == 1:
            return tensors
        nxt, prv = self._neighbours(axis)
        if reverse:
            nxt, prv = prv, nxt
        group = self.groups[axis]
        tensors = tuple(t.contiguous() for t in tensors)
        received = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for tag, (t, buf) in enumerate(zip(tensors, received)):
            ops.append(dist.P2POp(dist.isend, t, nxt, group=group, tag=tag))
            ops.append(dist.P2POp(dist.irecv, buf, prv, group=group, tag=tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return received

    def pp_shift(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """The pipeline hop (the ``ppermute`` to the next stage, :951), or
        back to the previous stage with ``reverse``."""
        return self.shift("pp", x, reverse=reverse)[0]

    # -- differentiable collectives ------------------------------------------------

    def tp_all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tiled ``all_gather`` over 'tp' along ``dim``; its gradient
        is the reduce-scatter."""
        return _AllGather.apply(x, self, dim)

    def tp_reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tiled ``psum_scatter`` over 'tp' along ``dim``; its gradient
        is the all-gather."""
        return _ReduceScatter.apply(x, self, dim)

    def tp_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled ``all_to_all`` over 'tp' with split and concat axis 0;
        its gradient is the same all-to-all."""
        return _AllToAll.apply(x, self)

    def tp_ring_shift(self, *tensors: torch.Tensor):
        """One hop of the tp ring (the ``ppermute`` to the next tp rank);
        its gradient is the hop back."""
        return _RingShift.apply(self, *tensors)


def _along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` of the rows of ``x`` with ``dim`` moved to the front."""
    return fn(x.movedim(dim, 0).contiguous()).movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _along(mesh.tp_all_gather_rows, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _along(ctx.mesh.tp_reduce_scatter_rows, g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _along(mesh.tp_reduce_scatter_rows, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _along(ctx.mesh.tp_all_gather_rows, g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh._tp_all_to_all_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._tp_all_to_all_rows(g), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        out = mesh.shift("tp", *tensors)
        return tuple(t.clone() if t is s else t for t, s in zip(out, tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.mesh.shift("tp", *grads, reverse=True))
