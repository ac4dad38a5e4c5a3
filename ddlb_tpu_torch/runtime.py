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
all-reduce, the broadcast, the ring hop (``batch_isend_irecv``, by one
rank or by ``offset``; ``ring_exchange`` both ways at once), and the row
and head/sequence all-to-alls (``all_to_all_single``).
``Runtime.chip_spec`` is the device's hardware spec (``perfmodel/specs``).

The world's topology: ``Runtime.slice_ids`` gives each rank its node
(the JAX package's slice), from ``DDLB_TPU_SIM_SLICES`` (that many equal
contiguous blocks of ranks, the JAX package's simulation knob) or else
torchrun's ``LOCAL_WORLD_SIZE`` (``node_assignment``). ``order_ring``
lays the ring out for a ``transport`` (``transport_order``: ``ici``
keeps each node's ranks together, ``dcn`` interleaves the nodes, so every
hop crosses a node). The ring position ``Runtime.position`` of a rank is
its index in ``Runtime.order``; row block ``p`` of a global array lies
on the rank at position ``p``, and every collective below speaks in
positions: a gather returns blocks in position order, a scatter leaves a
rank the block of its position, a ring hop goes to the next position,
and ``peer_buffer``'s table is ordered by position. NCCL and gloo work
in rank order and choose their own route, so around them the blocks are
permuted by position; under the identity order (``ici``, or one node)
there is nothing to permute. ``Runtime.axis_groups`` is the world as a
grid of named axes in node order (``two_level``: ``(dcn, ici)``, node
and card in node; ``torus``: ``(dcn, sx, sy)``, each node split by
``perfmodel.cost.torus_factors``), with one process group along each
axis, for the topology compositions.
``Runtime.peer_buffer`` allocates card memory that every rank can
address (``PeerBuffer``, symmetric memory over NVLink), for the
hand-written ring and all-to-all kernels.
``Runtime.mesh(dp, tp, pp)`` places the rank in a ``(dp, tp, pp)`` mesh
(``Mesh``) whose per-axis groups carry the serving model's sum and
all-gather and the training step's collectives, some of them
differentiable; with ``ranks`` the mesh spans those ranks only (one
serving engine's group, whose groups every rank first creates with
``Runtime.subgroups``). ``broadcast_host`` (a float, such as a drain's
clock) and ``gather_objects`` (picklable host data, such as a serving
cluster's per-pump exchange) agree on host values: on gloo over the
default group, on the card through card buffers read back, over an NCCL
group and a CUDA stream of their own, so they wait neither for the card's
queued work nor behind the model's collectives (the channels are timed in
``PERF.md`` §6). ``Runtime.device_mesh(names, shape)`` is
the same mesh as a ``torch.distributed`` ``DeviceMesh``, for the
``compiled`` members' DTensors; at world 1 it opens a one-rank default
group for them.
``shutdown()`` drops the compiled graphs and destroys the default group
with every mesh built on it (not the one-rank group of world 1).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.telemetry import clocksync

DEVICES = ("cuda", "cpu")
#: bytes of a rank's buffer in ``Runtime.gather_objects``' first round
GATHER_BYTES = 4096
#: the transports a ring can be laid out for (``transport_order``)
TRANSPORTS = ("ici", "dcn")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value.strip() else default


def env_rank() -> int:
    """This process's rank as the launcher set it (0 without one)."""
    return _env_int("RANK", 0)


def node_assignment(world: int, local_world_size: int,
                    sim_slices: int = 0) -> tuple:
    """Each rank's node (the JAX package's slice): with ``sim_slices`` > 1
    (``DDLB_TPU_SIM_SLICES``) that many equal contiguous blocks of ranks,
    which must divide the world; else torchrun's nodes of
    ``local_world_size`` ranks each."""
    if sim_slices > 1:
        if world % sim_slices:
            raise ValueError(
                f"DDLB_TPU_SIM_SLICES={sim_slices} does not divide {world} ranks"
            )
        per = world // sim_slices
    else:
        per = max(1, local_world_size)
    return tuple(r // per for r in range(world))


def transport_order(world: int, slice_ids, transport: str) -> tuple:
    """The ring laid out for ``transport`` (the device order of the JAX
    package's ``Runtime.transport_mesh``): position -> rank. ``ici``
    groups the ranks by node, so hops stay in a node but at node
    boundaries (the identity order when nodes are contiguous); ``dcn``
    takes the nodes round-robin, so every hop crosses a node. On one node
    both are the same layout, and ``dcn`` says so."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be 'ici' or 'dcn', got {transport!r}")
    slice_ids = tuple(slice_ids)
    nodes = sorted(set(slice_ids))
    if transport == "dcn" and len(nodes) <= 1:
        telemetry.warn(
            "transport='dcn' requested but the world shows a single node: "
            "the dcn and ici ring layouts are identical here"
        )
    order = sorted(range(world), key=lambda r: (slice_ids[r], r))
    if transport == "dcn" and len(nodes) > 1:
        by_node = [[r for r in order if slice_ids[r] == s] for s in nodes]
        order = [grp[j] for j in range(max(len(g) for g in by_node))
                 for grp in by_node if j < len(grp)]
    return tuple(order)


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
        #: each rank's node (``node_assignment``) and the number of nodes
        self.slice_ids = node_assignment(
            self.world_size, self.local_world_size,
            _env_int("DDLB_TPU_SIM_SLICES", 0),
        )
        self.num_slices = len(set(self.slice_ids))
        #: the device buffers and stream of ``broadcast_host`` and
        #: ``gather_objects``
        self._scalar = self._gather = self._stream = None
        #: ring position -> rank, and this rank's position (``order_ring``)
        self.order = tuple(range(self.world_size))
        self.position = self.rank
        self._perm = None
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

    def order_ring(self, transport: str) -> None:
        """Lay the ring out for ``transport`` (``transport_order``): sets
        ``order`` and ``position``, which every collective of this runtime
        then follows. Call it before any operand is placed."""
        self.order = transport_order(self.world_size, self.slice_ids, transport)
        self.position = self.order.index(self.rank)
        self._perm = None
        if self.order != tuple(range(self.world_size)):
            order = torch.tensor(self.order, device=self.device)
            #: (position -> rank, rank -> position) as index tensors on the device
            self._perm = (order, torch.argsort(order))

    def blocks_by_rank(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s d row blocks, held in position order, in rank order:
        block ``i`` of the result is the block of rank ``i``'s position
        (what a rank-ordered scatter or all-to-all must be handed)."""
        if self._perm is None:
            return x
        return x.unflatten(0, (self.world_size, -1))[self._perm[1]].flatten(0, 1)

    def blocks_by_position(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``blocks_by_rank``: ``x``'s d row blocks, from
        ranks in rank order (what a gather returns), in position order."""
        if self._perm is None:
            return x
        return x.unflatten(0, (self.world_size, -1))[self._perm[0]].flatten(0, 1)

    def _then_by_position(self, raw: torch.Tensor, works, async_op: bool):
        """A rank-ordered collective's result ``raw`` in position order,
        once ``works`` are done: with ``async_op`` ``(out, handles)``, the
        permutation made by the handles' ``wait()``."""
        if self._perm is None:
            return (raw, works) if async_op else raw
        if not async_op:
            return self.blocks_by_position(raw)
        out = torch.empty_like(raw)
        return out, [_Then(works, lambda: out.copy_(self.blocks_by_position(raw)))]

    # the row's num_processes column (one device per process here)
    @property
    def num_processes(self) -> int:
        return self.world_size

    @property
    def chip_spec(self):
        """The hardware spec of this rank's device
        (``perfmodel.specs.ChipSpec``): the CPU entry on the host, the
        entry for the card's name on CUDA; raises ``ValueError`` for a
        card the registry does not hold."""
        from ddlb_tpu_torch.perfmodel.specs import spec_for_device

        return spec_for_device(self.platform, self.device_kind)

    def synchronize(self) -> None:
        """Wait until every kernel queued on this rank's device is done."""
        if self.platform == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        """A one-element ``all_reduce`` plus a device sync: every rank's
        queued work is done and every rank has arrived.

        Traced as a ``runtime.barrier`` span. Its wait lands in the row's
        ``barrier_wait_s``: the blocking all-reduce on gloo, the device
        sync on NCCL (whose ``all_reduce`` returns once queued). The
        communicator's first use sets it up; that cost is paid once per
        process by a warming all-reduce outside the measured wait. The
        barrier is a clock-sync exchange point: its monotonic enter/exit
        stamps go to ``clocksync.record_span`` for the row's skew fold,
        and a ``clocksync.exchange`` instant anchors this process's
        monotonic clock to the trace's epoch stamps.
        """
        key = (self.platform, self.world_size)
        if self.world_size > 1 and key not in _WARM_BARRIERS:
            dist.all_reduce(torch.ones(1, device=self.device))
            self.synchronize()
            _WARM_BARRIERS.add(key)
        t_enter = time.monotonic()
        with telemetry.span("runtime.barrier", cat="barrier"):
            t0 = time.perf_counter()
            if self.world_size > 1:
                dist.all_reduce(torch.ones(1, device=self.device))
                if self.platform == "cuda":
                    # NCCL's all_reduce returns once queued: the wait is the sync
                    t0 = time.perf_counter()
            self.synchronize()
            telemetry.record("barrier_wait_s", time.perf_counter() - t0)
        t_exit = time.monotonic()
        clocksync.record_span("runtime.barrier", t_enter, t_exit)
        telemetry.instant("clocksync.exchange", cat="clocksync", mono_t=t_exit,
                          site="runtime.barrier")

    def all_gather_rows(self, x: torch.Tensor, async_op: bool = False):
        """Concatenate every rank's ``x`` along dim 0, in position order.
        With ``async_op`` returns ``(out, handles)``: ``out`` is valid once
        every handle's ``wait()`` has returned (as ``ring_shift``)."""
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
        return self._then_by_position(out, [work], async_op)

    def reduce_scatter_rows(self, x: torch.Tensor, async_op: bool = False):
        """Sum ``x`` over ranks; the rank at position p keeps row block p of
        the sum. With ``async_op`` returns ``(out, handles)``, as
        ``all_gather_rows``."""
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
            out, self.blocks_by_rank(x).contiguous(), async_op=async_op
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

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """The ``x`` of the rank at ring position ``src`` on every rank, in
        place (``x`` must be contiguous and of the same shape everywhere);
        returns it."""
        if self.world_size > 1:
            dist.broadcast(x, self.order[src])
        return x

    def _agreement(self):
        """The process group and the CUDA stream of host agreement
        (``broadcast_host``, ``gather_objects``). On the card, an NCCL group
        over the world of its own, driven from a stream of its own: reading
        the result back then waits neither for the card's queued work nor
        behind the model's collectives on the default group. On gloo, the
        default group and no stream. The group is created at the first
        agreement (collective: every rank agrees at the same points)."""
        if self.platform != "cuda":
            return None, contextlib.nullcontext()
        key = ("agreement", self.world_size)
        if key not in _SUBGROUPS:
            _SUBGROUPS[key] = dist.new_group(ranks=list(range(self.world_size)))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return _SUBGROUPS[key], torch.cuda.stream(self._stream)

    def broadcast_host(self, value: float, src: int = 0) -> float:
        """Rank ``src``'s float on every rank (a float64 on this rank's
        device, kept between calls, read back; ``_agreement``)."""
        if self.world_size == 1:
            return float(value)
        group, stream = self._agreement()
        with stream:
            if self._scalar is None:
                self._scalar = torch.zeros(1, dtype=torch.float64, device=self.device)
            if self.rank == src:
                self._scalar.fill_(value)
            dist.broadcast(self._scalar, src, group=group)
            return float(self._scalar.item())

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable host data), in rank order: one
        all-gather of a ``GATHER_BYTES`` buffer a rank that holds the
        pickle's length and, when it fits, the pickle; a second all-gather
        at the longest length only when some rank's pickle did not fit.
        The buffers go through this rank's device (``_agreement``)."""
        if self.world_size == 1:
            return [obj]
        data = np.frombuffer(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL), np.uint8)
        n = data.size
        buf = np.zeros(8 + GATHER_BYTES, np.uint8)
        buf[:8] = np.array([n], np.int64).view(np.uint8)
        if n <= GATHER_BYTES:
            buf[8:8 + n] = data
        parts = self._all_gather_host(buf)
        sizes = parts[:, :8].copy().view(np.int64)[:, 0]
        if sizes.max() > GATHER_BYTES:
            big = np.zeros(sizes.max(), np.uint8)
            big[:n] = data
            parts = self._all_gather_host(big)
        else:
            parts = parts[:, 8:]
        return [pickle.loads(p[:m].tobytes()) for p, m in zip(parts, sizes)]

    def _all_gather_host(self, buf: np.ndarray) -> np.ndarray:
        """Every rank's equal-sized ``buf`` as the rows of one array (valid
        until the next call: the first round's device buffers are kept)."""
        n = buf.size
        group, stream = self._agreement()
        with stream:
            if n == 8 + GATHER_BYTES:
                if self._gather is None:
                    self._gather = (torch.empty(n, dtype=torch.uint8, device=self.device),
                                    torch.empty(self.world_size * n, dtype=torch.uint8,
                                                device=self.device))
                src, out = self._gather
                src.copy_(torch.from_numpy(buf))
            else:
                src = torch.from_numpy(buf).to(self.device)
                out = torch.empty(self.world_size * n, dtype=torch.uint8, device=self.device)
            _collective("all_gather_single", "all_gather_into_tensor")(out, src, group=group)
            return out.cpu().numpy().reshape(self.world_size, n)

    def all_to_all_rows(self, x: torch.Tensor, async_op: bool = False):
        """Row block j of ``x`` (``d`` equal blocks along dim 0) goes to
        position j; block i of the result came from position i (the tiled
        ``all_to_all`` with split and concat axis 0). With ``async_op``
        returns ``(out, handles)``, as ``all_gather_rows``."""
        d = self.world_size
        if d == 1:
            return (x, []) if async_op else x
        if x.shape[0] % d:
            raise ValueError(f"{x.shape[0]} rows do not split over {d} ranks")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        work = dist.all_to_all_single(out, self.blocks_by_rank(x).contiguous(),
                                      async_op=async_op)
        return self._then_by_position(out, [work], async_op)

    def ring_shift(self, *tensors: torch.Tensor, reverse: bool = False,
                   tag: int = 0, offset: int = 1):
        """Post one ring hop of each tensor: send to ring position
        ``(p+offset) % d``, receive the same shape from position
        ``(p-offset) % d`` (the other way round with ``reverse``); ``offset``
        1 is the neighbour hop, ``t`` the shift-by-``t`` exchange of an
        all-to-all.

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
        nxt, prv = self._neighbours(offset)
        if reverse:
            nxt, prv = prv, nxt
        return _post_hops([(t, nxt, prv) for t in tensors], tag=tag)

    def _neighbours(self, offset: int = 1):
        """The ranks ``offset`` positions ahead of and behind this one."""
        d, p = self.world_size, self.position
        return self.order[(p + offset) % d], self.order[(p - offset) % d]

    def ring_exchange(self, right=None, left=None):
        """One ring hop each way, posted together in one
        ``batch_isend_irecv`` and waited for: ``right`` goes to the next
        position, ``left`` to the previous one (either may be None: not sent).
        Returns ``(from_previous, from_next)``, None where nothing was sent;
        at world 1 each tensor comes back to this rank."""
        d = self.world_size
        if d == 1:
            return right, left
        return _exchange(right, left, *self._neighbours(), None)

    def peer_buffer(self, nbytes: int) -> "PeerBuffer":
        """``nbytes`` of zeroed card memory that every rank can address
        (see ``PeerBuffer``). Collective: every rank asks for the same
        size, in the same order."""
        return PeerBuffer(self, nbytes)

    def all_to_all_heads_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``[m/d, h, dh]`` sequence-sharded -> ``[m, h/d, dh]``
        head-sharded: head group j goes to position j, and the sequence
        blocks arrive in position order (the tiled ``all_to_all`` with split
        axis 1, concat axis 0)."""
        d = self.world_size
        if d == 1:
            return x
        s, h, dh = x.shape
        if h % d:
            raise ValueError(f"{h} heads do not split over {d} ranks")
        send = x.reshape(s, d, h // d, dh).transpose(0, 1)
        send = self.blocks_by_rank(send).contiguous()
        out = torch.empty_like(send)  # [d, s, h/d, dh], block i from rank i
        dist.all_to_all_single(out, send)
        return self.blocks_by_position(out).reshape(d * s, h // d, dh)

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
        dist.all_to_all_single(out, self.blocks_by_rank(x).contiguous())
        out = self.blocks_by_position(out)
        return out.transpose(0, 1).reshape(m // d, d * hd, dh)

    def axis_groups(self, view: str) -> "AxisGroups":
        """The world as a grid of named axes in node order: ``two_level``,
        ``(dcn, ici)`` of shape ``(nodes, cards a node)`` (the JAX
        package's ``hybrid_mesh``), or ``torus``, ``(dcn, sx, sy)`` with
        ``(sx, sy) = torus_factors(cards a node)`` (its ``torus_mesh``; the
        same rank order). Collective the first time a view is asked for."""
        from ddlb_tpu_torch.perfmodel.cost import torus_factors

        per = self.world_size // self.num_slices
        if per * self.num_slices != self.world_size or any(
                s != r // per for r, s in enumerate(self.slice_ids)):
            raise ValueError(
                f"the world of {self.world_size} ranks is not {self.num_slices} "
                f"equal contiguous nodes (slice ids {self.slice_ids})"
            )
        if view == "two_level":
            return AxisGroups(self, ("dcn", "ici"), (self.num_slices, per))
        if view == "torus":
            return AxisGroups(self, ("dcn", "sx", "sy"),
                              (self.num_slices, *torus_factors(per)))
        raise ValueError(f"view must be 'two_level' or 'torus', got {view!r}")

    def mesh(self, dp: int, tp: int, pp: int = 1, ranks=None) -> "Mesh":
        """This rank's place in a ``(dp, tp, pp)`` mesh over the world, or
        over ``ranks`` (see ``Mesh``); traced as ``runtime.mesh_build``."""
        with telemetry.span("runtime.mesh_build", cat="runtime", axes="dp,tp,pp"):
            return Mesh(self, dp, tp, pp, ranks)

    def subgroups(self, groups) -> list:
        """The process group of each rank list in ``groups``, created in
        order the first time (None for the whole world). Collective: every
        rank passes the same lists, those it is not in too."""
        if self.world_size == 1:
            return [None for _ in groups]
        return [_subgroup(sorted(int(r) for r in g)) for g in groups]

    def device_mesh(self, names, shape):
        """The ranks as a ``DeviceMesh`` with the named axes, in ``Mesh``'s
        order (the last axis fastest, as ``jax.make_mesh`` lays devices out),
        for DTensor placements.

        Axes of size 1 are left out (one axis is kept when every axis is
        1): a placement over one rank is the identity, and DTensor's
        sharding propagation enumerates placements per mesh dimension, so
        each extra dimension multiplies its work. ``placements`` takes the
        full axis names and skips the absent ones. At world 1 there is no
        process group (``__init__``), so the first call opens a one-rank
        default group from an in-memory store: NCCL on the card, gloo on
        the CPU; it stays for the life of the process (``shutdown``).
        Meshes are cached per platform and the axes they keep, so that two
        requests that leave the same axes (``("dp", "tp"), (1, 1)`` and
        ``("dp", "tp", "pp"), (1, 1, 1)``) share one ``DeviceMesh``: under
        torch 2.13 a second, equal ``DeviceMesh`` breaks the next compiled
        backward (``shutdown``).
        """
        from torch.distributed.device_mesh import DeviceMesh

        names, shape = tuple(names), tuple(int(s) for s in shape)
        if len(names) != len(shape) or int(np.prod(shape)) != self.world_size:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} does not cover the world of "
                f"{self.world_size} ranks"
            )
        kept = [i for i, s in enumerate(shape) if s > 1] or [0]
        key = (self.platform, tuple(names[i] for i in kept), tuple(shape[i] for i in kept))
        if key not in _DEVICE_MESHES:
            with telemetry.span("runtime.mesh_build", cat="runtime", axes=",".join(key[1])):
                if not dist.is_initialized():
                    dist.init_process_group(
                        backend="nccl" if self.platform == "cuda" else "gloo",
                        store=dist.HashStore(), rank=0, world_size=1,
                    )
                    _LOCAL_GROUP.append(True)
                ranks = torch.arange(self.world_size).reshape([shape[i] for i in kept])
                _DEVICE_MESHES[key] = DeviceMesh(self.platform, ranks,
                                                 mesh_dim_names=key[1])
        return _DEVICE_MESHES[key]

    def max_over_ranks(self, values: np.ndarray) -> np.ndarray:
        """Elementwise maximum of a float vector over ranks. Its enter and
        exit stamps go to the row's skew fold as a ``runtime.collective``
        span (a collective the fold attributes but never fits clocks on:
        ``clocksync.FIT_SITES``)."""
        if self.world_size == 1:
            return values
        t = torch.as_tensor(values, dtype=torch.float64).to(self.device)
        t_enter = time.monotonic()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = t.cpu().numpy()
        clocksync.record_span("runtime.collective", t_enter, time.monotonic())
        return out

    def all_ranks(self, flag: bool) -> bool:
        """True only when ``flag`` is true on every rank."""
        if self.world_size == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32).to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())


#: ``Runtime.device_mesh``'s meshes by (platform, kept names, kept shape)
_DEVICE_MESHES: dict = {}
#: True once ``Runtime.device_mesh`` opened a one-rank default group
_LOCAL_GROUP: list = []
#: (platform, world size) of the default groups whose barrier was warmed
_WARM_BARRIERS: set = set()


def placements(mesh, axes: dict) -> list:
    """DTensor placements on ``mesh`` (``Runtime.device_mesh``) from
    ``{axis name: sharded dim}``: ``Shard(dim)`` on a named axis,
    ``Replicate()`` on the others; axes the mesh left out are skipped. On
    an axis of one rank (a world of 1) sharded and replicated are the same
    layout, and ``Replicate()`` is given: some DTensor rules of torch 2.11
    fail on a shard over one rank (the embedding's ``index_put``
    backward)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(axes[name]) if name in axes and size > 1 else Replicate()
            for name, size in zip(mesh.mesh_dim_names, mesh.shape)]


def mesh_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``Runtime.device_mesh`` (1 where the
    mesh left it out)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def mesh_coordinate(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` of a ``Runtime.device_mesh``
    (0 where the mesh left it out)."""
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def shutdown() -> None:
    """End a run: drop Dynamo's compiled graphs (the ``compiled`` members'
    graphs hold the group and its meshes), then destroy the default process
    group with the meshes and groups built on it. A later run in the same
    process opens them anew.

    The one-rank group ``Runtime.device_mesh`` opens at world 1 stays, with
    its meshes, for the life of the process: a second ``DeviceMesh`` equal
    to one a compiled backward already used breaks the next compiled
    backward (torch 2.13's AOTAutograd partitioner: "Node tangents_2 was
    invalid, but is output")."""
    torch._dynamo.reset()
    if _LOCAL_GROUP or not dist.is_initialized():
        return
    _DEVICE_MESHES.clear()
    _GROUPS.clear()
    _SUBGROUPS.clear()
    _WARM_BARRIERS.clear()
    dist.destroy_process_group()


class PeerBuffer:
    """A byte buffer on each rank's card that every rank of the world can
    address: the peer memory of the hand-written ring kernels (K2-K5) and
    the all-to-all kernel (K6), which store into a peer's buffer over NVLink
    and signal it through flag words there.

    ``local`` is this rank's ``[nbytes]`` uint8 tensor, zeroed; ``ptrs[i]``
    is the buffer of the rank at ring position ``i`` (``Runtime.order``) as
    this process addresses it, and ``rank`` this rank's position, so a
    kernel that walks the table in index order walks the ring laid out for
    the transport. At world 1 it is an
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
        self.rank, self.world = runtime.position, runtime.world_size
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
        by_rank = [int(p) + offset for p in self._handle.buffer_ptrs]
        self.ptrs = tuple(by_rank[r] for r in runtime.order)
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

    With ``ranks`` (fewer than the world) the mesh spans those ranks only,
    laid out in their order, and ``dp * tp * pp`` is their number: a
    serving cluster's engine on its own group of ranks. Only the ranks in
    it build such a mesh, so its groups must exist before it is asked for:
    every rank of the world creates them with ``Runtime.subgroups``, and a
    missing one raises rather than hanging the ranks that did not ask.

    Besides the plain collectives (``axis_sum``, ``tp_all_gather_rows``,
    ``pp_shift``) the mesh offers the differentiable ones the
    training step goes through (``tp_all_gather``, ``tp_reduce_scatter``,
    ``tp_all_to_all``, ``tp_ring_shift``): small autograd Functions whose
    backward is the transposed collective.
    """

    #: the global ranks a mesh over some ranks spans, in mesh order (None:
    #: the mesh is the world's, or local to each rank)
    ranks = None

    def __init__(self, runtime: Runtime, dp: int, tp: int, pp: int = 1,
                 ranks=None) -> None:
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
        if ranks is not None and len(ranks) < runtime.world_size:
            self.ranks = tuple(int(r) for r in ranks)
        size = runtime.world_size if self.ranks is None else len(self.ranks)
        if self.world != size:
            raise ValueError(
                f"dp*tp*pp = {self.world} != world size {runtime.world_size}"
                if self.ranks is None else
                f"dp*tp*pp = {self.world} != the {size} ranks {self.ranks}"
            )
        if self.ranks is not None and runtime.rank not in self.ranks:
            raise ValueError(f"rank {runtime.rank} is not in the mesh's ranks {self.ranks}")
        local = runtime.rank if self.ranks is None else self.ranks.index(runtime.rank)
        self.dp_rank, rest = divmod(local, tp * pp)
        self.tp_rank, self.pp_rank = divmod(rest, pp)
        coords = self.coords()
        if self.ranks is not None:
            # a mesh over some ranks: its lines' groups exist already
            for axis in AXES:
                if self.sizes[axis] > 1:
                    line = [self.rank_at(**dict(coords, **{axis: i}))
                            for i in range(self.sizes[axis])]
                    self.groups[axis] = _subgroup(sorted(line), create=False)
            self.tp_group = self.groups["tp"]
            return
        key = (runtime.world_size, self.dp, self.tp, self.pp)
        if key not in _GROUPS:
            _GROUPS[key] = self._new_groups()
        for axis in AXES:
            if 1 < self.sizes[axis] < self.world:
                other = tuple(c for a, c in coords.items() if a != axis)
                self.groups[axis] = _GROUPS[key][axis][other]
        self.tp_group = self.groups["tp"]

    def coords(self) -> dict:
        return {"dp": self.dp_rank, "tp": self.tp_rank, "pp": self.pp_rank}

    def rank_at(self, dp: int, tp: int, pp: int) -> int:
        """The global rank at mesh coordinates ``(dp, tp, pp)``."""
        i = (dp * self.tp + tp) * self.pp + pp
        return i if self.ranks is None else self.ranks[i]

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

    def axis_min(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise minimum of ``x`` over the named axis (the ``pmin``),
        in place where ``x`` is contiguous. Returns the minimum."""
        if self.sizes[axis] > 1:
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.MIN, group=self.groups[axis])
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
        received, works = _post_hops([(t.contiguous(), nxt, prv) for t in tensors],
                                     self.groups[axis])
        for work in works:
            work.wait()
        return received

    def exchange(self, axis: str, right=None, left=None):
        """``Runtime.ring_exchange`` along ``axis``: ``right`` to the next
        rank, ``left`` to the previous one, in one ``batch_isend_irecv``,
        waited for; returns ``(from_previous, from_next)``. On an axis of
        size 1 each tensor comes back to this rank."""
        if self.sizes[axis] == 1:
            return right, left
        nxt, prv = self._neighbours(axis)
        return _exchange(right, left, nxt, prv, self.groups[axis])

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


#: process groups by their ranks, created once per process
#: (``_subgroup``): ``(world, ranks) -> group``
_SUBGROUPS: dict = {}


def _subgroup(ranks, create: bool = True) -> object:
    """The process group of ``ranks`` (sorted), created the first time;
    collective: every rank asks for the same groups in the same order. The
    whole world is the default group (None). With ``create=False`` a group
    not made yet raises instead (a caller that only some ranks reach)."""
    ranks = tuple(ranks)
    world = dist.get_world_size()
    if len(ranks) == world:
        return None
    key = (world, ranks)
    if key not in _SUBGROUPS:
        if not create:
            raise ValueError(
                f"no process group over ranks {ranks} yet: every rank must "
                "create it first (Runtime.subgroups)"
            )
        _SUBGROUPS[key] = dist.new_group(ranks=list(ranks))
    return _SUBGROUPS[key]


class AxisGroups:
    """The ranks as a row-major grid of named axes (``Runtime.axis_groups``;
    the last axis fastest, as ``jax.sharding.Mesh`` lays out an array of
    devices), with this rank's coordinate on each axis and one process group
    along each axis between 1 and the world in size. The collectives run
    over this rank's group along one axis; on an axis of size 1 they are
    the identity. Every rank creates every group, once per process.
    """

    def __init__(self, runtime: Runtime, names, shape) -> None:
        self.names, self.shape = tuple(names), tuple(int(s) for s in shape)
        if int(np.prod(self.shape)) != runtime.world_size:
            raise ValueError(f"axes {dict(zip(self.names, self.shape))} do not "
                             f"cover the world of {runtime.world_size} ranks")
        grid = np.arange(runtime.world_size).reshape(self.shape)
        at = np.unravel_index(runtime.rank, self.shape)
        self.coords = dict(zip(self.names, (int(c) for c in at)))
        self.groups = {}
        for i, name in enumerate(self.names):
            if self.shape[i] == 1:
                continue
            lines = np.moveaxis(grid, i, -1)
            for line in lines.reshape(-1, self.shape[i]):
                _subgroup(line.tolist())  # every rank creates every group
            mine = lines[tuple(c for j, c in enumerate(at) if j != i)]
            self.groups[name] = _subgroup(mine.tolist())

    def size(self, axis: str) -> int:
        return self.shape[self.names.index(axis)]

    def all_gather_rows(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The tiled ``all_gather`` over ``axis`` along dim 0, in coordinate
        order."""
        n = self.size(axis)
        if n == 1:
            return x
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x.contiguous(), group=self.groups[axis])
        return out

    def reduce_scatter_rows(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The tiled ``psum_scatter`` over ``axis`` along dim 0: coordinate
        j keeps row block j of the sum."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {axis}={n}")
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, x.contiguous(), group=self.groups[axis])
        return out

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``psum`` over ``axis``, in place where ``x`` is contiguous:
        pass a tensor the caller owns."""
        if self.size(axis) > 1:
            x = x.contiguous()
            dist.all_reduce(x, group=self.groups[axis])
        return x

    def all_to_all_rows(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The tiled ``all_to_all`` over ``axis`` with split and concat
        axis 0: row block j goes to coordinate j, block i of the result
        came from coordinate i."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {axis}={n}")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=self.groups[axis])
        return out


class _Then:
    """A handle whose ``wait()`` waits for ``works``, then runs ``after``."""

    def __init__(self, works, after) -> None:
        self.works, self.after = works, after

    def wait(self) -> bool:
        for work in self.works:
            work.wait()
        self.after()
        return True


def _post_hops(hops, group=None, tag: int = 0):
    """Post every ``(tensor, to, frm)`` hop (send ``tensor`` to global rank
    ``to``, receive the same shape from ``frm``) in one
    ``batch_isend_irecv``, a tag a hop counted from ``tag``. Returns
    ``(received, works)``; the received tensors are valid once every work's
    ``wait()`` has returned."""
    received = tuple(torch.empty_like(t) for t, _, _ in hops)
    ops = []
    for i, ((t, to, frm), buf) in enumerate(zip(hops, received)):
        ops.append(dist.P2POp(dist.isend, t, to, group=group, tag=tag + i))
        ops.append(dist.P2POp(dist.irecv, buf, frm, group=group, tag=tag + i))
    return received, dist.batch_isend_irecv(ops)


def _exchange(right, left, nxt: int, prv: int, group):
    """The hops of ``ring_exchange``/``Mesh.exchange`` between the global
    ranks ``nxt`` and ``prv``, waited for."""
    sent = [(t.contiguous(), to, frm) for t, to, frm in ((right, nxt, prv), (left, prv, nxt))
            if t is not None]
    if not sent:
        return None, None
    received, works = _post_hops(sent, group)
    for work in works:
        work.wait()
    got = iter(received)
    return tuple(None if t is None else next(got) for t in (right, left))


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
