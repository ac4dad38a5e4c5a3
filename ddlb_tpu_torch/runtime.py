"""Process runtime: rank, device binding, process group and barrier.

The PyTorch counterpart of the JAX package's ``Runtime``. One process
drives one device. Rank, local rank and world size come from the
``torchrun`` environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``; a plain
``python`` launch is rank 0 of a world of 1). ``device="cuda"`` binds
``cuda:{local_rank}``, ``device="cpu"`` the host. When the world has more
than one rank the default process group is opened once per process: NCCL
on the card, gloo on the CPU, rendezvous through ``MASTER_ADDR`` /
``MASTER_PORT`` (``env://``). At world 1 no group exists and every
collective below is the identity.
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
