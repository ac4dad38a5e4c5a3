"""Helpers shared by the ``test_torch_*`` files: move results between the
JAX package and its PyTorch port as numpy arrays, the tolerances the
parity tests state, and a stand-in for the built flash library."""

import contextlib
import types

import numpy as np
import torch

#: bfloat16 keeps 8 significant bits (7 stored)
BF16_MANTISSA_BITS = 7


def to_numpy(x) -> np.ndarray:
    """A torch tensor or a JAX array as a float64 host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def bits(x) -> np.ndarray:
    """The raw bit patterns of a bf16/f32 torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        width = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return x.detach().cpu().contiguous().view(width[x.dtype]).numpy()
    host = np.asarray(x)
    return host.view(np.int16 if host.dtype.itemsize == 2 else np.int32)


def bf16_ulp(magnitude: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 values at ``magnitude`` (elementwise)."""
    m = np.maximum(np.abs(magnitude), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(m)) - BF16_MANTISSA_BITS)


def assert_within_bf16_ulps(got, want, ulps: float = 1.0, scale=None):
    """|got - want| <= ulps * bf16 spacing at ``scale`` (default: the
    larger of |got| and |want|), elementwise."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scale is None:
        scale = np.maximum(np.abs(got), np.abs(want))
    bound = ulps * bf16_ulp(scale)
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert np.all(err <= bound), (
        f"{int(np.sum(err > bound))} elements beyond {ulps} bf16 ulp; "
        f"worst at {worst}: {got[worst]} vs {want[worst]}"
    )


class FakeFlashLib:
    """The built flash library's stand-in on the CPU: records each call of
    an entry point named in ``entries`` (its name and arguments) and
    returns ``rc``; any other name raises ``AttributeError``."""

    def __init__(self, entries):
        self.entries, self.rc, self.calls = tuple(entries), 0, []

    def __getattr__(self, name):
        if name not in self.entries:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc

        return entry

    def ddlb_flash_error_string(self, rc):
        return b"refused"


def install_fake_flash_lib(monkeypatch, fa, entries) -> FakeFlashLib:
    """Launch the flash module ``fa``'s passes on CPU tensors: its library
    and the CUDA stream lookup replaced (the stream is 7), every count
    zeroed. The caller zeroes the counts again after the test."""
    lib = FakeFlashLib(entries)
    monkeypatch.setattr(fa, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    fa.reset_launches()
    return lib


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(target, world: int, *args):
    """Start ``target(rank, port, results, *args)`` in ``world`` spawned
    processes (never forked: the parent has JAX and torch threads) on a
    gloo rendezvous at a free localhost port; each rank puts ``(rank,
    "ok", payload)`` or ``(rank, "error", traceback)`` on ``results``.
    Returns the handle ``finish_world`` takes; the parent may work while
    the world runs."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, port, results, *args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, results


def finish_world(handle, deadline_s: float) -> dict:
    """``{rank: payload}`` of a world from ``start_world``; fails when a
    rank fails or the world does not finish within ``deadline_s``, so a
    mismatched collective fails the test rather than hanging it."""
    import queue

    procs, results = handle
    world = len(procs)
    got = {}
    try:
        # drain before joining: a child blocks on exit until its queue
        # items are consumed
        for _ in range(world):
            rank, status, payload = results.get(timeout=deadline_s)
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        raise AssertionError(f"the {world}-rank world did not finish within {deadline_s} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * world
    return got


def run_world(target, world: int, deadline_s: float, *args) -> dict:
    """``start_world`` then ``finish_world``: ``{rank: payload}``."""
    return finish_world(start_world(target, world, *args), deadline_s)


def join_world(rank: int, world: int, port: int) -> None:
    """The torchrun environment of one rank of a localhost world."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
