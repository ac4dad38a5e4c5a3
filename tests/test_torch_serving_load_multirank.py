"""``serving_load`` on a 2-rank gloo world: the ranks agree on the drain's
clock.

Every rank of the serving mesh drives its own engine over the same trace;
their tp collectives pair only if each rank releases the same arrivals
before the same ``admit_ready``. Each rank reading its own host clock did
not guarantee that: two ranks whose clocks stood apart released different
arrivals, and their prefills posted collectives that no longer paired
(gloo: "Received data size doesn't match expected size"). Here rank 1
starts every drain's clock 100 ms early (its drain module's
``time.perf_counter`` returns 100 ms less at the drain's first reading,
as if rank 1 had been held up 100 ms between reading its start and its
first pump), so the clocks disagree for certain; the drive loop must take
rank 0's readings on both ranks. ``scripts/config_serving_load.json``'s
``engine`` entries (every rate) and ``static`` entry run through the sweep
runner on both ranks: each row valid on both, every drain's completions
identical on both. The world has a deadline, so a mismatch that hangs
fails the test.
"""

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

WORLD = 2
#: rank 1's head start on every drain's clock, seconds
SKEW_S = 0.1
#: seconds the world may take; the test fails when it runs out
DEADLINE_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _SkewedClock:
    """``time`` as the drain module sees it on rank 1: ``perf_counter``
    returns ``SKEW_S`` less on the first reading after ``arm()``."""

    def __init__(self):
        self.armed = False

    def arm(self):
        self.armed = True

    def perf_counter(self):
        now = time.perf_counter()
        if self.armed:
            self.armed = False
            return now - SKEW_S
        return now

    def sleep(self, seconds):
        time.sleep(seconds)


def _rank_main(rank, port, tmp, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    from ddlb_tpu_torch.cli.benchmark import load_config, run_benchmark
    from ddlb_tpu_torch.primitives.serving_load import base

    drains = []
    original = base.ServingLoad._drain
    clock = _SkewedClock()

    def recorded_drain(self):
        if rank == 1:
            clock.arm()
        original(self)
        drains.append([(orig, tokens.tolist()) for orig, tokens in self._last["completions"]])

    base.ServingLoad._drain = recorded_drain
    if rank == 1:
        base.time = clock
    try:
        cfg = load_config("scripts/config_serving_load.json")["benchmark"]
        cfg["implementations"] = {name: cfg["implementations"][name]
                                  for name in ("engine", "static")}
        cfg.update(device="cpu", num_warmups=0, num_iterations=1,
                   output_csv=os.path.join(tmp, f"rank{rank}.csv"))
        # an error row (a collective mismatch) has no serving columns
        rows = [(r["implementation"], r["option"], bool(r["valid"]), r["error"],
                 r.get("slo_completed"), r.get("drains")) for r in run_benchmark(cfg)]
        results.put((rank, "ok", (rows, drains)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_rank_drain_reads_one_clock(tmp_path):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(tmp_path), results),
                         daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
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

    rows0, drains0 = got[0]
    rows1, drains1 = got[1]
    # the config's four engine rates, its bursty and paged engine entries,
    # its static entry: two drains each (the timed one, the validated one)
    assert len(rows0) == 7 and [r[:2] for r in rows1] == [r[:2] for r in rows0]
    rates = set()
    for row in rows0 + rows1:
        name, option, valid, error, completed, n_drains = row
        assert valid and not error, (name, option, error)
        assert n_drains == 2 and completed == 24
        rates.add(dict(item.split("=", 1) for item in option.split(";"))["rate"])
    assert rates == {"12.0", "48.0", "192.0", "768.0"}
    assert len(drains0) == len(drains1) == 14
    for i, (a, b) in enumerate(zip(drains0, drains1)):
        assert len(a) == 24 and a == b, f"drain {i}: the ranks' completions differ"
