"""Ring schedule tables shared by the overlap pipelines and the ring kernels.

A copy of the numpy path of the JAX package's ``native.ring_schedule`` and
``native.coll_pipeline_row_map`` (the C library behind them is not
ported: the tables are small and built once per member).
"""

from __future__ import annotations

import numpy as np

RING_KINDS = ("ag_fwd", "ag_bwd", "rs_fwd", "rs_bwd")


def ring_schedule(d: int, kind: str = "ag_fwd") -> np.ndarray:
    """``[d, d]`` int32 table: entry ``[rank, t]`` is the chunk id that
    ``rank`` holds (all-gather) or folds (reduce-scatter) at ring step
    ``t``:

    - ``ag_fwd``: ``rank - t``, the chunk held after ``t`` hops to the next
      rank;
    - ``ag_bwd``: ``rank + t``, the same with hops to the previous rank;
    - ``rs_fwd``: ``rank + d - 1 - t``, so that after ``d`` hops to the next
      rank each rank's accumulator is its own chunk;
    - ``rs_bwd``: ``rank + t + 1``, the same with hops to the previous rank.

    All mod ``d``.
    """
    if kind not in RING_KINDS:
        raise ValueError(f"unknown ring kind '{kind}'; valid: {sorted(RING_KINDS)}")
    if d <= 0:
        raise ValueError(f"d must be positive, got {d}")
    r = np.arange(d, dtype=np.int64)[:, None]
    t = np.arange(d, dtype=np.int64)[None, :]
    table = {
        "ag_fwd": r - t,
        "ag_bwd": r + t,
        "rs_fwd": r + d - 1 - t,
        "rs_bwd": r + t + 1,
    }[kind]
    return np.asarray(np.mod(table, d), np.int32)


def coll_pipeline_row_map(m: int, d: int, s: int) -> np.ndarray:
    """``[m]`` int32 map from the stage-major rows of ``coll_pipeline``'s
    concatenated stage outputs to global row indices: stage ``i`` gathers
    ``[d, m/(d*s)]`` rows rank-major, and global order is rank-major then
    stage-major (the ``[s, d, b] -> [d, s, b]`` reorder as a permutation)."""
    if m <= 0 or d <= 0 or s <= 0 or m % (d * s) != 0:
        raise ValueError(f"m={m} must be a positive multiple of d*s={d * s}")
    b = m // (d * s)
    idx = np.arange(m, dtype=np.int32).reshape(d, s, b)
    return idx.transpose(1, 0, 2).reshape(m).astype(np.int32)
