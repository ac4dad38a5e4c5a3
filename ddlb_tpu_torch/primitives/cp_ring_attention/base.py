"""CPRingAttention: context-parallel causal self-attention.

The counterpart of the JAX package's ``cp_ring_attention/base.py``. The
sequence is sharded over the ranks: rank r of d holds rows
``[r*m/d, (r+1)*m/d)`` of Q, K and V, and members differ in how the K/V
blocks reach the query block (a ring of point-to-point hops, an
all-gather, an all-to-all of heads, or nothing at all).

Shape mapping onto the ``(m, n, k)`` contract:
- ``m``: sequence length (the sharded dimension);
- ``n``: model width = num_heads * head_dim;
- ``k``: head_dim (so num_heads = n // k).

Q, K and V are ``[m, h, k]`` (K and V with ``n_kv_heads`` heads when that
option is set, GQA), drawn uniform [-1, 1] from one numpy generator in the
order q, k, v: bit for bit the JAX package's operands. Causal attention is
counted as ``2 * m^2 * n`` FLOP (the causal half of ``4 * m^2 * n``), or the
window's live pairs times ``4 * n``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ddlb_tpu_torch.perfmodel.cost import wire_itemsize
from ddlb_tpu_torch.primitives.base import Primitive

#: additive mask sentinel shared by every member (large-negative rather
#: than -inf so masked-row maxima stay finite)
NEG_INF = -1e30


def causal_attention(q, k, v, scale, row_offset=0, window: int = 0):
    """Masked softmax attention in float32, queries at ``row_offset``
    within the global sequence: the plain math of the ``compute_only``,
    ``allgather`` and ``ulysses;compute=einsum`` members. ``k``/``v`` may
    carry fewer (GQA) heads; repetition computes the same products.
    ``window > 0`` also drops keys behind the sliding band.

    It materialises the ``[h, q, kv]`` scores; they are updated in place
    (mask, shift, exp, normalise) so one score tensor is alive at a time.
    """
    if k.shape[1] != q.shape[1]:
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    qh = q.transpose(0, 1).float() * scale
    kh = k.transpose(0, 1).float()
    vh = v.transpose(0, 1).float()
    s = qh @ kh.transpose(1, 2)
    rows = row_offset + torch.arange(s.shape[1], device=s.device)[:, None]
    cols = torch.arange(s.shape[2], device=s.device)[None, :]
    mask = rows >= cols
    if window:
        mask &= cols > rows - window
    s.masked_fill_(~mask, NEG_INF)
    s -= s.amax(-1, keepdim=True)
    s.exp_()
    s /= s.sum(-1, keepdim=True)
    return (s @ vh).transpose(0, 1).to(q.dtype)


#: the one host oracle kept per process, keyed by (seed, m, n, k, dtype,
#: window, n_kv_heads): every validated row of a sweep at one shape asks
#: for the same attention
_EXPECTED_MEMO: Dict[tuple, np.ndarray] = {}


class CPRingAttention(Primitive):
    """ABC for context-parallel causal attention members."""

    primitive_name = "cp_ring_attention"

    #: ``transport`` (ici/dcn) lays the ring out (``Runtime.order_ring``):
    #: the rank at ring position p holds sequence block p;
    #: ``n_kv_heads < num_heads`` is GQA (smaller K/V operands and wire
    #: bytes); ``window > 0`` restricts each query to its ``window`` most
    #: recent positions
    BASE_OPTIONS = {"transport": "ici", "n_kv_heads": 0, "window": 0}
    BASE_ALLOWED = {
        "transport": ["ici", "dcn"],
        "n_kv_heads": (0, None),
        "window": (0, None),
    }

    def _check_shapes(self) -> None:
        d = self.num_partitions
        if self.m % d != 0:
            raise ValueError(f"m={self.m} must be divisible by partitions={d}")
        if self.n % self.k != 0:
            raise ValueError(
                f"n={self.n} (model width) must be divisible by k={self.k} "
                f"(head_dim)"
            )
        if self.dtype in ("int32", "int64"):
            raise ValueError("attention requires a floating dtype")
        nkv = self.options["n_kv_heads"]
        if nkv and self.num_heads % nkv != 0:
            raise ValueError(
                f"num_heads={self.num_heads} not divisible by "
                f"n_kv_heads={nkv}"
            )

    @property
    def num_heads(self) -> int:
        return self.n // self.k

    @property
    def kv_heads(self) -> int:
        return self.options["n_kv_heads"] or self.num_heads

    @property
    def s_loc(self) -> int:
        """Rows of the sequence each rank holds."""
        return self.m // self.num_partitions

    @property
    def scale(self) -> float:
        return 1.0 / (self.k ** 0.5)

    def flops(self) -> float:
        # 4*n FLOP per live (query, key) pair (QK^T + PV). Full causal:
        # m(m+1)/2 pairs (reported as the conventional m^2/2). A window
        # caps each query's live keys at min(window, q+1).
        w = self.options["window"]
        if w and w < self.m:
            pairs = w * self.m - w * (w - 1) / 2.0
            return 4.0 * pairs * self.n
        return 2.0 * self.m * self.m * self.n

    def wire_bytes(self) -> float:
        """A rank's ring bytes (the JAX family's census, :128): each rank
        forwards its K and V shards ``[m/d, h_kv, k]`` one hop a step, all
        ``d - 1`` hops for full causal attention, only the
        ``ceil(window / (m/d))`` hops whose chunks reach the band under a
        window (the ring members skip the others). ``compute_only`` and
        ``ulysses`` override it."""
        d = self.num_partitions
        if d <= 1:
            return 0.0
        chunk = self.m // d
        hops = d - 1
        w = self.options["window"]
        if w and w < self.m:
            hops = min(d - 1, math.ceil(w / chunk))
        shard_kv = 2.0 * chunk * self.kv_heads * self.k
        return shard_kv * wire_itemsize(self.dtype) * hops

    def _host_qkv(self):
        rng = np.random.default_rng(self.seed)
        gen = np.float32
        q = rng.uniform(-1, 1, (self.m, self.num_heads, self.k)).astype(gen)
        kv_shape = (self.m, self.kv_heads, self.k)
        k = rng.uniform(-1, 1, kv_shape).astype(gen)
        v = rng.uniform(-1, 1, kv_shape).astype(gen)
        return q, k, v

    def _input_setup(self) -> None:
        rows = slice(self.rank * self.s_loc, (self.rank + 1) * self.s_loc)
        q, k, v = self._host_qkv()
        self.q = self._place(q[rows])
        self.kv_k = self._place(k[rows])
        self.kv_v = self._place(v[rows])
        self._fn = self._build_step()

    def _build_step(self):
        """The member's step ``(q, k, v) -> this rank's [m/d, h, k]``."""
        raise NotImplementedError

    @property
    def _call_args(self):
        return (self.q, self.kv_k, self.kv_v)

    def _ring_chunks(self, k, v):
        """Walk the ring: yield ``(t, src, k_chunk, v_chunk)`` for t = 0 ..
        d-1, where the chunk came from rank ``src = (r - t) % d``.

        The hop that brings chunk t+1 is posted (``Runtime.ring_shift``)
        before chunk t is yielded, so the caller's fold of chunk t overlaps
        the transfer, and waited for only when the caller asks for the
        next chunk.
        """
        d, my = self.num_partitions, self.rank
        for t in range(d):
            last = t + 1 == d
            if not last:
                (k_next, v_next), handles = self.runtime.ring_shift(k, v)
            yield t, (my - t) % d, k, v
            if not last:
                for handle in handles:
                    handle.wait()
                k, v = k_next, v_next

    def _expected_full(self) -> np.ndarray:
        """Single-device causal softmax attention oracle in float32 on the
        host, memoised (one entry per process).

        Computed per head and per query-row block, over the live key
        columns of that block only, so the peak temporary is
        ``[block, m]`` rather than the full ``[h, m, m]`` scores.
        """
        key = (
            self.seed, self.m, self.n, self.k, self.dtype,
            self.options["window"], self.options["n_kv_heads"],
        )
        if key in _EXPECTED_MEMO:
            return _EXPECTED_MEMO[key]
        _EXPECTED_MEMO.clear()
        q, k, v = (torch.from_numpy(x) for x in self._host_qkv())
        if self.dtype in ("float16", "bfloat16"):
            # round-trip the operands through the precision the device saw
            low = getattr(torch, self.dtype)
            q, k, v = (x.to(low).float() for x in (q, k, v))
        m, h = self.m, self.num_heads
        group = h // self.kv_heads
        w = self.options["window"]
        out = torch.empty((m, h, self.k), dtype=torch.float32)
        block = max(1, min(m, (1 << 24) // max(m, 1)))  # ~64 MB of scores
        for r0 in range(0, m, block):
            r1 = min(r0 + block, m)
            c0 = max(0, r0 - w + 1) if w else 0  # first live key column
            rws = torch.arange(r0, r1)[:, None]
            cols = torch.arange(c0, r1)[None, :]
            mask = rws >= cols
            if w:
                mask &= cols > rws - w
            for head in range(h):
                kh = k[c0:r1, head // group]  # [cols, dh] (shared GQA head)
                vh = v[c0:r1, head // group]
                scores = (q[r0:r1, head] @ kh.T) * self.scale
                scores.masked_fill_(~mask, -torch.inf)
                out[r0:r1, head] = torch.softmax(scores, dim=-1) @ vh
        _EXPECTED_MEMO[key] = out.numpy()
        return _EXPECTED_MEMO[key]

    def validate(self, result) -> bool:
        """This rank's ``[m/d, h, k]`` rows against the oracle's."""
        if result is None:
            return False
        self.runtime.synchronize()
        return self._compare_rows(result, self._expected_full())
