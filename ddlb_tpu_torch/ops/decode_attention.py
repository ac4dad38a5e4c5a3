"""K11 and K12: single-token attention against a KV cache, written by hand
in CUDA C++ for Hopper.

Replaces, in ``ddlb_tpu/ops/decode_attention.py``, the two Pallas kernels
that share one tile body (``_attn_tile_body``, :52):
- ``decode_attention`` (:148, ``_decode_attn_kernel`` :116, K11): the
  cache in its native contiguous ``[b, S, h_kv, dh]`` layout;
- ``paged_decode_attention`` (:274, ``_paged_decode_attn_kernel`` :236,
  K12): the same read through a page table ``[b, max_pages]`` from page
  pools ``[P, page_size, h_kv, dh]``; a table entry ``>= P`` (the
  sentinel) is unmapped and its page contributes nothing.

Both take ``q [b, h, dh]``, the K/V cache in the model dtype or int8 with
float32 scales ``[..., h_kv, 1]``, and ``pos`` (an int or ``[b]`` int32:
key ``j`` is live iff ``j <= pos[b]``, and ``j > pos[b] - window`` with a
window), and return ``[b, h, dh]`` in q's dtype. Query head ``hq`` reads
kv head ``hq // G``. int8 is dequantized as ``(int8 -> f32) * scale``,
rounded to the model dtype, then widened (``_cache_read``'s contract). A
row with no live key is 0.

One CUDA source (``csrc/decode_attention.cu``, whose note gives the bound
and what the design does about it) and one entry point
(``ddlb_decode_attention``) serve both, in one launch: the cache is split
across blocks (flash-decoding), a producer warp streams each block's rows
through a ring of shared-memory stages with bulk copies, the scores run on
the tensor cores (``mma.sync``) for bf16/fp16 queries and on SIMT float32
dots for float32 ones, and the last block of each (sequence, kv head) to
finish merges the blocks' partials in split order. ``num_splits`` picks the
split count from S, ``b * h_kv`` and the SM count, in whole ``SPLIT_UNIT``
keys (whole pages for K12). Built by ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ``ctypes`` on PyTorch's current stream.
The checks that depend only on shapes, dtypes, strides and devices run
once per signature (``_PLANS``); alignment is checked every call.

``LAUNCHES`` counts wrapper calls that launch the kernel, by entry
(``decode`` = K11, ``paged`` = K12), and ``DECODE_TILES`` by design
(``mma``: the tensor-core kernel, ``simt``: float32 queries). A CPU tensor
takes the plain PyTorch version beside each kernel
(``decode_attention_plain``, ``paged_decode_attention_plain``), which
follows ``_attn_tile_body`` tile by tile in float32; a CUDA tensor
launches the kernel or raises. There is no fallback. The plain versions
also take ``splits=``: each split folded on its own and the partials merged
in split order (``merge_partials_plain``), the kernel's schedule; the main
path does not use it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ddlb_tpu_torch.ops import _build

#: additive mask sentinel, as the tile body's
NEG_INF = -1e30

#: kernel launches by entry since the counts were last zeroed (plain calls
#: excluded): ``decode`` = K11, ``paged`` = K12
LAUNCHES = {"decode": 0, "paged": 0}
#: the same launches by design: ``mma`` (bf16/fp16 queries, scores on the
#: tensor cores), ``simt`` (float32 queries)
DECODE_TILES = {"mma": 0, "simt": 0}

#: the head dim the kernels are compiled for, and the query heads per kv
#: head they are instantiated for
HEAD_DIM = 128
GROUPS = (1, 2, 4, 8, 16)
#: the plain contiguous version's key tiles (the JAX package's default
#: ``block_s``; the last tile may be ragged)
PLAIN_BLOCK = 512
#: blocks the split aims at per SM in one wave, the most pages a split of a
#: paged cache takes (its sequences are ragged), the fewest keys worth a
#: split of their own, and the most splits; tuned on an H100 with ``python
#: scripts/time_kernels.py --tree . --phase decode_splits`` (``num_splits``
#: gives the rule)
BLOCKS_PER_SM = 2
PAGES_PER_SPLIT = 3
MIN_SPLIT_KEYS = 256
MAX_SPLITS = 64
#: a contiguous cache splits in whole runs of this many keys (a paged one
#: in whole pages)
SPLIT_UNIT = 128

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for counts in (LAUNCHES, DECODE_TILES):
        for key in counts:
            counts[key] = 0


# -- checks --------------------------------------------------------------------


def _check(q, k, v, k_scale, v_scale, window):
    """The argument rules of both entries; returns (G, int8)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"decode attention takes q [b, h, dh] and k, v [.., S, h_kv, dh], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    h, dh = q.shape[1], q.shape[2]
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(f"h={h} not divisible by h_kv={h_kv}")
    if k.shape[3] != dh:
        raise ValueError(f"head dims differ: {dh} vs {k.shape[3]}")
    int8 = k.dtype == torch.int8
    if int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 cache needs k_scale and v_scale")
        want = tuple(k.shape[:3]) + (1,)
        for s in (k_scale, v_scale):
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise ValueError(
                    f"int8 scales must be float32 {want}, got "
                    f"{tuple(s.shape)} {s.dtype}"
                )
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"cache dtype {k.dtype} is neither int8 nor q's {q.dtype}"
        )
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return h // h_kv, int8


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (an int or ``[b]``) as ``[b]`` int32 on ``device``."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.int32)
        return pos.expand(b).contiguous() if pos.dim() == 0 else pos.contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


# -- the plain versions ----------------------------------------------------------


def _dequant(x, scale, dtype):
    """A cache tile in f32: int8 through ``(x * scale) -> dtype -> f32``."""
    if scale is None:
        return x.float()
    return (x.float() * scale).to(dtype).float()


def _tile_update(qs, k, v, live, state):
    """One tile folded into (m, l, acc), as ``_attn_tile_body``'s update
    (:70-107): ``qs [b, h_kv, G, dh]`` (scaled), ``k``/``v [b, t, h_kv,
    dh]`` f32, ``live [b, t]``. Masked keys give no mass; a tile with no
    live key leaves the state exactly as it was (alpha = 1, p = 0)."""
    m, l, acc = state
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    s = qs @ kh.transpose(-1, -2)                      # [b, h_kv, G, t]
    mask = live[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    return m_new, l * alpha + p.sum(-1, keepdim=True), acc * alpha + p @ vh


def _init_state(q, h_kv):
    b, h, dh = q.shape
    G = h // h_kv
    qs = q.float().reshape(b, h_kv, G, dh) * (1.0 / float(np.sqrt(dh)))
    return qs, (
        torch.full((b, h_kv, G, 1), NEG_INF, device=q.device),
        torch.zeros((b, h_kv, G, 1), device=q.device),
        torch.zeros((b, h_kv, G, dh), device=q.device),
    )


def _flush(q, state):
    """``acc / l`` with the ``l == 0`` guard, ``[b, h, dh]`` in q's dtype."""
    _, l, acc = state
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(q.shape).to(q.dtype)


def merge_partials_plain(q, states) -> torch.Tensor:
    """The kernel's merge: the splits' partial states ``(m, l, acc)``
    folded in split order, ``M = max m``, ``L = sum l e``, ``A = sum acc
    e`` with ``e = exp(m - M)``, then ``A / L`` (0 where L is 0), ``[b, h,
    dh]`` in q's dtype. A split with no live key (m = -1e30, l = 0) adds
    nothing."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(states[0][1])
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        e = torch.exp(m - M)
        L = L + l * e
        A = A + acc * e
    return _flush(q, (M, L, A))


def split_ranges(pos, S: int, window: int, splits: int, unit: int):
    """``[b, splits]`` first and past-last live key of each split, as the
    kernel cuts them: the live range ``[max(0, pos - window + 1), min(pos,
    S - 1)]`` in whole units of ``unit`` keys spread evenly, split ``s``
    taking units ``[s U / splits, (s + 1) U / splits)`` of the range's
    ``U``; with more splits than units some are empty (begin >= end)."""
    pos = pos.long()
    hi = torch.clamp(pos, max=S - 1)
    lo = torch.clamp(pos - window + 1, min=0) if window else torch.zeros_like(pos)
    live = hi >= lo
    u_lo = lo // unit
    units = (hi // unit - u_lo + 1)[:, None]
    s = torch.arange(splits, device=pos.device)[None, :]
    u0 = u_lo[:, None] + s * units // splits
    u1 = u_lo[:, None] + (s + 1) * units // splits
    begin = torch.maximum(lo[:, None], u0 * unit)
    end = torch.minimum(hi[:, None] + 1, u1 * unit)
    return torch.where(live[:, None], begin, 0), torch.where(live[:, None], end, 0)


def _live(cols, pos, window, keys=None):
    """``[b, t]``: ``cols <= pos``, (window) ``cols > pos - window`` and
    (``keys``, a split's ``[b]`` begin and end) ``begin <= cols < end``."""
    live = cols[None, :] <= pos[:, None]
    if window:
        live &= cols[None, :] > pos[:, None] - window
    if keys is not None:
        live &= (cols[None, :] >= keys[0][:, None]) & (cols[None, :] < keys[1][:, None])
    return live


def _fold_contiguous(q, k_cache, v_cache, k_scale, v_scale, pos, window, keys):
    qs, state = _init_state(q, k_cache.shape[2])
    S = k_cache.shape[1]
    for s0 in range(0, S, PLAIN_BLOCK):
        s1 = min(s0 + PLAIN_BLOCK, S)
        cols = torch.arange(s0, s1, device=q.device)
        sl = slice(s0, s1)
        state = _tile_update(
            qs,
            _dequant(k_cache[:, sl], None if k_scale is None else k_scale[:, sl], q.dtype),
            _dequant(v_cache[:, sl], None if v_scale is None else v_scale[:, sl], q.dtype),
            _live(cols, pos, window, keys), state,
        )
    return state


def decode_attention_plain(q, k_cache, v_cache, pos, *, k_scale=None,
                           v_scale=None, window: int = 0, splits: int = 0,
                           split_unit: int = SPLIT_UNIT) -> torch.Tensor:
    """The plain version of K11: the tile body over key tiles of
    ``PLAIN_BLOCK`` (the last one ragged), in float32, for the whole batch
    at once. With ``splits``, the kernel's schedule: each of ``splits``
    runs of whole ``split_unit`` keys folded on its own, then
    ``merge_partials_plain``."""
    _check(q, k_cache, v_cache, k_scale, v_scale, window)
    b, S = k_cache.shape[0], k_cache.shape[1]
    pos = _positions(pos, b, q.device)
    args = (q, k_cache, v_cache, k_scale, v_scale, pos, window)
    if not splits:
        return _flush(q, _fold_contiguous(*args, None))
    begin, end = split_ranges(pos, S, window, splits, split_unit)
    return merge_partials_plain(
        q, [_fold_contiguous(*args, (begin[:, s], end[:, s])) for s in range(splits)])


def _fold_paged(q, k_pool, v_pool, table, k_scale, v_scale, pos, window, keys):
    P, ps, h_kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    qs, state = _init_state(q, h_kv)
    for sj in range(table.shape[1]):
        pages = table[:, sj].long()
        mapped = (pages >= 0) & (pages < P)
        safe = pages.clamp(0, P - 1)
        cols = sj * ps + torch.arange(ps, device=q.device)
        live = _live(cols, pos, window, keys) & mapped[:, None]
        state = _tile_update(
            qs,
            _dequant(k_pool[safe], None if k_scale is None else k_scale[safe], q.dtype),
            _dequant(v_pool[safe], None if v_scale is None else v_scale[safe], q.dtype),
            live, state,
        )
    return state


def paged_decode_attention_plain(q, k_pool, v_pool, table, pos, *,
                                 k_scale=None, v_scale=None,
                                 window: int = 0, splits: int = 0) -> torch.Tensor:
    """The plain version of K12: the tile body once per table column (one
    page per sequence at a time), an unmapped entry's page dead. With
    ``splits``, the kernel's schedule in whole pages (see
    ``decode_attention_plain``)."""
    _check(q, k_pool, v_pool, k_scale, v_scale, window)
    b, ps = q.shape[0], k_pool.shape[1]
    table = _check_table(table, b, q.device)
    pos = _positions(pos, b, q.device)
    args = (q, k_pool, v_pool, table, k_scale, v_scale, pos, window)
    if not splits:
        return _flush(q, _fold_paged(*args, None))
    begin, end = split_ranges(pos, table.shape[1] * ps, window, splits, ps)
    return merge_partials_plain(
        q, [_fold_paged(*args, (begin[:, s], end[:, s])) for s in range(splits)])


def _check_table(table, b, device) -> torch.Tensor:
    if not isinstance(table, torch.Tensor) or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"table must be [b={b}, max_pages], got {getattr(table, 'shape', table)}")
    return table.to(device=device, dtype=torch.int32).contiguous()


# -- the kernels -----------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load("decode_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the plan's 14 ints, the call's 10 pointers, the scale, the stream
    lib.ddlb_decode_attention.argtypes = [ptr, ptr, ctypes.c_float, ptr]
    lib.ddlb_decode_attention.restype = ctypes.c_int
    lib.ddlb_decode_partial_floats.argtypes = [i32, i32, i32, i32]
    lib.ddlb_decode_partial_floats.restype = ctypes.c_longlong
    lib.ddlb_decode_design.argtypes = [i32]
    lib.ddlb_decode_design.restype = ctypes.c_int
    lib.ddlb_decode_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(S: int, b: int, h_kv: int, sm_count: int, unit: int = SPLIT_UNIT, *,
               int8: bool = False, paged: bool = False) -> int:
    """Blocks each (sequence, kv head) splits its keys over: as many as fit
    ``BLOCKS_PER_SM`` blocks an SM in one wave, but one for a bf16/fp16
    cache whose pairs alone give nearly every SM a block (such a cache
    streams at the card's rate with one block an SM, so a split only adds
    the merge; an int8 cache's dequantization wants the second block's
    warps); for a paged cache at least enough that a split takes at most
    ``PAGES_PER_SPLIT`` pages; no split under ``MIN_SPLIT_KEYS`` of the
    cache's ``S`` positions, at most ``MAX_SPLITS``, and no more than the
    cache has runs of ``unit`` keys."""
    want = BLOCKS_PER_SM * sm_count // max(1, b * h_kv)
    if want <= BLOCKS_PER_SM and not int8:
        want = 1
    if paged:
        want = max(want, -(-S // (PAGES_PER_SPLIT * unit)))
    return max(1, min(want, -(-S // MIN_SPLIT_KEYS), MAX_SPLITS, -(-S // unit)))


#: the pointers a launch passes: q, k, v, ks, vs, pos, table, o, counters,
#: partials
_Pointers = ctypes.c_void_p * 10


class _Plan(NamedTuple):
    """What a launch takes from its signature, checked once."""

    design: str
    counters: int  # ints of arrival counters (0 with one split)
    partials: int  # floats of partials
    index: int
    consts: ctypes.Array  # the C entry's 14 ints
    scale: float
    fn: object  # the C entry
    scratch: dict  # stream -> (counters, partials) pointers


#: launch plans by signature (shapes, dtypes, devices and contiguity of
#: every operand but pos, the window, the entry); ``reset_plans`` empties it
_PLANS: dict = {}
#: the merge's scratch, by (device, stream, kind): ``counters``, int32
#: arrival counters that every launch leaves zero, and ``partials``,
#: float32; each grown when a launch needs more
_SCRATCH: dict = {}


def reset_plans() -> None:
    """Forget the launch plans (after changing the split constants)."""
    _PLANS.clear()


def _sig(t):
    return None if t is None else (t.shape, t.dtype, t.device, t.is_contiguous())


def _make_plan(key, q, k, v, k_scale, v_scale, table, window) -> _Plan:
    """Every check of a signature; raises on what the kernel does not take
    (``pos`` is checked every call, by ``_kernel_positions``)."""
    G, int8 = _check(q, k, v, k_scale, v_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"decode kernels take {[str(d) for d in _DTYPE_CODES]}, got {q.dtype}")
    b, h, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"the decode kernels are built for head_dim {HEAD_DIM}, got {dh}")
    if G not in GROUPS:
        raise ValueError(f"the decode kernels take {GROUPS} query heads per kv head, got {G}")
    if key == "decode" and k.shape[0] != b:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {b}")
    if table is not None:
        _check_table(table, b, q.device)
    for t in (q, k, v, k_scale, v_scale, table):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode kernels take contiguous tensors")
        if t.numel() > _INT_MAX:
            raise ValueError("operand too large for the kernels' 32-bit indices")
    h_kv = k.shape[2]
    if table is None:
        S, ps, P, mp, unit = k.shape[1], 1, 0, 0, SPLIT_UNIT
    else:
        P, ps, mp = k.shape[0], k.shape[1], table.shape[1]
        S, unit = mp * ps, ps
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    splits = num_splits(S, b, h_kv, _sm_count(index), unit, int8=int8,
                        paged=table is not None)
    lib = _lib()
    code = _DTYPE_CODES[q.dtype]
    consts = (ctypes.c_int * 14)(code, int(int8), b, h, h_kv, dh, S, ps, P, mp,
                                 int(table is not None), int(window), splits, unit)
    return _Plan(
        design="mma" if lib.ddlb_decode_design(code) == 1 else "simt",
        counters=b * h_kv if splits > 1 else 0,
        partials=lib.ddlb_decode_partial_floats(b, h_kv, splits, G) if splits > 1 else 0,
        index=index, consts=consts, scale=1.0 / float(np.sqrt(dh)),
        fn=lib.ddlb_decode_attention, scratch={},
    )


def _scratch(plan: _Plan, stream: int, kind: str):
    """The scratch of launches on ``stream`` (zeros, then whatever the
    launches leave), grown when a launch needs more. Counters first made
    while a CUDA graph is captured are zeroed by the graph's first
    replay."""
    need = getattr(plan, kind)
    if not need:
        return None
    key = (plan.index, stream, kind)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.int32 if kind == "counters" else torch.float32,
                          device=torch.device("cuda", plan.index))
        _SCRATCH[key] = buf
        for other in _PLANS.values():  # a plan may hold the old buffer's pointer
            other.scratch.pop(stream, None)
    return buf.data_ptr()


def _current_stream(index: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(key, q, k, v, k_scale, v_scale, pos, table, window):
    sig = (key, window, _sig(q), _sig(k), _sig(v), _sig(k_scale), _sig(v_scale), _sig(table))
    plan = _PLANS.get(sig)
    if plan is None:
        plan = _make_plan(key, q, k, v, k_scale, v_scale, table, window)
        _PLANS[sig] = plan
    ptrs = [None if t is None else t.data_ptr()
            for t in (q, k, v, k_scale, v_scale, pos, table)]
    bits = 0
    for ptr in ptrs:
        bits |= ptr or 0
    if bits % 16:
        raise ValueError("decode kernels take 16-byte aligned tensors")
    o = torch.empty_like(q)
    stream = _current_stream(plan.index)
    scratch = plan.scratch.get(stream)
    if scratch is None:
        scratch = plan.scratch[stream] = (_scratch(plan, stream, "counters"),
                                          _scratch(plan, stream, "partials"))
    ptrs += [o.data_ptr(), *scratch]
    args = (plan.consts, _Pointers(*ptrs), plan.scale, stream)
    if torch.cuda.current_device() == plan.index:
        rc = plan.fn(*args)
    else:
        with torch.cuda.device(plan.index):
            rc = plan.fn(*args)
    LAUNCHES[key] += 1
    DECODE_TILES[plan.design] += 1
    if rc != 0:
        raise RuntimeError(
            f"decode attention ({key}) launch failed: "
            f"{_lib().ddlb_decode_error_string(rc).decode()} (cudaError {rc})"
        )
    return o


def _kernel_positions(pos, b, device) -> torch.Tensor:
    """``pos`` as the kernel reads it, ``[b]`` int32 contiguous on the
    device; such a tensor as it is."""
    if not (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 and pos.dim() == 1
            and pos.device == device and pos.is_contiguous()):
        pos = _positions(pos, b, device)
    if pos.shape != (b,):
        raise ValueError(f"pos must be an int or [b={b}], got {tuple(pos.shape)}")
    return pos


def decode_attention(q, k_cache, v_cache, pos, *, k_scale=None, v_scale=None,
                     window: int = 0) -> torch.Tensor:
    """Fused single-token cache attention (K11): ``q [b, h, dh]`` against
    ``k_cache``/``v_cache [b, S, h_kv, dh]``; returns ``[b, h, dh]``."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, pos, k_scale=k_scale, v_scale=v_scale,
            window=window,
        )
    pos = _kernel_positions(pos, q.shape[0], q.device)
    return _launch("decode", q, k_cache, v_cache, k_scale, v_scale, pos, None, window)


def paged_decode_attention(q, k_pool, v_pool, table, pos, *, k_scale=None,
                           v_scale=None, window: int = 0) -> torch.Tensor:
    """Fused single-token attention over a paged cache (K12): ``q [b, h,
    dh]``, pools ``[P, page_size, h_kv, dh]``, ``table [b, max_pages]``
    int32 page ids (``>= P`` unmapped); returns ``[b, h, dh]``."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, table, pos, k_scale=k_scale, v_scale=v_scale,
            window=window,
        )
    b = q.shape[0]
    if not (isinstance(table, torch.Tensor) and table.dtype == torch.int32
            and table.device == q.device and table.is_contiguous()):
        table = _check_table(table, b, q.device)
    pos = _kernel_positions(pos, b, q.device)
    return _launch("paged", q, k_pool, v_pool, k_scale, v_scale, pos, table, window)


# -- what the kernel must move, and its distance from the plain version ----------


def live_keys(pos, S: int, window: int = 0, table=None, num_pages: int = 0,
              page_size: int = 1) -> int:
    """Keys the inputs make live, summed over the batch: ``j <= pos[b]``,
    ``j < S``, inside the window, and (paged) on a mapped page: what the
    kernels read, whatever the cache holds beyond."""
    pos = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos, np.int64)
    pos = np.broadcast_to(pos, (len(table) if table is not None else pos.size,))
    j = np.arange(S, dtype=np.int64)[None, :]
    live = j <= pos[:, None]
    if window:
        live &= j > pos[:, None] - window
    if table is not None:
        tab = np.asarray(table.cpu() if isinstance(table, torch.Tensor) else table)
        mapped = (tab >= 0) & (tab < num_pages)
        live &= np.repeat(mapped, page_size, axis=1)[:, :S]
    return int(live.sum())


def plain_gap_bound(q, kmax: float, vmax: float, got: torch.Tensor,
                    want: torch.Tensor, *, n_terms: int) -> torch.Tensor:
    """Elementwise bound on ``|o_kernel - o_plain|``, where ``kmax`` and
    ``vmax`` bound the (dequantized) key and value magnitudes.

    Both sides compute in float32 from the same operands, in other orders:
    each score sums ``dh`` products and is scaled (a gap ``Δs <= (dh + 2)
    * 2**-23 * scale * dh * max|q| * kmax``), which moves every p and l by
    a factor within ``exp(±2Δs)``; two float32 sums of at most ``n_terms``
    keys; ``2**-20`` for ``exp``; and each side rounds the output once:
    ``spacing(|o|) * eps + vmax * (4Δs + 2n * 2**-23 + 2**-20)``. The
    bound scales with ``vmax``, not ``|o|``, so hold a kernel also on
    peaked inputs, where ``|o|`` stays near ``vmax``."""
    dh = q.shape[-1]
    scale = 1.0 / float(np.sqrt(dh))
    qmax = float(q.float().abs().max()) if q.numel() else 0.0
    ds = (dh + 2) * 2.0**-23 * scale * dh * qmax * kmax
    finfo = torch.finfo(got.dtype)
    mag = torch.maximum(got.float().abs(), want.float().abs())
    spacing = torch.exp2(torch.floor(torch.log2(mag.clamp_min(finfo.tiny))))
    return spacing * finfo.eps + vmax * (4.0 * ds + 2.0 * n_terms * 2.0**-23 + 2.0**-20)
