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
(``ddlb_decode_attention``) serve both: the cache is split across blocks
(flash-decoding), each block streams its share of the live keys once
with SIMT float32 dots, and a second small kernel merges the blocks'
partials. ``num_splits`` picks the split count from S, ``b * h_kv`` and
the SM count. Built by ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ``ctypes`` on PyTorch's current stream.

``LAUNCHES`` counts wrapper calls that launch the kernels, by entry
(``decode`` = K11, ``paged`` = K12). A CPU tensor takes the plain PyTorch
version beside each kernel (``decode_attention_plain``,
``paged_decode_attention_plain``), which follows ``_attn_tile_body`` tile
by tile in float32; a CUDA tensor launches the kernel or raises. There is
no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ddlb_tpu_torch.ops import _build

#: additive mask sentinel, as the tile body's
NEG_INF = -1e30

#: kernel launches by entry since the counts were last zeroed (plain calls
#: excluded): ``decode`` = K11, ``paged`` = K12
LAUNCHES = {"decode": 0, "paged": 0}

#: the head dim the kernels are compiled for, and the query heads per kv
#: head they are instantiated for
HEAD_DIM = 128
GROUPS = (1, 2, 4, 8, 16)
#: the plain contiguous version's key tiles (the JAX package's default
#: ``block_s``; the last tile may be ragged)
PLAIN_BLOCK = 512
#: blocks the split aims at per SM, the fewest keys worth a split of its
#: own, and the most splits
BLOCKS_PER_SM = 4
MIN_SPLIT_KEYS = 256
MAX_SPLITS = 64

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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


def _live(cols, pos, window):
    """``[b, t]``: ``cols <= pos`` and (window) ``cols > pos - window``."""
    live = cols[None, :] <= pos[:, None]
    if window:
        live &= cols[None, :] > pos[:, None] - window
    return live


def decode_attention_plain(q, k_cache, v_cache, pos, *, k_scale=None,
                           v_scale=None, window: int = 0) -> torch.Tensor:
    """The plain version of K11: the tile body over key tiles of
    ``PLAIN_BLOCK`` (the last one ragged), in float32, for the whole batch
    at once."""
    _check(q, k_cache, v_cache, k_scale, v_scale, window)
    b, S, h_kv = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    pos = _positions(pos, b, q.device)
    qs, state = _init_state(q, h_kv)
    for s0 in range(0, S, PLAIN_BLOCK):
        s1 = min(s0 + PLAIN_BLOCK, S)
        cols = torch.arange(s0, s1, device=q.device)
        sl = slice(s0, s1)
        state = _tile_update(
            qs,
            _dequant(k_cache[:, sl], None if k_scale is None else k_scale[:, sl], q.dtype),
            _dequant(v_cache[:, sl], None if v_scale is None else v_scale[:, sl], q.dtype),
            _live(cols, pos, window), state,
        )
    return _flush(q, state)


def paged_decode_attention_plain(q, k_pool, v_pool, table, pos, *,
                                 k_scale=None, v_scale=None,
                                 window: int = 0) -> torch.Tensor:
    """The plain version of K12: the tile body once per table column (one
    page per sequence at a time), an unmapped entry's page dead."""
    _check(q, k_pool, v_pool, k_scale, v_scale, window)
    P, ps, h_kv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    b = q.shape[0]
    table = _check_table(table, b, q.device)
    pos = _positions(pos, b, q.device)
    qs, state = _init_state(q, h_kv)
    for sj in range(table.shape[1]):
        pages = table[:, sj].long()
        mapped = (pages >= 0) & (pages < P)
        safe = pages.clamp(0, P - 1)
        cols = sj * ps + torch.arange(ps, device=q.device)
        live = _live(cols, pos, window) & mapped[:, None]
        state = _tile_update(
            qs,
            _dequant(k_pool[safe], None if k_scale is None else k_scale[safe], q.dtype),
            _dequant(v_pool[safe], None if v_scale is None else v_scale[safe], q.dtype),
            live, state,
        )
    return _flush(q, state)


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
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ddlb_decode_attention.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, ptr,  # dtype, int8, q, k, v, ks, vs
        ptr, ptr, ptr, ptr, ptr,            # pos, table, o, part_acc, part_ml
        i32, i32, i32, i32, i32,            # b, h, h_kv, dh, S
        i32, i32, i32, i32,                 # page_size, num_pages, max_pages, paged
        i32, i32, f32, ptr,                 # window, splits, scale, stream
    ]
    lib.ddlb_decode_attention.restype = ctypes.c_int
    lib.ddlb_decode_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(S: int, b: int, h_kv: int, sm_count: int) -> int:
    """Blocks each (sequence, kv head) splits its keys over: enough for
    ``BLOCKS_PER_SM`` blocks an SM, no split under ``MIN_SPLIT_KEYS`` of
    the cache's ``S`` positions, at most ``MAX_SPLITS``."""
    want = -(-BLOCKS_PER_SM * sm_count // max(1, b * h_kv))
    return max(1, min(want, -(-S // MIN_SPLIT_KEYS), MAX_SPLITS))


def _check_kernel(q, G, *tensors) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"decode kernels take {[str(d) for d in _DTYPE_CODES]}, got {q.dtype}")
    if q.shape[2] != HEAD_DIM:
        raise ValueError(
            f"the decode kernels are built for head_dim {HEAD_DIM}, got {q.shape[2]}"
        )
    if G not in GROUPS:
        raise ValueError(f"the decode kernels take {GROUPS} query heads per kv head, got {G}")
    for t in (q, *tensors):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("decode kernels take 16-byte aligned tensors")
        if t.numel() > _INT_MAX:
            raise ValueError("operand too large for the kernels' 32-bit indices")


def _launch(q, k, v, k_scale, v_scale, pos, table, window, *, G, int8,
            S, page_size, num_pages, max_pages, key):
    b, h, dh = q.shape
    h_kv = k.shape[2]
    splits = num_splits(S, b, h_kv, _sm_count(q.device.index or 0))
    o = torch.empty_like(q)
    part_acc = torch.empty((b * h_kv * splits * G * dh,), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * h_kv * splits * G * 2,), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ddlb_decode_attention(
            _DTYPE_CODES[q.dtype], int(int8), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, pos.data_ptr(),
            table.data_ptr() if table is not None else None, o.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), b, h, h_kv, dh, S,
            page_size, num_pages, max_pages, int(table is not None),
            int(window), splits, 1.0 / float(np.sqrt(dh)), stream,
        )
    LAUNCHES[key] += 1
    if rc != 0:
        raise RuntimeError(
            f"decode attention ({key}) launch failed: "
            f"{_lib().ddlb_decode_error_string(rc).decode()} (cudaError {rc})"
        )
    return o


def decode_attention(q, k_cache, v_cache, pos, *, k_scale=None, v_scale=None,
                     window: int = 0) -> torch.Tensor:
    """Fused single-token cache attention (K11): ``q [b, h, dh]`` against
    ``k_cache``/``v_cache [b, S, h_kv, dh]``; returns ``[b, h, dh]``."""
    G, int8 = _check(q, k_cache, v_cache, k_scale, v_scale, window)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, pos, k_scale=k_scale, v_scale=v_scale,
            window=window,
        )
    b, S = k_cache.shape[0], k_cache.shape[1]
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"cache batch {k_cache.shape[0]} != q batch {q.shape[0]}")
    pos = _positions(pos, b, q.device)
    _check_kernel(q, G, k_cache, v_cache, k_scale, v_scale, pos)
    return _launch(
        q, k_cache, v_cache, k_scale, v_scale, pos, None, window, G=G,
        int8=int8, S=S, page_size=1, num_pages=0, max_pages=0, key="decode",
    )


def paged_decode_attention(q, k_pool, v_pool, table, pos, *, k_scale=None,
                           v_scale=None, window: int = 0) -> torch.Tensor:
    """Fused single-token attention over a paged cache (K12): ``q [b, h,
    dh]``, pools ``[P, page_size, h_kv, dh]``, ``table [b, max_pages]``
    int32 page ids (``>= P`` unmapped); returns ``[b, h, dh]``."""
    G, int8 = _check(q, k_pool, v_pool, k_scale, v_scale, window)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, table, pos, k_scale=k_scale, v_scale=v_scale,
            window=window,
        )
    b = q.shape[0]
    P, ps = k_pool.shape[0], k_pool.shape[1]
    table = _check_table(table, b, q.device)
    pos = _positions(pos, b, q.device)
    _check_kernel(q, G, k_pool, v_pool, k_scale, v_scale, pos, table)
    return _launch(
        q, k_pool, v_pool, k_scale, v_scale, pos, table, window, G=G,
        int8=int8, S=table.shape[1] * ps, page_size=ps, num_pages=P,
        max_pages=table.shape[1], key="paged",
    )


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
