"""K8a, K8b, K9 and K10a-K10d: the flash attention forward, the
carried-chunk fold and the flash backward, written by hand in CUDA C++ for
Hopper.

Replaces, in ``ddlb_tpu/ops/flash_attention.py``:
- the forward ``_flash_forward`` (:433) with its two Pallas kernels, the
  triangular ``_flash_kernel_tri`` (:373, K8a) and the rectangular
  ``_flash_kernel`` (:96, K8b): here ``flash_forward``, the triangle in
  bf16/fp16 on ``ddlb_flash_forward_tri``, the rectangle on
  ``ddlb_flash_forward_band`` and float32 on ``ddlb_flash_forward``;
- ``flash_attention_chunk`` (:211, ``_flash_chunk_kernel`` :146, K9): here
  ``flash_attention_chunk``, bf16/fp16 on ``ddlb_flash_chunk_band`` and
  float32 on ``ddlb_flash_chunk``;
- the backward ``flash_attention_bwd`` (:781) with its four Pallas kernels,
  the triangular dQ and dK/dV kernels (:706 K10a, :741 K10b) and the
  rectangular ones (:624 K10c, :664 K10d): here ``flash_backward``, the
  triangle in bf16/fp16 on two Hopper entry points
  (``ddlb_flash_bwd_dq_tri``, ``ddlb_flash_bwd_dkv_tri``), the rectangle
  on two more (``ddlb_flash_bwd_dq_band``, ``ddlb_flash_bwd_dkv_band``) and
  float32 on ``ddlb_flash_bwd_dq`` / ``ddlb_flash_bwd_dkv``, each case
  counted apart; ``delta = rowsum(do * o)`` is taken outside, as :826
  does, and GQA's dK/dV are summed over the group inside the dK/dV pass;
- the differentiable ``flash_attention`` (:1106, the custom_vjp of
  :1008-1076) and ``ring_flash_attention`` (:1170, :1229-1354), here
  ``torch.autograd.Function``s over the kernels: the ring's forward folds
  K9 chunks, its backward runs K10 per live chunk while the float32
  dK/dV accumulators ride the ring with their chunks.

The public functions keep the JAX layout: ``q [sq, h, dh]``, ``k``/``v``
``[skv, h_kv, dh]`` with ``h_kv | h`` (query head ``hh`` reads kv head
``hh // (h / h_kv)``, GQA), ``lse [h, sq, 1]`` float32, and the carry
``(acc [h, sq, dh], m [h, sq, 1], l [h, sq, 1])`` float32, head-major. The
kernels read the ``[s, h, dh]`` operands through their strides, without a
transposed copy. Unlike Pallas (``sq % block_q == 0``), ``sq`` and ``skv``
may be ragged: the kernels mask their edges.

The kernels (``csrc/flash_attention.cu``, whose design notes give the
bound and what the design does about it): one block per (query tile,
head) walks only the key tiles that its live band reaches, so the causal
triangle costs half the square, as the TPU's triangular grid (K8a) does.
In bf16/fp16 two Hopper forwards and two pairs of Hopper backward passes
run them, each a TMA producer warpgroup and two consumer warpgroups on
``wgmma`` over 128-row query tiles, the softmax in base 2: K8a runs
``tri::flash_fwd_wgmma`` (entry point ``ddlb_flash_forward_tri``); K8b and
K9 run ``band::flash_fwd_wgmma`` (``ddlb_flash_forward_band``,
``ddlb_flash_chunk_band``), the same kernel over a runtime band of key
tiles (offsets, a window, causal or not, ragged lengths), with the carry
read and written in place for K9; K10a and K10b run
``tri_bwd::flash_bwd_dq_wgmma`` and ``flash_bwd_dkv_wgmma`` (128-row query
tiles against streamed 128-key tiles for dQ; 128-key tiles against
streamed 64-row query tiles for dK/dV, walked twice, dV then dK); K10c and
K10d run ``band_bwd::flash_bwd_dq_wgmma`` and ``flash_bwd_dkv_wgmma``, the
same passes over a runtime band (offsets, a window, the masked or the
unmasked modes, ragged lengths), masked only on edge tiles; float32 runs
SIMT kernels in true float32 (the forward and the chunk fold through
``ddlb_flash_forward`` and ``ddlb_flash_chunk``, the backward through
``ddlb_flash_bwd_dq`` and ``ddlb_flash_bwd_dkv``). Built by ``nvcc`` for
``sm_90a`` at first use (``_build.py``) and called through ``ctypes`` on
PyTorch's current stream.

Dispatch, as ``flash_attention`` (:1147-1167) states it: a window that
covers every key at offset 0 collapses to ``window = 0``; a literal 0
offset with ``sq == skv``, causal and no window is the triangle (K8a),
everything else the rectangle (K8b). The backward follows :839-849
(``backward_case``): a square ``diagonal`` chunk is offset 0, and a
literal offset 0 with square shapes, a mask and no window is the triangle
(K10a/K10b), everything else the rectangle (K10c/K10d). ``LAUNCHES``
counts kernel launches by case (``tri``, ``rect``, ``chunk``,
``bwd_dq_tri``, ``bwd_dkv_tri``, ``bwd_dq_rect``, ``bwd_dkv_rect``), and
``FORWARD_TILES`` the forward and chunk launches by kernel (``wgmma``:
``tri::flash_fwd_wgmma``; ``band``: ``band::flash_fwd_wgmma``; ``simt``:
``flash_f32``), and ``BACKWARD_TILES`` the backward's pass launches by
kernel (``wgmma``: ``tri_bwd``; ``band``: ``band_bwd``; ``simt``:
``flash_bwd_*_f32``). A CPU
tensor takes the plain PyTorch version beside each kernel
(``flash_forward_plain``, ``flash_chunk_plain``, ``flash_backward_plain``),
which follows the Pallas kernels' tile updates (``_online_softmax_update``,
``_dq_tile_update``, ``_dkv_tile_update``) tile by tile in float32 with
the same masks; a CUDA tensor launches the kernel or raises. There is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ddlb_tpu_torch.ops import _build

#: additive mask sentinel: large-negative, not -inf, so that
#: ``exp(m_prev - m_new)`` stays finite on rows with nothing live yet
NEG_INF = -1e30

#: kernel launches by case since the counts were last zeroed (plain calls
#: excluded): ``tri`` = K8a, ``rect`` = K8b, ``chunk`` = K9, and the
#: backward's two passes in each case: ``bwd_dq_tri`` = K10a,
#: ``bwd_dkv_tri`` = K10b, ``bwd_dq_rect`` = K10c, ``bwd_dkv_rect`` = K10d
LAUNCHES = {"tri": 0, "rect": 0, "chunk": 0, "bwd_dq_tri": 0, "bwd_dkv_tri": 0,
            "bwd_dq_rect": 0, "bwd_dkv_rect": 0}
#: the forward's and the chunk fold's launches by kernel since the counts
#: were last zeroed: ``wgmma`` = the Hopper K8a kernel (the triangle in
#: bf16/fp16), ``band`` = the Hopper K8b/K9 kernel (the rectangle and the
#: chunk fold in bf16/fp16), ``simt`` = ``flash_f32`` (float32)
FORWARD_TILES = {"wgmma": 0, "band": 0, "simt": 0}
#: the backward's pass launches by kernel since the counts were last
#: zeroed: ``wgmma`` = the Hopper K10a/K10b kernels (``tri_bwd``, the
#: triangle in bf16/fp16), ``band`` = the Hopper K10c/K10d kernels
#: (``band_bwd``, the rectangle in bf16/fp16), ``simt`` =
#: ``flash_bwd_*_f32`` (float32)
BACKWARD_TILES = {"wgmma": 0, "band": 0, "simt": 0}

#: how a chunk's keys relate to the queries (``flash_attention_chunk``)
CHUNK_MODES = ("offset", "diagonal", "past")
#: the backward's modes (``flash_attention_bwd``, :832): ``none`` is
#: bidirectional attention, no mask and no gate
BACKWARD_MODES = CHUNK_MODES + ("none",)

#: the plain versions' tiles (the JAX package's default blocks)
PLAIN_BLOCK = 1024

#: operand dtype -> the C entry points' dtype code
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the head dim the kernels are compiled for (the only one a shipped
#: configuration uses)
HEAD_DIM = 128
_INT_MAX = 2**31 - 1

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for counts in (LAUNCHES, FORWARD_TILES, BACKWARD_TILES):
        for key in counts:
            counts[key] = 0


# -- the live band -------------------------------------------------------------


def band_live(q_start, k_start, block_q, block_kv, causal, window) -> bool:
    """Does tile (q_start, k_start) meet the live band? Causal upper edge:
    not entirely in the future. Window lower edge: not entirely behind
    the band (``_band_live``, :83)."""
    live = True
    if causal:
        live = q_start + block_q - 1 >= k_start
    if window:
        live = live and k_start + block_kv - 1 > q_start - window
    return live


def ring_chunk_live(src: int, my: int, s_loc: int, window: int) -> bool:
    """Is ring chunk ``src`` live for rank ``my``'s queries? Not entirely
    in the future, and (windowed) not entirely behind the band of the
    first query (``_ring_chunk_live``, :1216)."""
    live = src <= my
    if window:
        live = live and (src + 1) * s_loc - 1 > my * s_loc - window
    return live


def live_pairs(
    sq: int, skv: int, row_offset: int = 0, col_offset: int = 0,
    causal: bool = True, window: int = 0,
) -> int:
    """Number of (query, key) pairs the mask leaves live: query ``i`` sits
    at ``row_offset + i``, key ``j`` at ``col_offset + j``."""
    q = row_offset + np.arange(sq, dtype=np.int64) - col_offset
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _mask(q_start, k_start, bq, bkv, causal, window, device):
    rows = q_start + torch.arange(bq, device=device)[:, None]
    cols = k_start + torch.arange(bkv, device=device)[None, :]
    mask = rows >= cols if causal else torch.ones(
        (bq, bkv), dtype=torch.bool, device=device
    )
    if window:
        mask &= cols > rows - window
    return mask


# -- the plain versions ----------------------------------------------------------


def gqa_group(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads per kv head (1 = MHA) of ``q [sq, h, dh]``,
    ``k [skv, h_kv, dh]``."""
    h, h_kv = q.shape[1], k.shape[1]
    if h % h_kv:
        raise ValueError(
            f"n_heads={h} not divisible by n_kv_heads={h_kv} (GQA groups)"
        )
    return h // h_kv


def _heads_f32(x: torch.Tensor, group: int) -> torch.Tensor:
    """``[s, h_kv, dh]`` -> ``[h, s, dh]`` float32, kv head ``hh // group``
    repeated for query head ``hh``."""
    x = x.transpose(0, 1).float()
    return x.repeat_interleave(group, dim=0) if group > 1 else x


def _online_softmax_update(qs, k, v, m_prev, l_prev, acc_prev, mask):
    """One score tile folded into the (m, l, acc) recurrence, in float32
    (``_online_softmax_update``, :41). ``qs`` is the query tile already
    multiplied by ``scale``; ``mask`` None means every entry is live. Masked
    entries of ``p`` are zeroed, so a row with nothing live keeps
    ``l == 0``."""
    s = qs @ k.transpose(-1, -2)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l_new = l_prev * alpha + p.sum(-1, keepdim=True)
    acc_new = acc_prev * alpha + p @ v
    return m_new, l_new, acc_new


def _fold_tiles(qh, kh, vh, acc, m, l, *, q_base, k_base, masked, causal,
                window, block_q, block_kv):
    """Fold every live key tile into the carry, one query tile at a time;
    returns the new (acc, m, l). Query row ``i`` sits at ``q_base + i``,
    key ``j`` at ``k_base + j``."""
    sq, skv = qh.shape[1], kh.shape[1]
    acc, m, l = acc.clone(), m.clone(), l.clone()
    for i0 in range(0, sq, block_q):
        i1 = min(i0 + block_q, sq)
        rows = slice(i0, i1)
        for j0 in range(0, skv, block_kv):
            j1 = min(j0 + block_kv, skv)
            q_start, k_start = q_base + i0, k_base + j0
            mask = None
            if masked:
                if not band_live(q_start, k_start, i1 - i0, j1 - j0, causal,
                                 window):
                    continue
                mask = _mask(q_start, k_start, i1 - i0, j1 - j0, causal,
                             window, qh.device)
            m[:, rows], l[:, rows], acc[:, rows] = _online_softmax_update(
                qh[:, rows], kh[:, j0:j1], vh[:, j0:j1],
                m[:, rows], l[:, rows], acc[:, rows], mask,
            )
    return acc, m, l


def init_flash_carry(sq: int, h: int, dh: int, device="cpu") -> Carry:
    """A fresh (acc, m, l) carry for ``flash_attention_chunk``."""
    return (
        torch.zeros((h, sq, dh), dtype=torch.float32, device=device),
        torch.full((h, sq, 1), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((h, sq, 1), dtype=torch.float32, device=device),
    )


def finalize_flash_carry(carry: Carry, dtype: torch.dtype) -> torch.Tensor:
    """Normalise a carry into the ``[sq, h, dh]`` output; rows with
    nothing live (``l == 0``) give zeros, not NaN."""
    acc, _, l = carry
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.transpose(0, 1).to(dtype).contiguous()


def flash_forward_plain(
    q, k, v, *, scale: float, row_offset: int = 0, causal: bool = True,
    window: int = 0, block_q: int = PLAIN_BLOCK, block_kv: int = PLAIN_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward: ``(o [sq, h, dh]`` in the operand
    dtype, ``lse [h, sq, 1]`` float32), tile by tile in float32."""
    _check_operands(q, k, v)
    _check_window(causal, window)
    sq, h, dh = q.shape
    acc, m, l = _fold_tiles(
        q.transpose(0, 1).float() * scale,
        _heads_f32(k, gqa_group(q, k)), _heads_f32(v, gqa_group(q, k)),
        *init_flash_carry(sq, h, dh, q.device),
        q_base=int(row_offset), k_base=0, masked=bool(causal or window),
        causal=causal, window=window, block_q=block_q, block_kv=block_kv,
    )
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l))
    return finalize_flash_carry((acc, m, l), q.dtype), lse


def flash_chunk_plain(
    q, k, v, carry: Carry, *, scale: float, row_offset: int,
    col_offset: int, causal: str = "offset", window: int = 0,
    block_q: int = PLAIN_BLOCK, block_kv: int = PLAIN_BLOCK,
) -> Carry:
    """The plain version of the chunk fold: a new carry (the one given is
    left as it is)."""
    _check_operands(q, k, v)
    _check_chunk_mode(causal, window)
    _check_carry(q, carry)
    if causal == "offset":
        q_base, k_base = int(row_offset), int(col_offset)
    else:  # relative coordinates: equal offsets cancel, or no mask at all
        q_base = k_base = 0
    return _fold_tiles(
        q.transpose(0, 1).float() * scale,
        _heads_f32(k, gqa_group(q, k)), _heads_f32(v, gqa_group(q, k)),
        *carry, q_base=q_base, k_base=k_base, masked=causal != "past",
        causal=True, window=window, block_q=block_q, block_kv=block_kv,
    )


# -- checks ------------------------------------------------------------------------


def _check_operands(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"flash attention takes q [sq, h, dh] and k, v [skv, h_kv, dh], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"head dims differ: {q.shape[2]} vs {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"operand dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    gqa_group(q, k)


def _check_window(causal: bool, window: int) -> None:
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")


def _check_chunk_mode(causal: str, window: int) -> None:
    if causal not in CHUNK_MODES:
        raise ValueError(f"unknown causal mode {causal!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and causal == "past":
        raise ValueError(
            "window composes with causal='offset'/'diagonal' (a 'past' "
            "chunk may be partially behind the band and needs the mask)"
        )


def _check_carry(q, carry: Carry) -> None:
    sq, h, dh = q.shape
    shapes = ((h, sq, dh), (h, sq, 1), (h, sq, 1))
    for t, shape in zip(carry, shapes):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"carry must be float32 {shapes}, got "
                f"{[(tuple(c.shape), c.dtype) for c in carry]}"
            )
        if t.device != q.device:
            raise ValueError(f"carry on {t.device}, operands on {q.device}")


def check_kernel_dtype(dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless the kernels compute in ``dtype``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash kernels take {[str(d) for d in _DTYPE_CODES]}, got {dtype}"
        )


def _check_kernel_operands(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    check_kernel_dtype(q.dtype)
    if q.shape[2] != HEAD_DIM:
        raise ValueError(
            f"the flash kernels are built for head_dim {HEAD_DIM}, "
            f"got {q.shape[2]}"
        )
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels take 16-byte aligned tensors")
    if max(q.numel(), tensors[1].numel()) > _INT_MAX:
        raise ValueError("operand too large for the kernels' 32-bit indices")


# -- the kernels -----------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ddlb_flash_forward.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr,  # dtype, q, k, v, o, lse
        i32, i32, i32, i32, i32,       # sq, skv, h, h_kv, dh
        f32, i32, i32, i32, ptr,       # scale, row_offset, causal, window, stream
    ]
    lib.ddlb_flash_forward_tri.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr,  # dtype, q, k, v, o, lse
        i32, i32, i32, i32, f32, ptr,  # sq, h, h_kv, dh, scale, stream
    ]
    lib.ddlb_flash_chunk.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr,  # dtype, q, k, v, acc, m, l
        i32, i32, i32, i32, i32,            # sq, skv, h, h_kv, dh
        f32, i32, i32, i32, i32, ptr,       # scale, row/col offset, mode, window, stream
    ]
    # the Hopper band kernel's entry points take the same arguments
    lib.ddlb_flash_forward_band.argtypes = lib.ddlb_flash_forward.argtypes
    lib.ddlb_flash_chunk_band.argtypes = lib.ddlb_flash_chunk.argtypes
    lib.ddlb_flash_bwd_dq.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # dtype, q, k, v, dout, lse, delta, dq
        i32, i32, i32, i32, i32,                 # sq, skv, h, h_kv, dh
        f32, i32, i32, i32, i32, ptr,            # scale, row/col offset, masked, window, stream
    ]
    lib.ddlb_flash_bwd_dkv.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # ..., delta, dk, dv
        i32, i32, i32, i32, i32,
        f32, i32, i32, i32, i32, ptr,
    ]
    lib.ddlb_flash_bwd_dq_tri.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # dtype, q, k, v, dout, lse, delta, dq
        i32, i32, i32, i32, f32, ptr,            # sq, h, h_kv, dh, scale, stream
    ]
    lib.ddlb_flash_bwd_dkv_tri.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # ..., delta, dk, dv
        i32, i32, i32, i32, f32, ptr,
    ]
    # the Hopper band backward's entry points take the float32 ones' arguments
    lib.ddlb_flash_bwd_dq_band.argtypes = lib.ddlb_flash_bwd_dq.argtypes
    lib.ddlb_flash_bwd_dkv_band.argtypes = lib.ddlb_flash_bwd_dkv.argtypes
    for fn in (lib.ddlb_flash_forward, lib.ddlb_flash_forward_tri, lib.ddlb_flash_chunk,
               lib.ddlb_flash_forward_band, lib.ddlb_flash_chunk_band,
               lib.ddlb_flash_bwd_dq, lib.ddlb_flash_bwd_dkv, lib.ddlb_flash_bwd_dq_tri,
               lib.ddlb_flash_bwd_dkv_tri, lib.ddlb_flash_bwd_dq_band,
               lib.ddlb_flash_bwd_dkv_band):
        fn.restype = ctypes.c_int
    lib.ddlb_flash_error_string.argtypes = [ctypes.c_int]
    lib.ddlb_flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{_lib().ddlb_flash_error_string(rc).decode()} (cudaError {rc})"
        )


def forward_case(sq: int, skv: int, row_offset: int, causal: bool,
                 window: int) -> Tuple[str, int]:
    """(``tri`` or ``rect``, effective window) under the dispatch rule of
    ``flash_attention`` (:1147-1167)."""
    if window and row_offset == 0 and window >= max(sq, skv):
        window = 0  # the band covers the whole causal triangle
    tri = causal and not window and row_offset == 0 and sq == skv
    return ("tri" if tri else "rect"), window


def forward_kernel(case: str, dtype: torch.dtype) -> str:
    """The kernel a forward or chunk launch of ``case`` (``tri``, ``rect``
    or ``chunk``) runs in ``dtype``: ``simt`` for float32; in bf16/fp16
    ``wgmma`` for the triangle and ``band`` for the rectangle and the
    chunk fold."""
    check_kernel_dtype(dtype)
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if case == "tri" else "band"


def flash_forward(
    q, k, v, *, scale: float, row_offset: int = 0, causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward (kernels K8a/K8b): ``(o [sq, h, dh]`` in the
    operand dtype, ``lse [h, sq, 1]`` float32). Query row ``i`` sits at
    global position ``row_offset + i``, key ``j`` at ``j``."""
    _check_operands(q, k, v)
    _check_window(causal, window)
    row_offset = int(row_offset)
    sq, h, _ = q.shape
    _, window = forward_case(sq, k.shape[0], row_offset, causal, window)
    if q.device.type == "cpu":
        return flash_forward_plain(
            q, k, v, scale=scale, row_offset=row_offset, causal=causal,
            window=window,
        )
    _check_kernel_operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((h, sq, 1), dtype=torch.float32, device=q.device)
    if sq:
        forward_pass(q, k, v, o, lse, scale=scale, row_offset=row_offset,
                     causal=causal, window=window)
    return o, lse


def forward_pass(q, k, v, o, lse, *, scale: float, row_offset: int, causal: bool,
                 window: int) -> None:
    """Launch one forward into ``o`` and ``lse`` on the kernel
    ``forward_kernel`` names; counted in ``LAUNCHES`` by case and in
    ``FORWARD_TILES`` by kernel. ``flash_forward`` runs it after checking
    the operands."""
    sq, h, dh = q.shape
    skv, h_kv = k.shape[0], k.shape[1]
    case, window = forward_case(sq, skv, row_offset, causal, window)
    kernel = forward_kernel(case, q.dtype)
    lib = _lib()
    head = (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "wgmma":
            rc = lib.ddlb_flash_forward_tri(*head, sq, h, h_kv, dh, float(scale), stream)
        else:
            entry = lib.ddlb_flash_forward_band if kernel == "band" else lib.ddlb_flash_forward
            rc = entry(*head, sq, skv, h, h_kv, dh, float(scale), int(row_offset),
                       int(bool(causal)), int(window), stream)
    LAUNCHES[case] += 1
    FORWARD_TILES[kernel] += 1
    _raise_on(rc, f"flash forward ({case}, {kernel})")


class _FlashAttention(torch.autograd.Function):
    """``flash_forward`` with the flash backward as its gradient (the
    custom_vjp of ``_flash``/``_flash_s0``, :1008-1076): saves q, k, v, o
    and lse, and returns dq, dk, dv cast to the operand dtypes (:1037)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, row_offset, causal, window):
        o, lse = flash_forward(q, k, v, scale=scale, row_offset=row_offset,
                               causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, row_offset, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, row_offset, causal, window = ctx.args
        dq, dk, dv = flash_backward(
            q, k, v, o, lse, do.contiguous(), scale=scale,
            row_offset=row_offset, col_offset=0,
            causal="offset" if causal else "none", window=window,
        )
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q, k, v, *, scale: float, row_offset: int = 0,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention (``flash_attention``, :1106), differentiable: the
    forward is K8a/K8b, the gradient the flash backward (K10a-K10d). A
    window that covers every key at offset 0 is dropped first, so both
    directions take the triangle (:1147-1159)."""
    _check_operands(q, k, v)
    _check_window(causal, window)
    row_offset = int(row_offset)
    _, window = forward_case(q.shape[0], k.shape[0], row_offset, causal, window)
    return _FlashAttention.apply(q, k, v, float(scale), row_offset,
                                 bool(causal), int(window))


def flash_attention_chunk(
    q, k, v, carry: Carry, *, scale: float, row_offset: int,
    col_offset: int, causal: str = "offset", window: int = 0,
) -> Carry:
    """Fold one KV chunk, whose global key rows start at ``col_offset``,
    into the carry (kernel K9); returns the carry.

    On the card the carry is updated in place and the same tensors come
    back; on the CPU the plain version returns new tensors. Use the
    returned carry either way. ``causal``: ``offset`` masks from the global
    offsets, ``diagonal`` from relative positions (equal offsets),
    ``past`` not at all (every key is in the past); ``window`` with
    ``past`` raises.
    """
    _check_operands(q, k, v)
    _check_chunk_mode(causal, window)
    _check_carry(q, carry)
    if q.device.type == "cpu":
        return flash_chunk_plain(
            q, k, v, carry, scale=scale, row_offset=row_offset,
            col_offset=col_offset, causal=causal, window=window,
        )
    _check_kernel_operands(q, k, v, *carry)
    if q.shape[0]:
        chunk_pass(q, k, v, carry, scale=scale, row_offset=row_offset,
                   col_offset=col_offset, causal=causal, window=window)
    return carry


def chunk_pass(q, k, v, carry: Carry, *, scale: float, row_offset: int,
               col_offset: int, causal: str, window: int) -> None:
    """Launch one chunk fold into ``carry``, in place, on the kernel
    ``forward_kernel`` names; counted in ``LAUNCHES["chunk"]`` and in
    ``FORWARD_TILES`` by kernel. ``flash_attention_chunk`` runs it after
    checking the operands and the carry."""
    sq, h, dh = q.shape
    skv, h_kv = k.shape[0], k.shape[1]
    acc, m, l = carry
    kernel = forward_kernel("chunk", q.dtype)
    lib = _lib()
    entry = lib.ddlb_flash_chunk_band if kernel == "band" else lib.ddlb_flash_chunk
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), sq, skv, h, h_kv, dh,
            float(scale), int(row_offset), int(col_offset),
            CHUNK_MODES.index(causal), int(window), stream,
        )
    LAUNCHES["chunk"] += 1
    FORWARD_TILES[kernel] += 1
    _raise_on(rc, f"flash chunk ({causal}, {kernel})")


# -- the backward (K10a-K10d) ------------------------------------------------------


def _check_backward_mode(causal: str, window: int) -> None:
    if causal not in BACKWARD_MODES:
        raise ValueError(f"unknown causal mode {causal!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and causal != "offset":
        raise ValueError(
            "window composes with causal='offset' only (the ring-chunk modes "
            "have no windowed callers)"
        )


def backward_case(sq: int, skv: int, row_offset: int, col_offset: int,
                  causal: str, window: int) -> Tuple[str, int, int]:
    """(``tri`` or ``rect``, row offset, col offset) under the dispatch rule
    of ``flash_attention_bwd`` (:839-849): a square ``diagonal`` chunk is
    offset 0; a literal offset 0 with square shapes, a mask and no window is
    the triangle; everything else the rectangle."""
    if causal == "diagonal" and sq == skv:
        row_offset = col_offset = 0
    tri = (causal != "none" and not window and row_offset == 0
           and col_offset == 0 and sq == skv)
    return ("tri" if tri else "rect"), int(row_offset), int(col_offset)


def backward_kernel(case: str, dtype: torch.dtype) -> str:
    """The kernel a backward pass of ``case`` (``tri`` or ``rect``) runs in
    ``dtype``: ``simt`` for float32; in bf16/fp16 ``wgmma`` for the
    triangle and ``band`` for the rectangle."""
    check_kernel_dtype(dtype)
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if case == "tri" else "band"


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` in float32, ``[h, sq, 1]`` (:826-830)."""
    return (do.float() * o.float()).sum(-1, keepdim=True).transpose(0, 1).contiguous()


def _backward_tiles(q, k, v, o, lse, do, *, scale, row_offset, col_offset,
                    causal, window, block_q, block_kv, magnitudes=False):
    """The plain backward's tile loop. With ``magnitudes`` it sums absolute
    values instead (``sum |dS| |K|``, ``sum |dS^T| |Q|``, ``sum P^T |dO|``,
    and the column sums of P), the quantities ``backward_gap_bound`` scales
    its rounding terms by."""
    _check_operands(q, k, v)
    _check_backward_mode(causal, window)
    sq, h, dh = q.shape
    skv, h_kv = k.shape[0], k.shape[1]
    _, row_offset, col_offset = backward_case(sq, skv, row_offset, col_offset,
                                              causal, window)
    masked, gated = causal not in ("past", "none"), causal != "none"
    group = gqa_group(q, k)
    qh = q.transpose(0, 1).float()
    kh, vh = _heads_f32(k, group), _heads_f32(v, group)
    doh = do.transpose(0, 1).float()
    delta = attention_delta(o, do)
    lse = lse.float()
    dq = torch.zeros_like(qh)
    dk = torch.zeros((h, skv, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    colsum = torch.zeros((h, skv, 1), dtype=torch.float32, device=q.device)
    for i0 in range(0, sq, block_q):
        i1 = min(i0 + block_q, sq)
        rows = slice(i0, i1)
        for j0 in range(0, skv, block_kv):
            j1 = min(j0 + block_kv, skv)
            cols = slice(j0, j1)
            q_start, k_start = row_offset + i0, col_offset + j0
            if (gated or window) and not band_live(
                    q_start, k_start, i1 - i0, j1 - j0, gated, window):
                continue
            s = (qh[:, rows] * scale) @ kh[:, cols].transpose(-1, -2)
            p = torch.exp(s - lse[:, rows])
            if masked:
                mask = _mask(q_start, k_start, i1 - i0, j1 - j0, True, window,
                             q.device)
                p = p.masked_fill(~mask, 0.0)
            dp = doh[:, rows] @ vh[:, cols].transpose(-1, -2)
            ds = p * (dp - delta[:, rows])
            if magnitudes:
                ds = ds.abs()
                dq[:, rows] += ds @ kh[:, cols].abs()
                dv[:, cols] += p.transpose(-1, -2) @ doh[:, rows].abs()
                dk[:, cols] += ds.transpose(-1, -2) @ qh[:, rows].abs()
                colsum[:, cols] += p.sum(1)[..., None]
                continue
            dq[:, rows] += scale * (ds @ kh[:, cols])
            dv[:, cols] += p.transpose(-1, -2) @ doh[:, rows]
            dk[:, cols] += scale * (ds.transpose(-1, -2) @ qh[:, rows])

    def group_sum(x):
        return x.reshape(h_kv, group, skv, x.shape[-1]).sum(1).transpose(0, 1).contiguous()

    out = (dq.transpose(0, 1).contiguous(), group_sum(dk), group_sum(dv))
    return out + (group_sum(colsum),) if magnitudes else out


def flash_backward_plain(
    q, k, v, o, lse, do, *, scale: float, row_offset: int = 0,
    col_offset: int = 0, causal: str = "offset", window: int = 0,
    block_q: int = PLAIN_BLOCK, block_kv: int = PLAIN_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward: float32 ``(dq [sq, h, dh], dk,
    dv [skv, h_kv, dh])``, tile by tile as ``_dq_tile_update`` (:568) and
    ``_dkv_tile_update`` (:593) do, with the live-band gate of each tile
    and ``p = exp(scale q k^T - lse)`` masked; under GQA the per-query-head
    dK/dV are summed over each group (``_group_sum``, :819)."""
    return _backward_tiles(
        q, k, v, o, lse, do, scale=scale, row_offset=row_offset,
        col_offset=col_offset, causal=causal, window=window, block_q=block_q,
        block_kv=block_kv,
    )


def flash_backward(
    q, k, v, o, lse, do, *, scale: float, row_offset: int = 0,
    col_offset: int = 0, causal: str = "offset", window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward against one KV span (kernels K10a-K10d):
    float32 ``(dq [sq, h, dh], dk, dv [skv, h_kv, dh])`` for the forward
    output ``o`` and its ``lse [h, sq, 1]`` (of the global softmax, so
    per-chunk calls compose). Query row ``i`` sits at ``row_offset + i``,
    key ``j`` at ``col_offset + j``. ``causal``: ``offset`` masks from the
    global offsets (the only mode a window composes with), ``diagonal``
    is a chunk at equal offsets, ``past`` a chunk wholly in the past (no
    mask), ``none`` bidirectional attention."""
    _check_operands(q, k, v)
    _check_backward_mode(causal, window)
    sq, h, dh = q.shape
    skv, h_kv = k.shape[0], k.shape[1]
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (h, sq, 1))):
        if tuple(t.shape) != tuple(shape) or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} on {q.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if q.device.type == "cpu":
        return flash_backward_plain(
            q, k, v, o, lse, do, scale=scale, row_offset=row_offset,
            col_offset=col_offset, causal=causal, window=window,
        )
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    _check_kernel_operands(q, k, v, do, lse)
    delta = attention_delta(o, do)
    dq = torch.empty((sq, h, dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((skv, h_kv, dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    kw = dict(scale=scale, row_offset=row_offset, col_offset=col_offset,
              causal=causal, window=window)
    backward_pass("dq", q, k, v, do, lse, delta, (dq,), **kw)
    backward_pass("dkv", q, k, v, do, lse, delta, (dk, dv), **kw)
    return dq, dk, dv


def backward_pass(name: str, q, k, v, do, lse, delta, out, *, scale: float,
                  row_offset: int, col_offset: int, causal: str, window: int) -> None:
    """Launch one pass of the flash backward into ``out``: ``dq`` (K10a or
    K10c) writes ``(dq,)``, ``dkv`` (K10b or K10d) ``(dk, dv)``, on the
    kernel ``backward_kernel`` names; counted in ``LAUNCHES`` under
    ``bwd_{name}_{case}`` and in ``BACKWARD_TILES`` by kernel.
    ``flash_backward`` runs both after checking the operands."""
    sq, h, dh = q.shape
    skv, h_kv = k.shape[0], k.shape[1]
    case, row_offset, col_offset = backward_case(sq, skv, row_offset,
                                                 col_offset, causal, window)
    kernel = backward_kernel(case, q.dtype)
    lib = _lib()
    head = (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in out))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "wgmma":
            entry = {"dq": lib.ddlb_flash_bwd_dq_tri, "dkv": lib.ddlb_flash_bwd_dkv_tri}[name]
            rc = entry(*head, sq, h, h_kv, dh, float(scale), stream)
        else:
            entry = getattr(lib, f"ddlb_flash_bwd_{name}" + ("_band" if kernel == "band" else ""))
            rc = entry(
                *head, sq, skv, h, h_kv, dh, float(scale), row_offset, col_offset,
                int(causal not in ("past", "none")), int(window), stream,
            )
    LAUNCHES[f"bwd_{name}_{case}"] += 1
    BACKWARD_TILES[kernel] += 1
    _raise_on(rc, f"flash backward {name} ({case}, {kernel})")


# -- the context-parallel ring ---------------------------------------------------


def _ring_flash_forward(q, k, v, shift, d, my, scale, window):
    """K9 folds of the chunks as they come round the ring (the diagonal one
    first, skipping chunks outside the live band); returns (o, lse)."""
    s_loc, h, dh = q.shape
    carry = init_flash_carry(s_loc, h, dh, q.device)
    k_cur, v_cur = k, v
    for t in range(d):
        src = (my - t) % d  # the chunk held after t hops came from src
        if ring_chunk_live(src, my, s_loc, window):
            later = "offset" if window else "past"
            carry = flash_attention_chunk(
                q, k_cur, v_cur, carry, scale=scale, row_offset=my * s_loc,
                col_offset=src * s_loc, causal="diagonal" if t == 0 else later,
                window=window,
            )
        if t + 1 < d:
            k_cur, v_cur = shift(k_cur, v_cur)
    _, m, l = carry
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l))
    return finalize_flash_carry(carry, q.dtype), lse


class _RingFlashAttention(torch.autograd.Function):
    """The ring's custom_vjp (:1229-1354): the forward folds K9 chunks; the
    backward runs the flash backward per live chunk while the float32 dK/dV
    accumulators ride the ring with their chunks, and one more hop brings
    each home."""

    @staticmethod
    def forward(ctx, q, k, v, shift, d, my, scale, window):
        o, lse = _ring_flash_forward(q, k, v, shift, d, my, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (shift, d, my, scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        shift, d, my, scale, window = ctx.args
        do = do.contiguous()
        s_loc = q.shape[0]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for t in range(d):
            src = (my - t) % d
            if ring_chunk_live(src, my, s_loc, window):
                # the windowed backward is offset-only; equal offsets make it
                # exact for the diagonal chunk too
                mode = "offset" if window else ("diagonal" if t == 0 else "past")
                dq_c, dk_c, dv_c = flash_backward(
                    q, k_cur, v_cur, o, lse, do, scale=scale,
                    row_offset=my * s_loc, col_offset=src * s_loc,
                    causal=mode, window=window,
                )
                dq += dq_c
                dk += dk_c
                dv += dv_c
            if t + 1 < d:
                k_cur, v_cur, dk, dv = shift(k_cur, v_cur, dk, dv)
        # after step d - 1 the accumulators held here belong to chunk my + 1
        dk, dv = shift(dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, *, shift, axis_size: int, axis_index: int,
                         scale: float, window: int = 0) -> torch.Tensor:
    """Context-parallel causal flash attention on this rank's sequence
    chunk ``q [s_loc, h, dh]``, ``k``/``v [s_loc, h_kv, dh]`` of a sequence
    split over a ring of ``axis_size`` ranks, this one at ``axis_index``
    (``ring_flash_attention``, :1170), differentiable. ``shift(*tensors)``
    sends each tensor to the next rank of the ring and returns the ones
    received from the previous rank (the identity on a ring of one)."""
    _check_operands(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return _RingFlashAttention.apply(q, k, v, shift, int(axis_size),
                                     int(axis_index), float(scale), int(window))


# -- the kernel's distance from its plain version ------------------------------


def score_gap(q: torch.Tensor, k: torch.Tensor, scale: float) -> float:
    """Bound on |Δs|, the gap between the kernel's and the plain version's
    scaled score of one (query, key) pair.

    Both sum ``dh`` products in float32 (exact for bf16/fp16 operands), in
    different orders, and the plain version scales ``q`` first while the
    kernel scales the sum: ``(dh + 2) * 2**-23 * scale * dh * max|q| *
    max|k|`` covers both summation orders and the two roundings of the
    scaling.
    """
    dh = q.shape[-1]
    qmax = float(q.abs().max()) if q.numel() else 0.0
    kmax = float(k.abs().max()) if k.numel() else 0.0
    return (dh + 2) * 2.0**-23 * scale * dh * qmax * kmax


#: unit roundoff of ``p`` where the kernel rounds it for the PV product
_P_ROUNDING = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11, torch.float32: 0.0}


def plain_gap_bound(
    q, k, v, got: torch.Tensor, want: torch.Tensor, *, scale: float,
    n_terms: int, score_gap_value: Optional[float] = None,
) -> torch.Tensor:
    """Elementwise bound on ``|o_kernel - o_plain|``.

    The plain version keeps ``p`` and the PV product in float32. The
    kernel (bf16/fp16) rounds ``p`` to the operand type for the tensor
    cores (unit roundoff ``u_p``; fp16 also flushes ``p < 2**-24`` at an
    absolute ``2**-24`` each) while ``l`` sums the unrounded ``p``, and
    scales after QKᵀ. With ``A = max|v|`` bounding every normalised
    ``sum p|v| / l``:

    - ``u_p * A``: the rounding of ``p``;
    - ``4 * Δs * A``: the score gap (``score_gap``) moves each ``p`` and
      ``l`` by a factor within ``exp(±2Δs)``;
    - ``2 * n * 2**-23 * A``: two float32 summation orders of at most
      ``n = n_terms`` products each, plus ``2**-20 * A`` for ``exp``;
    - one spacing of the output dtype at the larger of ``|got|`` and
      ``|want|``: each side rounds once.

    The bound scales with ``max|v|``, not with ``|o|``: on uniform inputs
    a late row of a long causal band averages thousands of keys, so its
    ``|o|`` can fall below the bound. Hold a kernel also on inputs whose
    softmax peaks on one key per row (``|o|`` near ``max|v|``), where a
    wrong score, scale or ``exp`` shows far above it.
    """
    finfo = torch.finfo(got.dtype)
    mag = torch.maximum(got.float().abs(), want.float().abs())
    spacing = torch.exp2(torch.floor(torch.log2(mag.clamp_min(finfo.tiny))))
    if score_gap_value is None:
        score_gap_value = score_gap(q, k, scale)
    vmax = float(v.abs().max()) if v.numel() else 0.0
    relative = (
        _P_ROUNDING[q.dtype]
        + 4.0 * score_gap_value
        + 2.0 * n_terms * 2.0**-23
        + 2.0**-20
    )
    absolute = n_terms * 2.0**-24 if q.dtype == torch.float16 else 0.0
    return spacing * finfo.eps + vmax * (relative + absolute)


def backward_gap_bound(
    q, k, v, o, lse, do, want, *, scale: float, row_offset: int = 0,
    col_offset: int = 0, causal: str = "offset", window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elementwise bounds on ``|dq|``, ``|dk|``, ``|dv|`` of the kernel
    minus the plain version (``want``, the plain version's output).

    Both compute P and dS in float32; they differ in:
    - the score gap ``Δs`` (``score_gap``): each p moves by a factor
      within ``exp(±Δs)``, so p and dS = p (dP - delta) by ``2 Δs``;
    - the order of the dh products of dP = dO V^T:
      ``E = (dh + 2) 2**-23 max_i ||dO_i||_1 max|v|`` on each dP, which
      moves dS by at most ``p E``;
    - the rounding of P (for dV) and dS (for dQ, dK) to the operand type
      before the tensor-core products: unit roundoff ``u`` (0 for
      float32; fp16 also flushes values below 2**-24, an absolute
      2**-24 each);
    - two float32 summation orders over at most ``n`` terms and the
      roundings of exp, of the final scaling and of dS itself: ``2 n
      2**-23 + 2**-20``, relative.

    Each relative term multiplies the sum of the magnitudes it applies to,
    which the plain tile loop gives (``sum |dS| |K|`` for dq, ``sum |dS|
    |Q|`` for dk, ``sum P |dO|`` for dv); the dP term multiplies ``sum p
    |K| <= max|k|`` for dq and ``max|q| sum_i p`` for dk.
    """
    mag_dq, mag_dk, mag_dv, colsum = _backward_tiles(
        q, k, v, o, lse, do, scale=scale, row_offset=row_offset,
        col_offset=col_offset, causal=causal, window=window,
        block_q=PLAIN_BLOCK, block_kv=PLAIN_BLOCK, magnitudes=True,
    )
    dh = q.shape[-1]
    n = max(q.shape[0] * gqa_group(q, k), k.shape[0])
    qmax, kmax, vmax = (float(x.abs().max()) if x.numel() else 0.0 for x in (q, k, v))
    do1 = float(do.float().abs().sum(-1).max()) if do.numel() else 0.0
    e_dp = (dh + 2) * 2.0**-23 * do1 * vmax
    rel = (_P_ROUNDING[q.dtype] + 2.0 * score_gap(q, k, scale)
           + 2.0 * n * 2.0**-23 + 2.0**-20)
    flush = n * 2.0**-24 if q.dtype == torch.float16 else 0.0
    out_ulp = 2.0**-22
    dq_want, dk_want, dv_want = want
    return (
        scale * (rel * mag_dq + e_dp * kmax + flush * kmax) + out_ulp * dq_want.abs(),
        scale * (rel * mag_dk + e_dp * qmax * colsum + flush * qmax)
        + out_ulp * dk_want.abs(),
        rel * mag_dv + flush * float(do.float().abs().max()) + out_ulp * dv_want.abs(),
    )
