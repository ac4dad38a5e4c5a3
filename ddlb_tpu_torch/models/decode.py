"""Autoregressive decode for the flagship model: KV cache, one-token steps,
verify chunks, prompt prefill, generation, speculative decoding and the
teacher-forced oracle.

The port of the JAX package's ``models/decode.py``. One process is one
rank of a ``(dp, tp, 1)`` mesh (``runtime.Mesh``) and runs the body that the
JAX package runs under ``shard_map``: its batch shard (over dp), its heads
and its one expert (over tp), with the ``psum`` over 'tp' as
``Mesh.axis_sum`` over 'tp' and the MoE ``all_gather`` as
``Mesh.tp_all_gather_rows``.

- ``init_cache`` / ``init_paged_cache``: this rank's cache, ``[L, B/dp,
  S_max, H_kv/tp, dh]`` (contiguous) or a pool ``[L, P, page_size,
  H_kv/tp, dh]`` plus a replicated page table ``[B, max_pages]`` whose
  sentinel id ``P`` marks an unmapped entry; int8 caches carry float32
  per-(position, head) scales.
- ``make_decode_fn``: one token per sequence against the cache, at one
  position (an int) or per-sequence positions (``ragged=True``, a ``[B]``
  int32 tensor); ``decode_kernel='pallas'`` takes the fused kernels K11
  (contiguous) and K12 (paged) of ``ops/decode_attention.py``.
- ``make_prefill_fn``: the prompt pass that fills the cache; attention on
  the flash kernels K8a/K8b (``attn_kernel='flash'``) or einsum.
- ``make_chunk_decode_fn``: ``t`` tokens per sequence at one start
  position in one cached step (the speculative-verify chunk): rows
  ``[start, start + t)`` written in one block, each row attending
  causally through the cache. It runs the same ``serving_body`` as the
  decode step, on einsum attention always: the fused kernels K11/K12
  take one query row, so only ``t = 1`` goes to them.
- ``make_generate_fn``: prefill, then decode steps; greedy, or sampled at
  ``temperature > 0`` (optionally restricted to the ``top_k`` highest
  logits and/or the ``top_p`` nucleus) from a ``torch.Generator`` the
  caller passes in.
- ``make_speculate_fn``: greedy speculative decoding, lossless: a draft
  model proposes ``spec_k`` tokens by decode steps, the target verifies
  them in one chunk, and the batch advances by the shortest agreeing
  prefix plus one. The rounds are a host loop: reading the accepted
  count back costs one device sync a round.
- ``reference_logits``: the single-device oracle, a teacher-forced full
  forward that shares no attention code with the cache path.
- ``make_full_width_fns``: the single-program decode and prefill (every
  head and expert, no collective), functional; the ``compiled`` member
  runs them on DTensors (``dtensor_cache``), and they double as oracle
  building blocks.

In place, not functional. The JAX functions return a new cache; these
write the given one in place and return it. A decode step writes the row
at its position and then reads rows up to it, so re-running it at the
same position with the same token rewrites the same values and reads the
same prefix: measured iterations stay identical. Drop and fill are
explicit: a ragged or paged write whose position is past the cache, or
whose page is the sentinel, leaves the cache as it was (the JAX
``mode='drop'``), and a read through a sentinel page sees zeros
(``mode='fill'``). A contiguous block write at one position (a prompt, a
chunk, a decode step at an int position) past the cache raises, where
the JAX package's ``dynamic_update_slice`` clamps the start and would
overwrite live rows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ddlb_tpu_torch.models.transformer import (
    NEG_INF,
    TransformerConfig,
    apply_rope,
    causal_attention,
    ffn_scales,
    flash_full,
    moe_ffn,
    rms_norm,
)
from ddlb_tpu_torch.ops import decode_attention as da
from ddlb_tpu_torch.ops.accum import float32_product
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy
from ddlb_tpu_torch.runtime import mesh_size, placements

Cache = Dict[str, torch.Tensor]

KV_QMAX = 127.0


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(position, head) int8 over the feature axis (:69):
    ``x [..., dh] ~ q * s``, ``q`` int8 and ``s [..., 1]`` float32."""
    xf = x.float()
    s = (xf.abs().amax(-1, keepdim=True) / KV_QMAX).clamp_min(1e-30)
    q = torch.clamp(torch.round(xf / s), -KV_QMAX, KV_QMAX).to(torch.int8)
    return q, s


def kv_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize then dequantize (:79): the value every int8 cache read
    sees, shared by prefill attention and the oracle."""
    q, s = quantize_kv(x)
    return (q.float() * s).to(x.dtype)


def _local(cfg: TransformerConfig, batch: int, mesh):
    """(this rank's batch, its kv heads) under ``cache_specs`` (:125):
    batch over dp, kv heads over tp."""
    if mesh is None:
        return batch, cfg.kv_heads
    if batch % mesh.dp or cfg.kv_heads % mesh.tp:
        raise ValueError(
            f"batch {batch} / kv heads {cfg.kv_heads} do not split over "
            f"dp={mesh.dp}, tp={mesh.tp}"
        )
    return batch // mesh.dp, cfg.kv_heads // mesh.tp


def _zeros(cfg, shape, device) -> Cache:
    if cfg.kv_cache == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), device=device),
        }
    if cfg.kv_cache == "bf16":
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
    raise ValueError(f"unknown kv_cache '{cfg.kv_cache}'")


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, mesh=None,
               device="cuda") -> Cache:
    """This rank's zeroed cache ``[L, B/dp, S_max, H_kv/tp, dh]`` (:87);
    ``batch`` is the global batch."""
    b, h_kv = _local(cfg, batch, mesh)
    shape = (cfg.layers_per_stage, b, max_len, h_kv, cfg.head_dim)
    return _zeros(cfg, shape, device)


def init_paged_cache(cfg: TransformerConfig, batch: int, max_len: int,
                     num_pages: int, mesh=None, device="cuda") -> Cache:
    """This rank's page pool ``[L, P, page_size, H_kv/tp, dh]`` and the
    table ``[batch, max_len // page_size]``, every entry the sentinel
    ``P`` (:141). The pool is shared across slots, so dp must be 1."""
    if max_len % cfg.page_size:
        raise ValueError(
            f"max_len={max_len} not divisible by page_size={cfg.page_size}"
        )
    if mesh is not None and mesh.dp != 1:
        raise ValueError("a paged cache shares one pool over the slots: dp must be 1")
    _, h_kv = _local(cfg, batch, mesh)
    shape = (cfg.layers_per_stage, num_pages, cfg.page_size, h_kv, cfg.head_dim)
    cache = _zeros(cfg, shape, device)
    cache["table"] = torch.full(
        (batch, max_len // cfg.page_size), num_pages, dtype=torch.int32,
        device=device,
    )
    return cache


def cache_from_numpy(cache) -> Cache:
    """A JAX cache dict pulled to the host (``{name: np.ndarray}``) as this
    package's cache on the CPU, bit for bit."""
    return {name: _tensor_from_numpy(arr) for name, arr in cache.items()}


def cache_max_len(cache: Cache) -> int:
    """S_max of either layout (:194)."""
    if "table" in cache:
        return cache["table"].shape[1] * cache["k"].shape[2]
    return cache["k"].shape[2]


def page_coords(cache: Cache, pos: torch.Tensor):
    """Absolute positions ``[b, t]`` (a row per sequence, or a chunk's
    rows) -> ``(pages, rows)`` of the same shape through the table
    (:201, :288-304); a position past the table, or an unmapped entry,
    maps to the sentinel page ``P``."""
    table = cache["table"]
    num_pages, ps = cache["k"].shape[1], cache["k"].shape[2]
    page_idx = pos // ps
    oob = (page_idx < 0) | (page_idx >= table.shape[1])
    safe = page_idx.clamp(0, table.shape[1] - 1)
    pages = table.gather(1, safe).long()
    pages = torch.where(oob, torch.full_like(pages, num_pages), pages)
    return pages, pos % ps


def project_qkv(h, params, l, b, t, h_loc, kv_loc, dh, dtype):
    """``[b, t, D]`` -> ``q [b, t, h_loc, dh]``, ``k, v [b, t, kv_loc,
    dh]`` (:220), from the fused MHA stack or the split GQA pair."""
    if "w_qkv" in params:
        w = params["w_qkv"][0, l]
        q, k, v = (torch.matmul(h, w[i]).to(dtype) for i in range(3))
    else:
        q = torch.matmul(h, params["w_q"][0, l]).to(dtype)
        k, v = (torch.matmul(h, params["w_kv"][0, l, i]).to(dtype) for i in range(2))
    return (
        q.reshape(b, t, h_loc, dh),
        k.reshape(b, t, kv_loc, dh),
        v.reshape(b, t, kv_loc, dh),
    )


def grouped_scores(q, ck_l, dh):
    """``q [b, t, h, dh]`` grouped as ``[b, t, h_kv, G, dh]`` against the
    kv-head cache -> ``[b, h_kv, G, t, S]`` float32 (:248)."""
    b, t, h, _ = q.shape
    h_kv = ck_l.shape[2]
    q5 = q.float().reshape(b, t, h_kv, h // h_kv, dh) / float(np.sqrt(dh))
    return torch.einsum("bqhgd,bkhd->bhgqk", q5, ck_l.float())


def grouped_attend(p, cv_l, b, t, dtype):
    """``p [b, h_kv, G, t, S]`` times the cache values -> ``[b, t, h*dh]``
    in query-head order ``hq = kvh * G + g`` (:258)."""
    attn = torch.einsum("bhgqk,bkhd->bqhgd", p, cv_l.float())
    return attn.reshape(b, t, -1).to(dtype)


def _scatter_drop(arr, index, dims, val, valid):
    """``arr[index] = val`` for the lanes where ``valid``; the others leave
    ``arr`` as it was (``mode='drop'``), without a host sync.

    ``index`` is a tuple of index tensors of one shape (``[b]``, or ``[b,
    t]`` for a chunk) into the leading ``len(index)`` dims of ``arr``
    (sizes ``dims``); ``val`` and ``valid`` lead with the same shape. The
    lanes are flattened into one. A dropped lane writes lane j's value to
    lane j's target, where j is the first kept lane, so no dropped lane
    can land on a kept lane's target with another value; with no kept
    lane, every lane writes back what its (clamped) target holds."""
    lanes = valid.numel()
    index = tuple(ix.reshape(lanes) for ix in index)
    val = val.reshape((lanes,) + tuple(val.shape[valid.dim():]))
    valid = valid.reshape(lanes)
    safe = tuple(ix.clamp(0, n - 1) for ix, n in zip(index, dims))
    j = torch.argmax(valid.int())
    keep = valid | ~valid.any()
    target = tuple(torch.where(keep, s, s[j]) for s in safe)
    wide = (slice(None),) + (None,) * (val.dim() - 1)
    cur = arr[target]
    src = torch.where(valid[wide], val, torch.where(keep[wide], cur, val[j]))
    arr[target] = src


def _is_vector(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def cache_write(cache: Cache, l: int, pos, k, v, int8: bool) -> Cache:
    """Store this step's ``k``/``v [b, t, h_kv, dh]`` at layer ``l``
    (quantizing first for an int8 cache), in place (:265).

    ``pos`` an int (or a 0-d tensor): rows ``[pos, pos + t)`` of every
    sequence (a prompt at 0, a verify chunk at its start, or one token).
    Contiguous, a block past the cache raises (the JAX package's
    ``dynamic_update_slice`` clamps the start instead, and would
    overwrite live rows); paged, each row goes through the slot's table,
    and a row past the table or on a sentinel page drops (:288-304).
    ``pos`` a ``[b]`` tensor with ``t == 1``: sequence i's row at
    ``pos[i]``, dropped past the cache, through the table when paged.
    """
    b, t = k.shape[0], k.shape[1]
    paged = "table" in cache
    if _is_vector(pos):
        if t != 1:
            raise ValueError("per-sequence positions take one-token writes")
        rowpos = pos.long()[:, None]                            # [b, 1]
    elif paged:
        rowpos = (int(pos) + torch.arange(t, device=k.device)).expand(b, t)
    else:
        pos = int(pos)
        if pos < 0 or pos + t > cache["k"].shape[2]:
            raise ValueError(
                f"rows [{pos}, {pos + t}) do not fit a cache of "
                f"{cache['k'].shape[2]} positions"
            )
        rowpos = None
    dims = cache["k"].shape[1:3]
    if rowpos is None:
        index = None
    elif paged:
        pages, rows = page_coords(cache, rowpos)
        index, valid = (pages, rows), pages < dims[0]
    else:
        lanes = torch.arange(b, device=rowpos.device)[:, None].expand_as(rowpos)
        index, valid = (lanes, rowpos), (rowpos >= 0) & (rowpos < dims[1])

    def upd(name, val):
        if index is None:
            cache[name][l, :, pos:pos + t] = val
        else:
            _scatter_drop(cache[name][l], index, dims, val, valid)

    if int8:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        upd("k", qk)
        upd("k_scale", sk)
        upd("v", qv)
        upd("v_scale", sv)
    else:
        upd("k", k)
        upd("v", v)
    return cache


def cache_read(cache: Cache, name: str, l: int, dtype) -> torch.Tensor:
    """Layer ``l`` as the linear ``[B, S_max, H_kv, dh]`` view (:337),
    dequantized through ``dtype`` for an int8 cache; a paged view gathers
    each slot's pages, zeros through the sentinel."""
    scale = cache.get(f"{name}_scale")
    if "table" in cache:
        table = cache["table"]
        b, mp = table.shape
        P, ps = cache[name].shape[1], cache[name].shape[2]
        mapped = ((table >= 0) & (table < P))[:, :, None, None, None]
        safe = table.long().clamp(0, P - 1)

        def lin(arr):
            pages = arr[l][safe]                    # [B, mp, ps, ...]
            pages = torch.where(mapped, pages, torch.zeros_like(pages))
            return pages.reshape((b, mp * ps) + tuple(arr.shape[3:]))

        view = lin(cache[name])
        if scale is None:
            return view
        return (view.float() * lin(scale)).to(dtype)
    arr = cache[name][l]
    if scale is None:
        return arr
    return (arr.float() * scale[l]).to(dtype)


def _live_mask(S_max, pos, window, device, t=1):
    """The live key positions of the query rows, shaped for the grouped
    scores ``[b, h_kv, G, t, S]``: at ``t == 1`` up to ``pos`` (an int, a
    0-d tensor, or ``[b]`` per sequence); at ``t > 1`` row j of the chunk
    at ``pos + j`` (a start shared by the batch) up to itself (:390-396).
    ``window > 0`` also drops keys behind the sliding window."""
    iota = torch.arange(S_max, device=device)
    if _is_vector(pos):
        if t != 1:
            raise ValueError("chunk attention takes a scalar start position")
        live = iota[None, :] <= pos[:, None]            # [b, S]
        if window:
            live &= iota[None, :] > pos[:, None] - window
        return live[:, None, None, None, :]
    # pos an int, or a 0-d tensor (a compiled step's position, kept a
    # tensor so a new position is not a new program)
    rowpos = (pos + torch.arange(t, device=device))[:, None]  # [t, 1]
    live = iota[None, :] <= rowpos                      # [t, S]
    if window:
        live &= iota[None, :] > rowpos - window
    return live[None, None, None]


def cache_attend(q, cache: Cache, l: int, dh: int, pos, dtype,
                 window: int = 0) -> torch.Tensor:
    """Query rows ``q [b, t, h, dh]`` against cache layer ``l`` (:376):
    grouped scores, the live mask (``_live_mask``: ``pos`` an int or
    ``[b]`` at t = 1, a scalar start at t > 1), softmax, value read ->
    ``[b, t, h*dh]``."""
    b, t = q.shape[0], q.shape[1]
    s = grouped_scores(q, cache_read(cache, "k", l, dtype), dh)
    live = _live_mask(cache_max_len(cache), pos, window, s.device, t)
    p = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    return grouped_attend(p, cache_read(cache, "v", l, dtype), b, t, dtype)


def cache_attend_pallas(q, cache: Cache, l: int, pos, dtype,
                        cfg: TransformerConfig) -> torch.Tensor:
    """``q [b, 1, h, dh]`` against cache layer ``l`` through the fused
    kernels (:461): K12 for a paged cache, K11 otherwise."""
    b = q.shape[0]
    scales = {
        "k_scale": cache["k_scale"][l] if "k_scale" in cache else None,
        "v_scale": cache["v_scale"][l] if "v_scale" in cache else None,
    }
    q1 = q[:, 0].contiguous()
    if "table" in cache:
        out = da.paged_decode_attention(
            q1, cache["k"][l], cache["v"][l], cache["table"], pos,
            window=cfg.attn_window, **scales,
        )
    else:
        out = da.decode_attention(
            q1, cache["k"][l], cache["v"][l], pos, window=cfg.attn_window,
            **scales,
        )
    return out.reshape(b, 1, -1).to(dtype)


def routed_moe(h2d, params, cfg: TransformerConfig, l, B, dp, tp):
    """Balanced per-sequence routing on a full-width ``[B * per_seq, D]``
    slab (:413): block e of each dp shard's sequences through expert e.
    The oracle's formulation (all experts in ``params``)."""
    rows = h2d.shape[0]
    per_seq = rows // B
    b_dp = B // dp
    g = b_dp // tp
    # the blocks tile the rows in order: concatenated, not written in place,
    # so the compiled member can trace it
    return torch.cat([
        moe_ffn(
            h2d[(i0 + e * g) * per_seq:(i0 + (e + 1) * g) * per_seq],
            params["moe_w1"][0, l, e], params["moe_w2"][0, l, e],
            cfg.mlp_kernel, h2d.dtype, scales=ffn_scales(params, l, e, cfg),
        )
        for i0 in range(0, B, b_dp) for e in range(tp)
    ])


def block_moe(h2d, params, l, cfg: TransformerConfig, mesh):
    """This tp rank's block of whole sequences through its expert, then
    the tp all-gather of the rows (:439)."""
    rows = h2d.shape[0]
    g = rows // mesh.tp
    blk = h2d[mesh.tp_rank * g:(mesh.tp_rank + 1) * g]
    z = moe_ffn(
        blk, params["moe_w1"][0, l, 0], params["moe_w2"][0, l, 0],
        cfg.mlp_kernel, h2d.dtype, scales=ffn_scales(params, l, 0, cfg),
    )
    return mesh.tp_all_gather_rows(z)


def _out_proj(attn, params, l, x, mesh):
    """``x + psum_tp(attn @ w_o)``: the product rounded to the model dtype,
    summed over tp in float32, cast back."""
    part = torch.matmul(attn, params["w_o"][0, l])
    return x + mesh.axis_sum(part.float(), "tp").to(x.dtype)


def _logits(h, params):
    """The LM head as a float32 product (``preferred_element_type``): on
    the card's tensor cores from bf16 operands (``ops.accum``)."""
    return float32_product(h, params["head"])


def serving_body(params, cache, tokens, pos, cfg: TransformerConfig, mesh,
                 h_loc, kv_loc, dh):
    """The cached serving forward for ``tokens [b, t]`` (:505): ``(logits
    [b, t, vocab] float32, cache)``, one row per consumed token. One body
    for both cadences: the decode step (``t = 1``, ``pos`` an int or
    ``[b]``) and the verify chunk (``t > 1``, row j at ``pos + j``).
    ``decode_kernel='pallas'`` sends ``t = 1`` to K11/K12; a chunk stays
    on einsum attention, as in the JAX package (:544-549)."""
    b, t = tokens.shape
    if b % mesh.tp != 0:
        raise ValueError(f"per-dp batch {b} not divisible by tp={mesh.tp}")
    int8_cache = cfg.kv_cache == "int8"
    x = params["embed"][tokens.long()]
    if cfg.rope:
        posb = (
            pos[:, None] if _is_vector(pos)
            else (int(pos) + torch.arange(t, device=x.device))[None]
        )
    for l in range(cfg.layers_per_stage):
        h = rms_norm(x, params["ln1"][0, l])
        q, k, v = project_qkv(h, params, l, b, t, h_loc, kv_loc, dh, x.dtype)
        if cfg.rope:
            q = apply_rope(q, posb, cfg.rope_theta)
            k = apply_rope(k, posb, cfg.rope_theta)
        cache_write(cache, l, pos, k, v, int8_cache)
        if t == 1 and cfg.decode_kernel == "pallas":
            attn = cache_attend_pallas(q, cache, l, pos, x.dtype, cfg)
        else:
            attn = cache_attend(q, cache, l, dh, pos, x.dtype, window=cfg.attn_window)
        x = _out_proj(attn, params, l, x, mesh)
        h2 = rms_norm(x, params["ln2"][0, l])
        D = x.shape[-1]
        u = block_moe(h2.reshape(b * t, D), params, l, cfg, mesh)
        x = x + u.reshape(b, t, D)
    h = rms_norm(x, params["ln_f"])
    return _logits(h, params), cache


def _check_serving(cfg: TransformerConfig, mesh) -> None:
    if cfg.router != "block":
        raise ValueError(
            "serving paths use the per-sequence-stable block router; "
            f"router='{cfg.router}' is a training-side construction"
        )
    if cfg.n_heads % mesh.tp != 0:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={mesh.tp}")
    if cfg.kv_heads % mesh.tp != 0:
        raise ValueError(f"n_kv_heads={cfg.kv_heads} not divisible by tp={mesh.tp}")


def make_decode_fn(mesh, cfg: TransformerConfig, ragged: bool = False):
    """One-token decode step on this rank (:568): ``decode_step(params,
    cache, tokens [B/dp], pos) -> (logits [B/dp, vocab] float32, cache)``,
    ``pos`` an int, or with ``ragged=True`` a ``[B/dp]`` int32 tensor of
    per-sequence positions."""
    _check_serving(cfg, mesh)
    if cfg.cache_layout == "paged" and mesh.dp != 1:
        raise ValueError(
            "cache_layout='paged' shares one page pool across the slot "
            "axis and requires dp=1 (run one engine per dp shard)"
        )
    h_loc, kv_loc, dh = cfg.n_heads // mesh.tp, cfg.kv_heads // mesh.tp, cfg.head_dim

    def decode_step(params, cache, tokens, pos):
        if ragged != (isinstance(pos, torch.Tensor) and pos.dim() == 1):
            raise ValueError(
                "ragged=True takes a [B] position tensor; ragged=False one position"
            )
        logits, cache = serving_body(
            params, cache, tokens[:, None], pos, cfg, mesh, h_loc, kv_loc, dh
        )
        return logits[:, 0], cache

    return decode_step


def make_chunk_decode_fn(mesh, cfg: TransformerConfig):
    """The multi-token cached step on this rank (:647), the speculative
    verify: ``chunk(params, cache, tokens [B/dp, t], start) -> (logits
    [B/dp, t, vocab] float32, cache)``, tokens consumed at positions
    ``[start, start + t)``, each row attending causally through the cache
    up to itself. ``start`` is one position for the batch (an int); cache
    rows ``[start, start + t)`` are written in one block, so the
    attention reads the cache as a decode step does (int8 numerics
    alike). A contiguous chunk past the cache raises (``cache_write``)."""
    if cfg.attention != "gathered":
        raise ValueError("chunk decode supports attention='gathered' only")
    _check_serving(cfg, mesh)
    h_loc, kv_loc, dh = cfg.n_heads // mesh.tp, cfg.kv_heads // mesh.tp, cfg.head_dim

    def chunk(params, cache, tokens, start):
        if isinstance(start, torch.Tensor) and start.dim() != 0:
            raise ValueError(
                "chunk decode takes a scalar start position (the batch-"
                "uniform speculative form; ragged is the t=1 decode path)"
            )
        return serving_body(params, cache, tokens, start, cfg, mesh, h_loc, kv_loc, dh)

    return chunk


def make_prefill_fn(mesh, cfg: TransformerConfig, dynamic_last: bool = False):
    """The prompt pass on this rank (:724): ``prefill(params, cache, tokens
    [B/dp, S]) -> (logits [B/dp, vocab] float32, cache)`` at position S-1,
    filling cache rows ``[0, S)``. ``dynamic_last=True`` takes a fourth
    argument ``last`` and reads that position's logits instead (a
    bucketed prompt padded past its length)."""
    _check_serving(cfg, mesh)
    if cfg.attn_kernel not in ("flash", "einsum"):
        raise ValueError(f"unknown attn_kernel '{cfg.attn_kernel}'")
    L = cfg.layers_per_stage
    h_loc, kv_loc, dh = cfg.n_heads // mesh.tp, cfg.kv_heads // mesh.tp, cfg.head_dim
    int8_cache = cfg.kv_cache == "int8"

    def body(params, cache, tokens, last):
        b, S = tokens.shape
        if b % mesh.tp != 0:
            raise ValueError(f"per-dp batch {b} not divisible by tp={mesh.tp}")
        x = params["embed"][tokens.long()]
        for l in range(L):
            h = rms_norm(x, params["ln1"][0, l])
            q, k, v = project_qkv(h, params, l, b, S, h_loc, kv_loc, dh, x.dtype)
            if cfg.rope:
                pos = torch.arange(S, device=x.device)[None]
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
            cache_write(cache, l, 0, k, v, int8_cache)
            if int8_cache:
                # prompt attention reads the values later decode steps read
                k, v = kv_roundtrip(k), kv_roundtrip(v)
            if cfg.attn_kernel == "flash":
                attn = flash_full(q, k, v, window=cfg.attn_window)
            else:
                attn = causal_attention(q, k, v, window=cfg.attn_window)
            x = _out_proj(attn.reshape(b, S, h_loc * dh), params, l, x, mesh)
            h2 = rms_norm(x, params["ln2"][0, l])
            D = x.shape[-1]
            u = block_moe(h2.reshape(b * S, D), params, l, cfg, mesh)
            x = x + u.reshape(b, S, D)
            del q, k, v, attn, h, h2, u
        # K/V row j and hidden row i depend only on tokens <= themselves,
        # so a bucket's pad tail never reaches rows [0, last]
        h_last = rms_norm(x[:, -1 if last is None else int(last)], params["ln_f"])
        return _logits(h_last, params), cache

    if dynamic_last:
        def prefill(params, cache, tokens, last):
            return body(params, cache, tokens, last)
    else:
        def prefill(params, cache, tokens):
            return body(params, cache, tokens, None)
    return prefill


def restrict_logits(logits: torch.Tensor, top_k: int = 0,
                    top_p: float = 1.0) -> torch.Tensor:
    """``logits [..., V]`` with every token outside the ``top_k`` highest
    and outside the ``top_p`` nucleus set to ``-inf`` (the JAX package's
    ``_restrict``, :982). The nucleus is the smallest set of the highest
    tokens whose probability reaches ``top_p``: a token is kept iff the
    mass of the tokens before it (sorted descending) is below ``top_p``,
    so the first token past the threshold stays and the set is never
    empty. Ties at a threshold are all kept."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        kept = before < top_p
        thr = torch.where(kept, srt, float("inf")).amin(-1, keepdim=True)
        logits = torch.where(logits < thr, float("-inf"), logits)
    return logits


def make_generate_fn(mesh, cfg: TransformerConfig, n_new: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0):
    """Generation (:949): ``generate(params, cache, prompt [B/dp, S0],
    generator=None) -> tokens [B/dp, S0 + n_new]`` int32 -- prefill,
    ``n_new - 1`` decode steps, the last token from the carried logits.
    The cache must hold ``S0 + n_new`` positions.

    ``temperature=0`` takes the argmax (greedy). ``temperature > 0`` draws
    each token from ``softmax(restrict_logits(logits / temperature))``
    with ``generator``, a ``torch.Generator`` on the logits' device that
    the caller passes in (it plays the part of the JAX package's PRNG
    key: each step draws from it in turn, so a generator seeded alike
    repeats the draws). The draws are not JAX's, bit for bit."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0 or top_k > cfg.vocab:
        raise ValueError(f"top_k must be in [0, vocab], got {top_k}")
    decode = make_decode_fn(mesh, cfg)
    prefill = make_prefill_fn(mesh, cfg)

    def sample(logits, generator):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(restrict_logits(logits.float() / temperature, top_k, top_p), -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    def generate(params, cache, prompt, generator=None):
        if temperature > 0.0 and generator is None:
            raise ValueError(
                "temperature > 0 sampling needs a torch.Generator (the PRNG key)"
            )
        B, S0 = prompt.shape
        S_max = cache_max_len(cache)
        if S0 + n_new > S_max:
            raise ValueError(
                f"cache holds {S_max} positions < prompt {S0} + n_new {n_new}"
            )
        logits, cache = prefill(params, cache, prompt)
        tokens = torch.zeros((B, S0 + n_new), dtype=torch.int32, device=prompt.device)
        tokens[:, :S0] = prompt
        for i in range(n_new - 1):
            nxt = sample(logits, generator)
            tokens[:, S0 + i] = nxt
            logits, cache = decode(params, cache, nxt, S0 + i)
        tokens[:, S0 + n_new - 1] = sample(logits, generator)
        return tokens

    return generate


def make_speculate_fn(mesh, cfg: TransformerConfig, cfg_draft: TransformerConfig,
                      n_new: int, spec_k: int = 4, with_stats: bool = False):
    """Greedy speculative decoding (:1059), lossless: the output is the
    target's own greedy chain for any draft.

    ``generate(params, params_draft, cache, cache_draft, prompt [B/dp, S0])
    -> tokens [B/dp, S0 + n_new]``, or with ``with_stats`` ``(tokens,
    {"rounds", "accepted", "proposals"})``. Each round the draft proposes
    ``spec_k`` tokens by decode steps and also consumes its last proposal
    (so after a fully accepted round its cache holds that row), the target
    verifies ``[last, p_1 .. p_k]`` in one chunk, and the batch advances
    by ``a + 1``: ``a`` the count of leading proposals every sequence's
    target argmax agrees with (the minimum over the global batch: one
    start position serves it), plus the target's own token at the first
    disagreement (or the bonus token). Both caches must hold ``S0 + n_new
    + spec_k`` positions (the chunk writes up to ``spec_k`` provisional
    rows past the accepted prefix; they are masked by position until
    overwritten); the token buffer is one wider still, for a full block
    written at the last position in range.

    The stats count work inside ``n_new`` only: a final round that
    overshoots counts ``min(a + 1, remaining)`` emitted tokens and
    ``min(spec_k, remaining - 1)`` proposals, so ``rounds + accepted ==
    n_new - 1`` always and a draft identical to the target measures an
    acceptance of exactly 1.0.

    The rounds are a host loop: reading ``a`` back is one device sync a
    round. Under ``kv_cache='int8'`` the verify chunk's batched projection
    can round a K/V value into a neighbouring int8 bucket from the one a
    decode step's gives, so the chain is exact up to near-ties of the
    target's logits; the bf16 cache is exact."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if cfg_draft.vocab != cfg.vocab:
        raise ValueError(f"draft vocab {cfg_draft.vocab} != target vocab {cfg.vocab}")
    decode_d = make_decode_fn(mesh, cfg_draft)
    chunk_t = make_chunk_decode_fn(mesh, cfg)
    prefill_t = make_prefill_fn(mesh, cfg)
    prefill_d = make_prefill_fn(mesh, cfg_draft)
    k = spec_k

    def generate(params, params_draft, cache, cache_draft, prompt):
        B, S0 = prompt.shape
        need = S0 + n_new + k
        for name, c in (("target", cache), ("draft", cache_draft)):
            S_max = cache_max_len(c)
            if S_max < need:
                raise ValueError(
                    f"{name} cache holds {S_max} positions < prompt {S0} "
                    f"+ n_new {n_new} + spec_k {k}"
                )
        logits, cache = prefill_t(params, cache, prompt)
        _, cache_draft = prefill_d(params_draft, cache_draft, prompt)
        tokens = torch.zeros((B, S0 + n_new + k + 1), dtype=torch.int32,
                             device=prompt.device)
        tokens[:, :S0] = prompt
        tokens[:, S0] = torch.argmax(logits, dim=-1)
        ntok, rounds, accepted, proposals = S0 + 1, 0, 0, 0
        while ntok < S0 + n_new:
            # tokens[:, :ntok] are final; the last is in neither cache yet
            last = tokens[:, ntok - 1]
            props = torch.empty((B, k), dtype=torch.int32, device=prompt.device)
            tok = last
            for j in range(k):
                lg, cache_draft = decode_d(params_draft, cache_draft, tok, ntok - 1 + j)
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                props[:, j] = tok
            _, cache_draft = decode_d(params_draft, cache_draft, tok, ntok - 1 + k)
            lg, cache = chunk_t(params, cache, torch.cat([last[:, None], props], 1),
                                ntok - 1)
            g = torch.argmax(lg, dim=-1).to(torch.int32)     # [B, k + 1]
            # cols < a repeat the accepted proposals, col a is the target's
            # own token, cols > a are provisional: the next round's block
            # starts at ntok + a + 1 and overwrites them
            tokens[:, ntok:ntok + k + 1] = g
            lead = torch.cumprod((props == g[:, :k]).int(), dim=1).sum(1).min()
            a = int(mesh.axis_min(lead.reshape(1), "dp")[0])
            remaining = S0 + n_new - ntok
            rounds += 1
            accepted += min(a + 1, remaining) - 1
            proposals += min(k, remaining - 1)
            ntok += a + 1
        out = tokens[:, :S0 + n_new]
        if with_stats:
            return out, {"rounds": rounds, "accepted": accepted, "proposals": proposals}
        return out

    return generate


def dtensor_cache(cfg: TransformerConfig, batch: int, max_len: int, mesh,
                  device) -> Cache:
    """``init_cache``'s zeroed contiguous cache as DTensors on ``mesh`` (a
    ``Runtime.device_mesh`` over 'dp' and 'tp'), ``cache_specs`` (:125):
    the batch (dim 1) over dp and the kv heads (dim 3) over tp, int8
    scales alike; each rank's zeros wrapped by ``from_local``."""
    dp, tp = mesh_size(mesh, "dp"), mesh_size(mesh, "tp")
    if batch % dp or cfg.kv_heads % tp:
        raise ValueError(
            f"batch {batch} / kv heads {cfg.kv_heads} do not split over "
            f"dp={dp}, tp={tp}"
        )
    shape = (cfg.layers_per_stage, batch // dp, max_len, cfg.kv_heads // tp,
             cfg.head_dim)
    where = placements(mesh, {"dp": 1, "tp": 3})
    return {name: DTensor.from_local(x, mesh, where, run_check=False)
            for name, x in _zeros(cfg, shape, device).items()}


def _put_rows(layer: torch.Tensor, pos, val: torch.Tensor) -> torch.Tensor:
    """``layer [B, S_max, ...]`` with rows ``[pos, pos + t)`` replaced by
    ``val [B, t, ...]``, as a new tensor (the JAX package's
    ``dynamic_update_slice``): ``pos`` an int, or a 0-d tensor with t = 1
    (a decode step's position, selected by a mask, so that it stays a
    tensor)."""
    val = val.to(layer.dtype)
    if isinstance(pos, torch.Tensor):
        rows = torch.arange(layer.shape[1], device=layer.device)
        rows = rows.reshape((1, -1) + (1,) * (layer.dim() - 2))
        return torch.where(rows == pos, val, layer)
    t = val.shape[1]
    return torch.cat([layer[:, :pos], val, layer[:, pos + t:]], dim=1)


def make_full_width_fns(cfg: TransformerConfig, batch: int, dp: int, tp: int):
    """The single-program decode and prefill (:862): full-head attention,
    ``routed_moe``'s expert blocks, the cache threaded through, no
    collective. Functional: the cache given is not written; its layers
    are rebuilt where a step writes them.

    ``decode_fwd(params, cache, tokens [B], pos) -> logits [B, vocab]``
    (float32) writes row ``pos`` (an int or a 0-d tensor) and attends rows
    up to it; ``prefill_fwd(params, cache, tokens [B, S]) -> (logits,
    cache)`` fills rows ``[0, S)`` and returns the logits at S - 1 and the
    new cache. Run on DTensors (the ``compiled`` member) DTensor inserts
    the collectives; on plain tensors they are oracle building blocks."""
    B = batch
    L, H, dh = cfg.layers_per_stage, cfg.n_heads, cfg.head_dim
    H_kv = cfg.kv_heads
    int8_cache = cfg.kv_cache == "int8"

    def write(layers, l, pos, k, v):
        """Layer l of each cache entry with this step's k/v at ``pos``."""
        if int8_cache:
            (k, k_scale), (v, v_scale) = quantize_kv(k), quantize_kv(v)
            new = {"k": k, "v": v, "k_scale": k_scale, "v_scale": v_scale}
        else:
            new = {"k": k, "v": v}
        for name, val in new.items():
            layers[name][l] = _put_rows(layers[name][l], pos, val)

    def decode_fwd(params, cache, tokens, pos):
        layers = {name: list(arr.unbind(0)) for name, arr in cache.items()}
        x = params["embed"][tokens.long()][:, None, :]  # [B, 1, D]
        if cfg.rope:
            posb = torch.zeros((B, 1), dtype=torch.long, device=x.device) + pos
        for l in range(L):
            h = rms_norm(x, params["ln1"][0, l])
            q, k, v = project_qkv(h, params, l, B, 1, H, H_kv, dh, x.dtype)
            if cfg.rope:
                q = apply_rope(q, posb, cfg.rope_theta)
                k = apply_rope(k, posb, cfg.rope_theta)
            write(layers, l, pos, k, v)
            view = {name: layers[name][l][None] for name in layers}
            attn = cache_attend(q, view, 0, dh, pos, x.dtype, window=cfg.attn_window)
            x = x + torch.matmul(attn, params["w_o"][0, l]).to(x.dtype)
            h2 = rms_norm(x, params["ln2"][0, l])
            u = routed_moe(h2.reshape(B, -1), params, cfg, l, B, dp, tp)
            x = x + u[:, None, :]
        return _logits(rms_norm(x, params["ln_f"])[:, 0], params)

    def prefill_fwd(params, cache, tokens):
        layers = {name: list(arr.unbind(0)) for name, arr in cache.items()}
        B_, S = tokens.shape
        x = params["embed"][tokens.long()]
        for l in range(L):
            h = rms_norm(x, params["ln1"][0, l])
            q, k, v = project_qkv(h, params, l, B_, S, H, H_kv, dh, x.dtype)
            if cfg.rope:
                pos = torch.arange(S, device=x.device)[None]
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
            write(layers, l, 0, k, v)
            if int8_cache:
                k, v = kv_roundtrip(k), kv_roundtrip(v)
            attn = causal_attention(q, k, v, window=cfg.attn_window)
            x = x + torch.matmul(attn.reshape(B_, S, H * dh), params["w_o"][0, l]).to(x.dtype)
            h2 = rms_norm(x, params["ln2"][0, l])
            u = routed_moe(h2.reshape(B_ * S, -1), params, cfg, l, B, dp, tp)
            x = x + u.reshape(B_, S, -1)
        logits = _logits(rms_norm(x[:, -1], params["ln_f"]), params)
        return logits, {name: torch.stack(ls) for name, ls in layers.items()}

    return decode_fwd, prefill_fwd


#: the oracle's score blocks stay near this many bytes (query chunking)
ORACLE_CHUNK_BYTES = 1 << 30


def oracle_attention(q, k, v, window: int = 0) -> torch.Tensor:
    """Exact causal attention without the ``[B, H, S, S]`` scores (:1262):
    query rows in chunks of ``[B, H, chunk, S]`` float32 near 1 GiB, each
    softmaxed over the full key range, in float32 from the model-dtype
    operands (the JAX oracle's bf16 products summed in f32)."""
    B, S, H, dh = q.shape
    if k.shape[2] != H:
        G = H // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    kh = k.float().permute(0, 2, 1, 3).contiguous()       # [B, H, S, dh]
    vh = v.float().permute(0, 2, 1, 3).contiguous()
    chunk = S
    while B * H * chunk * S * 4 > ORACLE_CHUNK_BYTES and chunk > 1:
        chunk = (chunk + 1) // 2
    scale = 1.0 / float(np.sqrt(dh))
    cols = torch.arange(S, device=q.device)[None, :]
    out = torch.empty_like(q)
    for q0 in range(0, S, chunk):
        qc = q[:, q0:q0 + chunk].float().permute(0, 2, 1, 3)
        s = torch.matmul(qc, kh.transpose(-1, -2)) * scale
        rows = q0 + torch.arange(qc.shape[2], device=q.device)[:, None]
        mask = rows >= cols
        if window:
            mask &= cols > rows - window
        s.masked_fill_(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        out[:, q0:q0 + chunk] = torch.matmul(p, vh).permute(0, 2, 1, 3).to(q.dtype)
    return out


def reference_logits(params, tokens, cfg: TransformerConfig, tp: int,
                     dp: int) -> torch.Tensor:
    """Single-device oracle (:1294): the teacher-forced full forward over
    ``tokens [B, S]`` with the full parameters (every head and expert),
    logits at the last position ``[B, vocab]`` float32. Sequence i of a
    dp shard uses expert ``i // (B / (dp * tp))``, as the cache path."""
    B, S = tokens.shape
    D = cfg.d_model
    x = params["embed"][tokens.long()]
    for l in range(cfg.layers_per_stage):
        h = rms_norm(x, params["ln1"][0, l])
        q, k, v = project_qkv(
            h, params, l, B, S, cfg.n_heads, cfg.kv_heads, cfg.head_dim, x.dtype
        )
        if cfg.rope:
            pos = torch.arange(S, device=x.device)[None]
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if cfg.kv_cache == "int8":
            k, v = kv_roundtrip(k), kv_roundtrip(v)
        attn = oracle_attention(q, k, v, window=cfg.attn_window).reshape(B, S, D)
        x = x + torch.matmul(attn, params["w_o"][0, l]).to(x.dtype)
        h2 = rms_norm(x, params["ln2"][0, l])
        u = routed_moe(h2.reshape(B * S, D), params, cfg, l, B, dp, tp)
        x = x + u.reshape(B, S, D)
        del q, k, v, attn, h, h2, u
    return _logits(rms_norm(x[:, -1], params["ln_f"]), params)

